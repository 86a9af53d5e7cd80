"""PyTorch port of the AST tier's generation against the JAX package on the
CPU: greedy tokens (plain, with a repetition penalty, with the REMI and the
event tokenizer's grammar masks) in fp32 and bf16, beam search with and
without a mask, and the properties of seeded sampling."""

import numpy as np
import pytest
import torch

from music_transcription_tpu.models.event_tokenizer import EventMIDITokenizer as JEventTokenizer
from music_transcription_tpu.models.remi_tokenizer import REMITokenizer as JREMITokenizer
from music_transcription_tpu_torch.models.event_tokenizer import EventMIDITokenizer
from music_transcription_tpu_torch.models.remi_tokenizer import REMITokenizer
from tests.ast_parity import REL_TOL, agree_up_to_near_tie, jax_out, pair, port, step_logits, waves

LEN = 64  # max_output_len of the small model


def _mask(name):
    """The port's transition table, which must equal JAX's."""
    if name is None:
        return None
    port_tok, jax_tok = {"remi": (REMITokenizer, JREMITokenizer),
                         "event": (EventMIDITokenizer, JEventTokenizer)}[name]
    mask = port_tok().transition_mask()
    np.testing.assert_array_equal(mask, jax_tok().transition_mask())
    return mask


@pytest.mark.parametrize("dtype,penalty,grammar", [
    ("float32", 0.0, None), ("float32", 1.0, None), ("float32", 0.0, "remi"),
    ("float32", 0.0, "event"), ("bfloat16", 0.0, None), ("bfloat16", 1.0, None),
    ("bfloat16", 0.0, "remi"),
])
def test_greedy_tokens_match_jax(dtype, penalty, grammar):
    """fp32: identical tokens. bf16: identical up to a step where the CPU
    logits' top-2 margin is below the logit tolerance (REL_TOL x the largest
    logit), which either side may break its own way."""
    jm, variables, pm = pair(dtype)
    wave = waves(2, 1.0, seed=11)
    allowed = _mask(grammar)
    kw = dict(generate_max_len=LEN, repetition_penalty=penalty)
    if allowed is not None:
        kw["allowed_next"] = allowed
    ref = jax_out(jm, variables, wave, targets=None, **kw).astype(np.int64)
    got = port(pm, wave, **{k: torch.from_numpy(v) if k == "allowed_next" else v
                            for k, v in kw.items()}).astype(np.int64)
    assert got.shape == ref.shape == (2, LEN)
    assert (got[:, 1:] != 0).all()  # <sos> masked after step 0
    if allowed is not None:
        prev = np.concatenate([np.zeros((2, 1), np.int64), got[:, :-1]], axis=1)
        assert allowed[prev, got].all()
    if dtype == "float32":
        np.testing.assert_array_equal(got, ref)
    else:
        tol = REL_TOL[dtype] * np.abs(step_logits(pm, wave, ref, 0, 0)).max()
        agreed = agree_up_to_near_tie(pm, wave, got, ref, tol, repetition_penalty=penalty,
                                      allowed_next=allowed)
        assert agreed >= LEN  # at least one row's worth of steps agree


@pytest.mark.parametrize("grammar", [None, "remi"])
def test_beam_tokens_match_jax(grammar):
    """beam_size 4 in fp32: identical tokens. Exact ties (the -1e9 scores of
    the beams that start dead, finished beams' <pad> rows) go to the lower
    index in both."""
    jm, variables, pm = pair("float32")
    wave = waves(2, 1.0, seed=12)
    allowed = _mask(grammar)
    kw = dict(generate_max_len=LEN, beam_size=4, length_penalty=0.6)
    if allowed is not None:
        kw["allowed_next"] = allowed
    ref = jax_out(jm, variables, wave, targets=None, **kw).astype(np.int64)
    got = port(pm, wave, **{k: torch.from_numpy(v) if k == "allowed_next" else v
                            for k, v in kw.items()}).astype(np.int64)
    assert got.shape == (2, LEN)
    np.testing.assert_array_equal(got, ref)
    greedy = port(pm, wave, generate_max_len=LEN, beam_size=1)
    np.testing.assert_array_equal(greedy, port(pm, wave, generate_max_len=LEN))


def test_beam_ties_go_to_the_lower_index():
    """A tied candidate list: the stable descending sort keeps index order,
    as jax.lax.top_k does."""
    from music_transcription_tpu_torch.models.transformer import _stable_top_k

    x = torch.tensor([[0.0, 1.0, 1.0, -1e9, 1.0, -1e9, -1e9]])
    values, idx = _stable_top_k(x, 5)
    assert idx.tolist() == [[1, 2, 4, 0, 3]]
    assert values.tolist() == [[1.0, 1.0, 1.0, 0.0, -1e9]]


def test_seeded_sampling():
    """Sampling draws from an explicit torch.Generator: the default (seeded
    0) repeats, other seeds differ; top_k=1 equals greedy; every sampled id
    lies in the top k of the logits it was drawn from."""
    _, _, pm = pair("float32")
    wave = waves(2, 1.0, seed=13)
    kw = dict(generate_max_len=32, do_sample=True, temperature=2.0)
    a, b = port(pm, wave, **kw), port(pm, wave, **kw)
    np.testing.assert_array_equal(a, b)
    gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
    c, d = (port(pm, wave, generator=g, **kw) for g in gens)
    assert not np.array_equal(c, d)
    greedy = port(pm, wave, generate_max_len=32)
    np.testing.assert_array_equal(port(pm, wave, top_k=1, **kw), greedy)
    k = 5
    sampled = port(pm, wave, top_k=k, **kw).astype(np.int64)
    for row in range(2):
        for step in range(0, 32, 8):
            top = np.argsort(step_logits(pm, wave, sampled, row, step))[-k:]
            assert sampled[row, step] in top
