"""The AST training data path of the port against the JAX package on the
CPU: ``collate_tokens`` and ``collate_wave_roll`` (padding and truncation),
``CachedMaestroDataset(prefer_roll=True)`` on a tokenized cache written by
the port's preprocessing CLI, ``stage_to_device(limit=...)`` and
``DeviceStagedLoader(limit, compact_fields)`` against the streaming loader,
and the order in which ``python -m music_transcription_tpu_torch.train_ast``
feeds its batches, staged and streamed, in both loops, against the JAX
package's loaders as ``scripts/train_ast.py`` drives them."""

import contextlib
import io
from functools import partial

import numpy as np
import pytest
import torch

from music_transcription_tpu.data import cache as jcache
from music_transcription_tpu.data import pipeline as jpipe
from music_transcription_tpu.data.maestro import MaestroDataset as JMaestroDataset
from music_transcription_tpu_torch import preprocess as preprocess_cli
from music_transcription_tpu_torch import train_ast
from music_transcription_tpu_torch.config import AudioConfig
from music_transcription_tpu_torch.data import cache as pcache
from music_transcription_tpu_torch.data import pipeline as ppipe
from music_transcription_tpu_torch.train import ast_step
from tests.maestro_fixture import make_maestro_root

PCM16_STEP = 1.0 / 32768


def _items(seed=0, n=3, lengths=(16000, 12000, 20000), t_roll=(31, 20, 40), n_tok=24):
    rng = np.random.default_rng(seed)
    waves = [rng.standard_normal(lengths[i]).astype(np.float32) for i in range(n)]
    tokens = [rng.integers(0, 512, n_tok) for _ in range(n)]
    rolls = [(rng.random((88, t_roll[i])) < 0.2).astype(np.float32) for i in range(n)]
    return waves, tokens, rolls


@pytest.mark.parametrize("pad_to", [None, 14000, 24000])
def test_collate_tokens_matches_jax(pad_to):
    waves, tokens, _ = _items()
    items = list(zip(waves, tokens))
    got, ref = ppipe.collate_tokens(items, pad_to=pad_to), jpipe.collate_tokens(items,
                                                                                 pad_to=pad_to)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int64


@pytest.mark.parametrize("pad_to,roll_pad_to", [(None, None), (16000, 31), (8000, 25)])
def test_collate_wave_roll_matches_jax(pad_to, roll_pad_to):
    waves, _, rolls = _items(seed=1)
    items = list(zip(waves, rolls))
    got = ppipe.collate_wave_roll(items, pad_to=pad_to, roll_pad_to=roll_pad_to)
    ref = jpipe.collate_wave_roll(items, pad_to=pad_to, roll_pad_to=roll_pad_to)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    assert [a.dtype for a in got] == [np.float32, np.float32, np.int32]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The MAESTRO fixture tree and its train split as a tokenized cache
    written by the port's preprocessing CLI (2 s chunks)."""
    tmp = tmp_path_factory.mktemp("train_ast_data")
    root = make_maestro_root(tmp / "maestro")
    cache = str(tmp / "tokens")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = preprocess_cli.main(["--root_dir", str(root), "--cache_dir", cache, "--splits",
                                  "train", "--chunk_length", "2.0", "-d", "cpu",
                                  "--num_workers", "1", "--waveform", "--tokenize",
                                  "--token_len", "32"])
    assert rc == 0, out.getvalue()
    return dict(root=str(root), cache=cache, tmp=tmp)


def test_prefer_roll_reads_the_rolls_of_a_tokenized_cache(data):
    ours = pcache.CachedMaestroDataset(data["cache"], "train", prefer_roll=True, verbose=False)
    theirs = jcache.CachedMaestroDataset(data["cache"], "train", prefer_roll=True, verbose=False)
    tokens = pcache.CachedMaestroDataset(data["cache"], "train", verbose=False)
    assert len(ours) == len(theirs) == len(tokens) >= 4
    for i in range(len(ours)):
        (w, r), (jw, jr) = ours[i], theirs[i]
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(r, jr)
        assert r.shape[0] == 88 and r.dtype == np.float32
        assert tokens[i][1].ndim == 1 and np.array_equal(tokens[i][0], w)
    # a chunk without a roll: the JAX package's KeyError
    pcache.save_chunk(data["tmp"] / "noroll" / "train", 0,
                      {"waveform": np.zeros(32000, np.float32), "tokens": np.zeros(8, np.int64)})
    pcache.save_metadata(data["tmp"] / "noroll", "train",
                         {"num_chunks": 1, "chunk_length": 2.0, "tokenize": True,
                          "return_waveform": True})
    with pytest.raises(KeyError, match="stores no 'roll'"):
        pcache.CachedMaestroDataset(data["tmp"] / "noroll", "train", prefer_roll=True,
                                    verbose=False)[0]


def test_stage_to_device_limit_and_compact_match_jax(data):
    ds = pcache.CachedMaestroDataset(data["cache"], "train", prefer_roll=True, verbose=False)
    collate = partial(ppipe.collate_wave_roll, roll_pad_to=62)
    got, n = ppipe.stage_to_device(ds, collate, device="cpu", pad_to=32000, limit=3,
                                   compact_fields=(0,))
    ref, jn = jpipe.stage_to_device(ds, partial(jpipe.collate_wave_roll, roll_pad_to=62),
                                    pad_to=32000, limit=3, compact_fields=(0,))
    assert n == jn == 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[0].dtype == torch.int16


def test_staged_compact_loader_gives_the_streaming_batches(data):
    """DeviceStagedLoader(limit, compact_fields=(0,)) on the CPU: the
    streaming Loader's batches over the first ``limit`` items, in its order,
    the wave within one PCM16 step, the tokens equal."""
    ds = pcache.CachedMaestroDataset(data["cache"], "train", verbose=False)
    kw = dict(shuffle=True, seed=3, drop_last=True, collate=ppipe.collate_tokens, pad_to=32000)
    limit = 4
    staged = ppipe.DeviceStagedLoader(ds, 2, device="cpu", limit=limit, compact_fields=(0,),
                                      **kw)
    first = torch.utils.data.Subset(ds, range(limit))
    streamed = ppipe.Loader(first, 2, num_workers=0, **kw)
    assert staged.n == limit and len(staged) == len(streamed) == 2
    for _ in range(2):  # two epochs: the same reshuffle
        for (w, t), (sw, st) in zip(staged, streamed):
            assert w.dtype == torch.float32 and t.dtype == torch.int64
            assert float((w - torch.from_numpy(sw)).abs().max()) <= PCM16_STEP
            assert torch.equal(t, torch.from_numpy(st))


# --------------------------------------------- the CLI's batches, JAX's order

GEO = ["--encoder_layers", "1", "--encoder_dim", "32", "--encoder_heads", "2",
       "--encoder_n_mels", "32", "--decoder_layers", "1", "--decoder_dim", "32",
       "--decoder_heads", "2", "--chunk_length", "2.0", "--batch_size", "2",
       "--max_token_len", "32", "-d", "cpu", "--no-sanity_checks", "--epochs", "2"]


def _recorded_waves(monkeypatch, root, run_dir, pretrain: bool, extra):
    """The waves that the port's CLI hands its step, in order (the step
    itself replaced by a recorder)."""
    seen = []

    def record(model, optimizer, wave, *rest, **kw):
        seen.append(wave.detach().clone().numpy())
        return torch.zeros(())

    monkeypatch.setattr(ast_step, "pretrain_step" if pretrain else "token_step", record)
    argv = ["--root_dir", root, "--run_dir", str(run_dir), *GEO, *extra]
    if pretrain:
        argv.append("--pretrain_frames")
    else:
        argv.append("--mock_encoder")
    with contextlib.redirect_stdout(io.StringIO()):
        assert train_ast.main(argv) == 0
    return seen


class _WaveOnly:
    """A dataset's items as (wave, a dummy second field): the order is what
    is compared."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i][0], np.zeros(4, np.int64)


@pytest.mark.parametrize("pretrain", [True, False], ids=["pretrain", "token"])
@pytest.mark.parametrize("staged", [True, False], ids=["staged-compact", "streamed"])
def test_cli_feeds_jax_batches_in_jax_order(data, tmp_path, monkeypatch, pretrain, staged):
    """scripts/train_ast.py: pretraining streams through Loader (epochs from
    0) or walks epoch_index_batches(seed, epoch) over the staged split with
    epochs from 1 (:389-394); the token loop iterates Loader or
    DeviceStagedLoader (epochs from 0)."""
    extra = ["--device_data", "on", "--compact_data"] if staged else ["--device_data", "off"]
    got = _recorded_waves(monkeypatch, data["root"], tmp_path / "run", pretrain, extra)

    acfg = AudioConfig(chunk_length=2.0)
    ds = _WaveOnly(JMaestroDataset(data["root"], split="train", chunk_length=2.0,
                                   return_waveform=True, audio_cfg=acfg))
    collate = jpipe.collate_tokens
    if staged and pretrain:
        wave_all = jpipe.stage_to_device(ds, collate, pad_to=acfg.chunk_samples,
                                         compact_fields=(0,))[0][0]
        ref = [np.asarray(jpipe.dequantize_i16(wave_all[idx]))
               for epoch in (1, 2)
               for idx in jpipe.epoch_index_batches(len(ds), 2, seed=0, epoch=epoch)]
    else:
        kw = dict(shuffle=True, seed=0, num_workers=4, drop_last=True, collate=collate,
                  pad_to=acfg.chunk_samples)
        loader = (jpipe.DeviceStagedLoader(ds, 2, compact_fields=(0,), **kw) if staged
                  else jpipe.Loader(ds, 2, **kw))
        ref = [np.asarray(w) for _ in range(2) for w, _ in loader]
    assert len(got) == len(ref) == 2 * (len(ds) // 2)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=PCM16_STEP if staged else 0)
