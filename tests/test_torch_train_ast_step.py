"""The AST training steps of the port (``train/ast_step.py``) against the
JAX package on the CPU, fp32, from the same weights: the loss, every
gradient and every parameter after one Adam step.

The JAX side is rebuilt here from the public calls that the token step's
closure in ``scripts/train_ast.py`` makes (``:735-773``; the closures live
inside ``main`` and cannot be called): ``model.module.apply(...,
targets=inp)``, ``token_cross_entropy`` / ``model.loss`` and ``optax.adam``
(the pretraining step's rebuild is in ``test_torch_train_ast_encoder.py``).
The loss and its gradients run under ``jax.jit``, as the script runs them:
in fp32 a jitted forward rounds as an op-by-op one does (it is the bf16
forward whose fused roundings differ, which is why nothing here is held in
bf16).

Dropout is 0 on both sides. The transcriber's encoder has a fixed dropout
of 0.1 in JAX and in the port, whose masks come from other generators: the
port's encoder blocks are set to 0, and JAX's trained pass runs with
``train=False``, which at decoder dropout 0 differs from ``train=True``
only there.

Tolerances (``tests/ast_parity.py``: LOSS_RTOL, GRAD_TOL and the Adam update
bound), each shown below to reject a named faulty variant.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music_transcription_tpu.ops import losses as jlosses
from music_transcription_tpu_torch.checkpoints import state_dict_from_jax
from music_transcription_tpu_torch.config import ModelConfig
from music_transcription_tpu_torch.models.remi_tokenizer import REMITokenizer
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from music_transcription_tpu_torch.models.transformer import encoder_subtree
from music_transcription_tpu_torch.ops import losses
from music_transcription_tpu_torch.train import ast_step
from music_transcription_tpu_torch.train.optim import make_optimizer
from tests.ast_parity import (
    GRAD_TOL,
    LOSS_RTOL,
    LR,
    SMALL,
    grad_err,
    pair,
    targets,
    update_ratio,
    waves,
)


CASES = {
    "plain": dict(),
    "pitch_loss_weight 3": dict(pitch_weight=3.0),
    # JAX's p = 0 step is its plain step (the mask is all False): the port's
    # two-pass step is held against that
    "scheduled sampling p=0": dict(ss_p=0.0, jax_as="plain"),
    "scheduled sampling p=1": dict(ss_p=1.0),
    "freeze_encoder": dict(overrides=dict(freeze_encoder=True)),
    "mock_encoder": dict(overrides=dict(use_mock_encoder=True)),
}
_JAX = {}


def _inputs():
    return waves(2, 1.0, seed=3), targets(2, 24, seed=4).astype(np.int64)


def _class_weights(pitch_weight):
    if pitch_weight is None:
        return None
    return ast_step.pitch_class_weights(REMITokenizer(), 512, pitch_weight)


def _mock_features(wave, dim):
    # the JAX mock encoder's features (ASTTranscriber._encode)
    b, n = wave.shape
    return np.array(jax.random.normal(jax.random.key(0), (b, max(1, n // 160), dim)))


def jax_token_step(jm, params, wave, tokens, *, ss_p=None, class_w=None):
    """scripts/train_ast.py:735-773 (trained pass at train=False: see the
    module docstring). Returns (loss, grads, params after the step)."""
    tx = optax.adam(LR)
    opt_state = tx.init(params)

    def loss_fn(p):
        inp = tokens[:, :-1]
        if ss_p is not None:
            tf_logits = jm.module.apply({"params": p}, wave, targets=inp, train=False)
            pred_in = jnp.concatenate(
                [inp[:, :1], jnp.argmax(tf_logits[:, :-1], -1).astype(inp.dtype)], 1)
            pred_in = jax.lax.stop_gradient(pred_in)
            mask = jax.random.bernoulli(jax.random.key(1), ss_p, inp.shape)
            inp = jnp.where(mask.at[:, 0].set(False), pred_in, inp)
        logits = jm.module.apply({"params": p}, wave, targets=inp, train=False)
        if class_w is not None:
            return jlosses.token_cross_entropy(logits, tokens[:, 1:], class_weights=class_w)
        return jm.loss(logits, tokens[:, 1:])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    updates, _ = tx.update(grads, opt_state)
    return float(loss), grads, optax.apply_updates(params, updates)


def _port_model(pm, wave):
    m = copy.deepcopy(pm)
    for blk in m.model.enc_blocks:
        blk.dropout = 0.0
    if m.config.use_mock_encoder:
        feats = torch.from_numpy(_mock_features(wave, m.config.decoder_dim))
        m.model._encode = lambda waveforms, generator=None: feats
    return m


def _case(name):
    """(port model before the step, JAX's loss, grads and params as port
    state_dicts) for CASES[name], the JAX side computed once."""
    spec = CASES[name]
    jm, variables, pm = pair("float32", dropout=0.0, **spec.get("overrides", {}))
    wave, tok = _inputs()
    if spec.get("jax_as"):
        name = spec["jax_as"]
        spec = CASES[name]
    if name not in _JAX:
        cw = _class_weights(spec.get("pitch_weight"))
        loss, grads, params = jax_token_step(
            jm, variables["params"], jnp.asarray(wave), jnp.asarray(tok), ss_p=spec.get("ss_p"),
            class_w=None if cw is None else jnp.asarray(cw))
        as_sd = lambda tree: state_dict_from_jax(  # noqa: E731
            {"params": jax.tree.map(np.asarray, tree)}, pm.config)
        _JAX[name] = (loss, as_sd(grads), as_sd(params))
    return _port_model(pm, wave), wave, tok, _JAX[name]


def _port_step(m, wave, tok, name, optimizer=None):
    spec = CASES[name]
    cw = _class_weights(spec.get("pitch_weight"))
    optimizer = optimizer or ast_step.make_adam(m.parameters(), LR)
    return float(ast_step.token_step(
        m, optimizer, torch.from_numpy(wave), torch.from_numpy(tok), ss_p=spec.get("ss_p"),
        class_weights=None if cw is None else torch.from_numpy(cw)))


def _grads(m) -> dict:
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            for k, p in m.model.named_parameters()}


@pytest.mark.parametrize("name", list(CASES))
def test_token_step_matches_jax(name):
    m, wave, tok, (j_loss, j_grads, j_params) = _case(name)
    before = {k: v.detach().clone() for k, v in m.model.named_parameters()}
    loss = _port_step(m, wave, tok, name)
    assert abs(loss - j_loss) <= LOSS_RTOL * abs(j_loss)
    assert grad_err(_grads(m), j_grads) <= GRAD_TOL
    assert update_ratio(m.model, before, j_grads, j_params) <= 1.0
    enc = [k for k in before if encoder_subtree(k) is not None]
    if name == "mock_encoder":
        assert enc == []
    if name == "freeze_encoder":
        # stop_gradient in JAX: optax moves the encoder by exactly 0; the port's
        # encoder .grad stays None and torch's Adam skips it
        assert enc and all(m.model.get_parameter(k).grad is None for k in enc)
        for k in enc:
            assert torch.equal(m.model.get_parameter(k).detach(), before[k])
            assert torch.equal(j_params[k], before[k])


def test_scheduled_sampling_at_p1_replaces_every_column_but_the_first():
    """p = 1: the inputs are <sos> and the first pass's argmax, shifted by
    one; p = 0: the teacher's tokens."""
    m, wave, tok, _ = _case("plain")
    w, inp = torch.from_numpy(wave), torch.from_numpy(tok)[:, :-1]
    with torch.no_grad():
        m.eval()
        argmax = m(w, targets=inp).argmax(-1)
    got1 = ast_step.scheduled_sampling_inputs(m, w, inp, 1.0, None)
    assert torch.equal(got1[:, 0], inp[:, 0]) and torch.equal(got1[:, 1:], argmax[:, :-1])
    assert torch.equal(ast_step.scheduled_sampling_inputs(m, w, inp, 0.0, None), inp)
    half = ast_step.scheduled_sampling_inputs(
        m, w, inp, 0.5, ast_step.step_generators(1, 0, "cpu")[1])
    assert torch.equal(half[:, 0], inp[:, 0])
    assert bool(((half == inp) | (half == torch.cat([inp[:, :1], argmax[:, :-1]], 1))).all())


def test_token_step_with_dropout_draws_its_masks_from_the_step_generator():
    """At the CLI's dropout 0.2 the same step's generators give the same
    update, the next step's another; the loss is finite and falls over a
    few steps in bf16 (bf16 is held loosely: the JAX CLI's jitted bf16
    forward rounds otherwise than op-by-op JAX and the port)."""
    torch.manual_seed(0)
    pm = TranscriptionModel(ModelConfig(**dict(SMALL, compute_dtype="bfloat16", dropout=0.2,
                                               encoder_layers=1, decoder_layers=1)))
    wave, tok = _inputs()
    w, t = torch.from_numpy(wave), torch.from_numpy(tok)

    def run(steps):
        m = copy.deepcopy(pm)
        opt = ast_step.make_adam(m.parameters(), 1e-3)
        out = []
        for s in steps:
            gen, ss_gen = ast_step.step_generators(1, s, "cpu")
            out.append(float(ast_step.token_step(m, opt, w, t, generator=gen, ss_p=0.5,
                                                 ss_generator=ss_gen)))
        return out

    first = run(range(3))
    assert run(range(2)) == first[:2] and all(np.isfinite(first))
    assert first[-1] < first[0]
    assert run([1])[0] != first[0]


def test_loss_tolerance_rejects_unshifted_targets_and_weights_over_the_count():
    """The reference's unshifted objective (logits at t scored against the
    token fed at t: scripts/train_ast.py:737-742) and class weights divided
    by the count of positions, not by their sum, both fail LOSS_RTOL."""
    m, wave, tok, (j_loss, _, _) = _case("plain")
    w, t = torch.from_numpy(wave), torch.from_numpy(tok)
    with torch.no_grad():
        m.eval()
        unshifted = float(losses.token_cross_entropy(m(w, targets=t[:, :-1]), t[:, :-1]))
    assert abs(unshifted - j_loss) > LOSS_RTOL * abs(j_loss)

    m, _, _, (jw_loss, _, _) = _case("pitch_loss_weight 3")
    cw = torch.from_numpy(_class_weights(3.0))
    with torch.no_grad():
        logits = m(w, targets=t[:, :-1])
    v = logits.shape[-1]
    nll = -torch.log_softmax(logits.reshape(-1, v), -1).gather(1, t[:, 1:].reshape(-1, 1))[:, 0]
    keep = (t[:, 1:].reshape(-1) != losses.PAD_TOKEN).float()
    by_count = float((nll * keep * cw[t[:, 1:].reshape(-1)]).sum() / keep.sum())
    assert abs(by_count - jw_loss) > LOSS_RTOL * abs(jw_loss)


def test_grad_tolerance_rejects_a_decoder_without_its_causal_mask():
    m, wave, tok, (_, j_grads, _) = _case("plain")
    w, t = torch.from_numpy(wave), torch.from_numpy(tok)
    ast = m.model
    m.train()
    inp = t[:, :-1]
    memory = ast.memory(w)
    x = ast.token_emb(inp) + ast.pos_emb.weight[:inp.shape[1]][None]
    everything = torch.ones((inp.shape[1], inp.shape[1]), dtype=torch.bool)
    for layer in ast.layers:
        x = layer(x, memory, everything)
    losses.token_cross_entropy(ast.output_fc(x), t[:, 1:]).backward()
    assert grad_err(_grads(m), j_grads) > GRAD_TOL


def test_update_bound_rejects_adamw_and_weight_decay_on_a_frozen_encoder():
    """torch's AdamW (decoupled decay 0.01 by default) fails the update
    bound. A frozen encoder given zeroed gradients in place of None stays
    as it is under Adam, as under optax, but the CNN trainer's
    make_optimizer (L2 decay 1e-5 added to the gradient) moves it."""
    m, wave, tok, (_, j_grads, j_params) = _case("plain")
    before = {k: v.detach().clone() for k, v in m.model.named_parameters()}
    _port_step(m, wave, tok, "plain", optimizer=torch.optim.AdamW(m.parameters(), lr=LR))
    assert update_ratio(m.model, before, j_grads, j_params) > 1.0

    from music_transcription_tpu_torch.config import TrainConfig

    moved = {}
    for name, make in (("adam", lambda ps: ast_step.make_adam(ps, LR)),
                       ("make_optimizer", lambda ps: make_optimizer(
                           ps, TrainConfig(learning_rate=LR)))):
        m, wave, tok, _ = _case("freeze_encoder")
        enc = {k: v.detach().clone() for k, v in m.model.named_parameters()
               if encoder_subtree(k) is not None}
        opt = make(m.parameters())
        w, t = torch.from_numpy(wave), torch.from_numpy(tok)
        m.train()
        losses.token_cross_entropy(m(w, targets=t[:, :-1]), t[:, 1:]).backward()
        for k in enc:
            m.model.get_parameter(k).grad = torch.zeros_like(enc[k])
        opt.step()
        moved[name] = any(not torch.equal(m.model.get_parameter(k).detach(), v)
                          for k, v in enc.items())
    assert moved == {"adam": False, "make_optimizer": True}


# -------------------------------------- chip_smoke.py's card-against-CPU bounds

def _faulty_loss(m, w, t, cw, variant):
    ast = m.model
    inp = t[:, :-1]
    if variant == "targets unshifted":  # the reference's objective (train_ast.py:737-742)
        return losses.token_cross_entropy(m(w, targets=inp), inp, class_weights=cw)
    if variant == "causal mask dropped":
        memory = ast.memory(w)
        x = ast.token_emb(inp) + ast.pos_emb.weight[:inp.shape[1]][None]
        everything = torch.ones((inp.shape[1], inp.shape[1]), dtype=torch.bool)
        for layer in ast.layers:
            x = layer(x, memory, everything)
        return losses.token_cross_entropy(ast.output_fc(x), t[:, 1:], class_weights=cw)
    # class weights divided by the count of positions, not by their sum
    logits = m(w, targets=inp)
    tgt = t[:, 1:].reshape(-1)
    nll = -torch.log_softmax(logits.reshape(-1, logits.shape[-1]), -1).gather(
        1, tgt[:, None])[:, 0]
    keep = (tgt != losses.PAD_TOKEN).float()
    return (nll * keep * cw[tgt]).sum() / keep.sum()


@pytest.mark.parametrize("variant", ["targets unshifted", "causal mask dropped",
                                     "class weights over the count"])
def test_chip_smoke_step_bounds_reject_a_faulty_step(variant):
    """chip_smoke.py phase 8c holds one token step on the card against the
    CPU with AST_STEP_TOL (the loss, and the gradients by class): every one
    of those bounds rejects each faulty step, here against the right step on
    the CPU (pitch weight 3)."""
    import chip_smoke

    m, wave, tok, _ = _case("pitch_loss_weight 3")
    w, t = torch.from_numpy(wave), torch.from_numpy(tok)
    cw = torch.from_numpy(_class_weights(3.0))
    classes = chip_smoke.ast_grad_classes(torch, m.model)
    assert set(classes.values()) == set(chip_smoke.AST_STEP_TOL) - {"loss"}
    bad = copy.deepcopy(m)
    ref_loss = _port_step(m, wave, tok, "pitch_loss_weight 3")
    bad.train()
    loss = _faulty_loss(bad, w, t, cw, variant)
    loss.backward()
    errs = chip_smoke.ast_step_errors(classes, ref_loss, float(loss.detach()),
                                      chip_smoke.step_grads(torch, m.model),
                                      chip_smoke.step_grads(torch, bad.model))
    assert set(errs) == set(chip_smoke.AST_STEP_TOL)
    assert all(errs[k][0] > tol for k, tol in chip_smoke.AST_STEP_TOL.items()), errs
