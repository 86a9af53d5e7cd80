"""PyTorch port of the AST tier against the JAX package on the CPU: the
weight map at full width, the encoder pretrainer's frame logits, the
encoder memory, teacher-forced logits and their loss, the mock encoder,
and predict's rolls. Generation is held in test_torch_ast_decode.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_transcription_tpu.config import ModelConfig as JModelConfig
from music_transcription_tpu.models.transcription import TranscriptionModel as JModel
from music_transcription_tpu.models.transformer import ASTEncoderPretrainer as JPretrainer
from music_transcription_tpu.ops import losses as jlosses
from music_transcription_tpu_torch.checkpoints import state_dict_from_jax
from music_transcription_tpu_torch.config import ModelConfig
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from music_transcription_tpu_torch.models.transformer import ASTEncoderPretrainer
from music_transcription_tpu_torch.ops import losses
from tests.ast_parity import REL_TOL, SMALL, jax_out, pair, port, targets, waves


def _rel_err(got, ref) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_state_dict_from_jax_maps_every_parameter_at_full_width():
    """ModelConfig(model_type="ast") at its default widths: the flax tree
    (shapes from jax.eval_shape) maps onto the port's state_dict key for key
    and shape, 19,269,632 parameters, none missing or extra."""
    cfg = ModelConfig(model_type="ast")
    jm = JModel(JModelConfig(model_type="ast"))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 16000))))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    mapped = state_dict_from_jax(zeros, cfg)
    model = TranscriptionModel(cfg)
    own = model.model.state_dict()
    assert sorted(mapped) == sorted(own)
    assert all(mapped[k].shape == own[k].shape for k in own)
    assert sum(v.numel() for v in mapped.values()) == 19_269_632
    assert sum(p.numel() for p in model.parameters()) == 19_269_632


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_pretrainer_frame_logits_match_jax(dtype):
    kw = dict(encoder_layers=2, encoder_dim=32, encoder_heads=4, patch_frames=4, n_mels=32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jmod = JPretrainer(compute_dtype=jdt, **kw)
    wave = waves(2, 1.0, seed=5)
    variables = jax.tree.map(np.asarray, jax.jit(jmod.init)(jax.random.key(3), jnp.asarray(wave)))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(wave)))
    pmod = ASTEncoderPretrainer(compute_dtype=getattr(torch, dtype), **kw).eval()
    pmod.load_state_dict(state_dict_from_jax(variables, ModelConfig(model_type="ast")),
                         strict=True)
    with torch.inference_mode():
        got = pmod(torch.from_numpy(wave)).numpy()
    assert got.shape == ref.shape == (2, 88, 32)  # 32 frames -> 8 patches of 4
    assert _rel_err(got, ref) <= REL_TOL[dtype]
    # the transplant unit: the pretrainer's encoder keys are the transcriber's
    enc = {k for k in pmod.state_dict() if not k.startswith("frame_head")}
    assert enc <= set(TranscriptionModel(ModelConfig(**SMALL)).model.state_dict())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_memory_matches_jax(dtype):
    jm, variables, pm = pair(dtype)
    wave = waves(2, 1.3, seed=2)  # 41 frames -> 10 patches (a trimmed tail)
    ref = np.asarray(jm.module.apply(variables, jnp.asarray(wave), False, method="_memory"))
    with torch.inference_mode():
        got = pm.model.memory(torch.from_numpy(wave))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 10, 32)
    assert _rel_err(got.float().numpy(), ref.astype(np.float32)) <= REL_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_teacher_forced_logits_and_loss_match_jax(dtype):
    jm, variables, pm = pair(dtype)
    wave, tg = waves(2, 1.0, seed=3), targets(2, 24, seed=4)
    tg[1, 20:] = 2  # <pad> tail: ignored by the loss
    ref = jax_out(jm, variables, wave, targets=tg)
    got = port(pm, wave, targets=tg)
    assert got.shape == ref.shape == (2, 24, 512) and got.dtype == np.float32
    assert _rel_err(got, ref) <= REL_TOL[dtype]
    # the port's loss on the port's logits against JAX's loss on JAX's
    loss = float(pm.loss(torch.from_numpy(got), torch.from_numpy(tg)))
    jloss = float(jm.loss(jnp.asarray(ref), jnp.asarray(tg)))
    assert loss == pytest.approx(jloss, rel=10 * REL_TOL[dtype])
    # and both losses on the same logits, with class weights
    w = np.random.default_rng(6).random(512).astype(np.float32)
    same = float(losses.token_cross_entropy(torch.from_numpy(ref), torch.from_numpy(tg),
                                            class_weights=torch.from_numpy(w)))
    jsame = float(jlosses.token_cross_entropy(jnp.asarray(ref), jnp.asarray(tg),
                                              class_weights=jnp.asarray(w)))
    assert same == pytest.approx(jsame, rel=1e-6)


def test_freeze_encoder_stops_the_gradient_at_the_encoder():
    _, variables, _ = pair()
    for freeze in (True, False):
        cfg = ModelConfig(compute_dtype="float32", freeze_encoder=freeze,
                          **SMALL)
        pm = TranscriptionModel(cfg).eval()
        pm.model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
        logits = pm(torch.from_numpy(waves(1)), targets=torch.from_numpy(targets(1)).long())
        logits.sum().backward()
        enc_grad = pm.model.patch_embed.weight.grad
        assert pm.model.enc_to_dec.weight.grad.abs().sum() > 0
        assert (enc_grad is None) == freeze


def test_mock_encoder_has_jax_shapes():
    """The mock encoder draws (B, L // 160, decoder_dim) features from a
    generator seeded 0 (JAX: jax.random.key(0); other values, same law)."""
    jm, variables, pm = pair(use_mock_encoder=True)
    wave = waves(2, 0.2)
    ref = np.asarray(jm.module.apply(variables, jnp.asarray(wave), False, method="_encode"))
    with torch.inference_mode():
        got = pm.model._encode(torch.from_numpy(wave))
        again = pm.model._encode(torch.from_numpy(wave))
        logits = pm(torch.from_numpy(wave), targets=torch.from_numpy(targets()).long())
    assert got.shape == ref.shape == (2, 20, 32) and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert abs(float(got.std()) - 1.0) < 0.1
    assert logits.shape == (2, 24, 512)


@pytest.mark.parametrize("constrained", [False, True])
def test_predict_rolls_match_jax(constrained):
    jm, variables, pm = pair()
    wave = waves(2, 1.0, seed=7)
    ref = np.asarray(jm.predict(variables, jnp.asarray(wave), generate_max_len=48,
                                constrained=constrained, max_T=40))
    with torch.inference_mode():
        got = pm.predict(torch.from_numpy(wave), generate_max_len=48, constrained=constrained,
                         max_T=40)
    assert got.shape == ref.shape and got.shape[:2] == (2, 88)
    np.testing.assert_array_equal(got.numpy(), ref)
