"""The encoder side of ``python -m music_transcription_tpu_torch.train_ast``
on the CPU against the JAX package. Pretraining: one step of
``ASTEncoderPretrainer`` (fp32, dropout 0) and its validation counts
against a JAX rebuild of ``scripts/train_ast.py:273-313`` under the
tolerances of ``tests/ast_parity.py``. The transplant: a JAX pretrainer
carried through ``state_dict_from_jax`` (its ``frame_head`` too) and the
port's ``transplant_encoder`` into the port's ``ASTTranscriber`` gives the
memory of JAX's ``encoder_param_subtrees`` copy; the geometry and
mock-encoder refusals give the JAX script's messages."""

import contextlib
import copy
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music_transcription_tpu.config import ModelConfig as JModelConfig
from music_transcription_tpu.models.transformer import ASTEncoderPretrainer as JPretrainer
from music_transcription_tpu.models.transformer import encoder_param_subtrees
from music_transcription_tpu.ops import losses as jlosses
from music_transcription_tpu_torch import train_ast
from music_transcription_tpu_torch.checkpoints import state_dict_from_jax
from music_transcription_tpu_torch.config import ModelConfig, config_to_dict
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from music_transcription_tpu_torch.models.transformer import (
    ASTEncoderPretrainer,
    encoder_state_dict,
)
from music_transcription_tpu_torch.train import ast_step
from tests.ast_parity import (
    GRAD_TOL,
    LOSS_RTOL,
    LR,
    REL_TOL,
    grad_err,
    jax_train_ast_script,
    pair,
    update_ratio,
    waves,
)


def _exit_message(fn) -> str:
    with pytest.raises(SystemExit) as e, contextlib.redirect_stdout(io.StringIO()):
        fn()
    return str(e.value.code)


PRE = dict(encoder_layers=2, encoder_dim=32, encoder_heads=4, patch_frames=4, n_mels=32)


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A JAX ASTEncoderPretrainer initialized on 1 s of audio, its tree, and
    the port's .pth + sidecar of it (through state_dict_from_jax)."""
    jmod = JPretrainer(**PRE)
    tree = jax.tree.map(np.asarray, jax.jit(jmod.init)(jax.random.key(5),
                                                         jnp.zeros((1, 16000))))
    path = str(tmp_path_factory.mktemp("pretrained") / "model_best.pth")
    torch.save(state_dict_from_jax(tree, ModelConfig(model_type="ast")), path)
    geometry = dict(encoder_layers=2, encoder_dim=32, encoder_heads=4, patch_frames=4,
                    encoder_n_mels=32)
    with open(path[:-4] + ".json", "w") as f:
        json.dump({"pretrain_encoder": geometry, "audio": {}}, f)
    return tree, path


def test_state_dict_from_jax_maps_a_pretrainer_tree_with_its_frame_head(pretrained):
    tree, path = pretrained
    sd = torch.load(path)
    own = ASTEncoderPretrainer(**PRE).state_dict()
    assert sorted(sd) == sorted(own) and {"frame_head.weight", "frame_head.bias"} <= set(sd)
    assert all(sd[k].shape == own[k].shape for k in own)
    np.testing.assert_array_equal(sd["frame_head.weight"].numpy(),
                                  tree["params"]["frame_head"]["kernel"].T)
    assert sorted({k.split(".")[0] for k in encoder_state_dict(sd)}) == [
        "enc0", "enc1", "enc_norm", "enc_pos", "patch_embed"]


def test_transplant_memory_matches_jax_subtree_copy_on_longer_audio(pretrained):
    """The port's transplant of a pretrainer initialized on 1 s, run on 3 s
    (enc_pos has 4096 rows): the memory within the fp32 tolerance of JAX's
    ASTTranscriber with encoder_param_subtrees copied in; the encoder equal
    to the pretrained one, the rest as it was."""
    tree, path = pretrained
    jm, variables, pm = pair("float32")
    m = copy.deepcopy(pm)
    before = {k: v.clone() for k, v in m.model.state_dict().items()}
    train_ast.transplant_encoder(m.model, path, m.config)
    pre_sd = torch.load(path)
    for k, v in m.model.state_dict().items():
        assert torch.equal(v, pre_sd[k] if k in encoder_state_dict(before) else before[k]), k
    params = dict(variables["params"])
    params.update(encoder_param_subtrees(tree["params"]))
    wave = waves(2, 3.0, seed=9)
    ref = np.asarray(jax.jit(lambda p, w: jm.module.apply({"params": p}, w, False,
                                                          method="_memory"))(
        params, jnp.asarray(wave)))
    with torch.inference_mode():
        got = m.model.memory(torch.from_numpy(wave)).numpy()
    assert got.shape == ref.shape == (2, 23, 32)
    assert float(np.abs(got - ref).max() / np.abs(ref).max()) <= REL_TOL["float32"]


def test_transplant_refusals_give_jax_messages(pretrained, tmp_path):
    """Geometry against the sidecar and a mock encoder: the JAX script's
    SystemExit messages. A checkpoint without an encoder subtree, or with
    other shapes, is refused key by key."""
    _, path = pretrained
    jax_script = jax_train_ast_script()
    _, variables, pm = pair("float32")
    jdir = tmp_path / "jax_ckpt"  # the JAX script reads the sidecar from a directory
    jdir.mkdir()
    with open(path[:-4] + ".json") as f:
        (jdir / "config.json").write_text(f.read())
    deeper = ModelConfig(**{**pm.config.__dict__, "encoder_layers": 3})
    j_deeper = JModelConfig(**{**config_to_dict(pm.config), "encoder_layers": 3})
    ours = _exit_message(lambda: train_ast.transplant_encoder(
        TranscriptionModel(deeper).model, path, deeper))
    theirs = _exit_message(lambda: jax_script.transplant_encoder(
        variables, str(jdir), j_deeper))
    assert ours == theirs and "geometry mismatch" in ours

    _, mock_vars, mock = pair("float32", use_mock_encoder=True)
    ours = _exit_message(lambda: train_ast.transplant_encoder(mock.model, path, mock.config))
    theirs = _exit_message(lambda: jax_script.transplant_encoder(
        mock_vars, str(jdir), JModelConfig(**config_to_dict(mock.config))))
    assert ours == theirs and "mock encoder has no parameters" in ours

    sd = torch.load(path)
    for name, edit, message in (
            ("lacking", lambda d: [d.pop("enc_norm.weight"), d.pop("enc_norm.bias")],
             "lacks encoder subtree 'enc_norm'"),
            ("shapes", lambda d: d.__setitem__("patch_embed.bias", torch.zeros(7)),
             "subtree 'patch_embed' shape mismatch")):
        broken = dict(sd)
        edit(broken)
        other = str(tmp_path / f"{name}.pth")  # no sidecar: the geometry check is skipped
        torch.save(broken, other)
        text = _exit_message(lambda: train_ast.transplant_encoder(
            copy.deepcopy(pm).model, other, pm.config))
        assert message in text


# ------------------------------------------------------------- pretraining

@pytest.fixture(scope="module")
def pretrain_pair():
    jmod = JPretrainer(dropout=0.0, **PRE)
    wave = waves(2, 1.0, seed=6)
    variables = jax.tree.map(np.asarray, jax.jit(jmod.init)(jax.random.key(2), jnp.asarray(wave)))
    rng = np.random.default_rng(7)
    roll = (rng.random((2, 88, 31)) < 0.1).astype(np.float32)
    lengths = np.array([31, 20], np.int32)
    return jmod, variables, wave, roll, lengths


def test_pretrain_step_and_validation_counts_match_jax(pretrain_pair):
    """scripts/train_ast.py:273-313: the masked BCE step with optax.adam, and
    validation's loss and framewise tp / fp / fn at logit > 0 after the
    logits' 32 frames are resampled to the roll's 31, over the valid
    frames."""
    jmod, variables, wave, roll, lengths = pretrain_pair
    w, r, ln = jnp.asarray(wave), jnp.asarray(roll), jnp.asarray(lengths)
    tx = optax.adam(LR)

    def loss_fn(p):
        logits = jmod.apply({"params": p}, w, train=True)
        return jlosses.masked_bce_loss(logits, r, ln)

    params = variables["params"]
    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    updates, _ = tx.update(j_grads, tx.init(params))
    j_params = optax.apply_updates(params, updates)
    logits = jax.jit(lambda p: jmod.apply({"params": p}, w, train=False))(params)
    pred = jlosses.interpolate_time_linear(logits, 31) > 0.0
    mask = (jnp.arange(31)[None, :] < ln[:, None])[:, None, :]
    pos = (r > 0.5) & mask
    j_counts = [int(jnp.sum(pred & pos)), int(jnp.sum(pred & ~pos & mask)),
                int(jnp.sum(~pred & pos))]

    cfg = ModelConfig(model_type="ast")
    as_sd = lambda tree: state_dict_from_jax(  # noqa: E731
        {"params": jax.tree.map(np.asarray, tree)}, cfg)
    m = ASTEncoderPretrainer(dropout=0.0, **PRE)
    m.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    before = {k: v.detach().clone() for k, v in m.named_parameters()}
    t_args = (torch.from_numpy(wave), torch.from_numpy(roll), torch.from_numpy(lengths))
    got = ast_step.pretrain_eval(m, *t_args).tolist()
    assert abs(got[0] - float(jlosses.masked_bce_loss(logits, r, ln))) <= LOSS_RTOL * got[0]
    assert got[1:] == j_counts and j_counts[0] + j_counts[2] > 0

    opt = ast_step.make_adam(m.parameters(), LR)
    loss = float(ast_step.pretrain_step(m, opt, *t_args))
    assert abs(loss - float(j_loss)) <= LOSS_RTOL * float(j_loss)
    grads = {k: p.grad for k, p in m.named_parameters()}
    assert grad_err(grads, as_sd(j_grads)) <= GRAD_TOL

    assert update_ratio(m, before, as_sd(j_grads), as_sd(j_params)) <= 1.0
