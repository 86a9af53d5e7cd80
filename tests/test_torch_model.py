"""PyTorch port: CNNRNN / CNNRNNLarge forward from JAX weights.

Seeded JAX init -> state_dict_from_jax -> the port's forward on the same
mel, all three heads, at the geometries of tests/test_checkpoint_convert.py
(kept small). fp32 within 1e-4; bf16 within 2e-2 (about one bf16 ulp at the
logits' magnitude, for convolutions that may accumulate in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_transcription_tpu.config import AudioConfig as JAudioConfig
from music_transcription_tpu.config import ModelConfig as JModelConfig
from music_transcription_tpu.config import TrainConfig as JTrainConfig
from music_transcription_tpu.models.transcription import TranscriptionModel as JModel
from music_transcription_tpu.train.checkpoints import export_torch_state_dict, save_torch_checkpoint
from music_transcription_tpu_torch.checkpoints import load_torch_checkpoint, state_dict_from_jax
from music_transcription_tpu_torch.config import (AudioConfig, ModelConfig, TrainConfig, config_from_dict,
                                                  config_to_dict)
from music_transcription_tpu_torch.models.transcription import TranscriptionModel

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _jax_model(seed=0, **cfg):
    jm = JModel(JModelConfig(**cfg))
    variables = jax.tree.map(np.asarray, dict(jm.init(jax.random.key(seed),
                                                      jm.example_input(batch=1, t=6))))
    # move BN running stats off (0, 1) so the test exercises them
    rng = np.random.default_rng(seed)
    variables["batch_stats"] = jax.tree.map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32), variables["batch_stats"])
    return jm, variables


def _port(variables, **cfg):
    pm = TranscriptionModel(ModelConfig(**cfg))
    pm.model.load_state_dict(state_dict_from_jax(variables, ModelConfig(**cfg)), strict=True)
    return pm.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model_type,n_mels,t", [("cnn_rnn_large", 16, 12),
                                                 ("cnn_rnn_large", 320, 8),
                                                 ("cnn_rnn", 16, 12)])
def test_forward_matches_jax(model_type, n_mels, t, dtype):
    cfg = dict(model_type=model_type, n_mels=n_mels, hidden_size=8, num_layers=2,
               compute_dtype=dtype)
    jm, variables = _jax_model(**cfg)
    pm = _port(variables, **cfg)
    x = np.random.default_rng(2).standard_normal((2, 1, n_mels, t)).astype(np.float32)
    large = model_type == "cnn_rnn_large"
    ref = jm.apply(variables, jnp.asarray(x), return_all_heads=large)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), return_all_heads=large)
        frame_only = pm(torch.from_numpy(x))
    if not large:
        ref, got = {"frame": ref}, {"frame": got}
    for head in ref:
        assert got[head].shape == (2, 88, t)
        assert np.abs(got[head].numpy() - np.asarray(ref[head])).max() < TOL[dtype], head
    assert torch.equal(frame_only, got["frame"])


@pytest.mark.parametrize("model_type", ["cnn_rnn_large", "cnn_rnn"])
def test_state_dict_from_jax_equals_export(model_type):
    cfg = dict(model_type=model_type, n_mels=16, hidden_size=8, num_layers=2)
    _, variables = _jax_model(seed=1, **cfg)
    ours = state_dict_from_jax(variables, ModelConfig(**cfg))
    ref = export_torch_state_dict(variables, JModelConfig(**cfg), prefix="")
    assert set(ours) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    assert set(ours) == set(TranscriptionModel(ModelConfig(**cfg)).model.state_dict())


def test_pth_from_jax_package_loads_strict(tmp_path):
    cfg = dict(model_type="cnn_rnn_large", n_mels=16, hidden_size=8, num_layers=1)
    _, variables = _jax_model(seed=2, **cfg)
    save_torch_checkpoint(tmp_path / "m.pth", variables, JModelConfig(**cfg))  # "model." prefix
    pm = TranscriptionModel(ModelConfig(**cfg))
    load_torch_checkpoint(tmp_path / "m.pth", pm.model)
    ref = _port(variables, **cfg)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 16, 10)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(pm.eval()(x), ref(x))


def test_ast_is_not_ported_and_training_forward_raises():
    # the AST tier builds since its inference path was ported (the test's
    # name predates that); its training forward, like the CNN-RNN ones, draws
    # its dropout masks from an explicit generator only: without one it
    # raises rather than use the global RNG
    ast = TranscriptionModel(ModelConfig(model_type="ast", decoder_layers=1, decoder_dim=16,
                                         decoder_heads=2, encoder_layers=1, encoder_dim=16,
                                         encoder_heads=2, encoder_n_mels=16, max_output_len=8))
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        ast.train()(torch.zeros(1, 4000), targets=torch.zeros(1, 4, dtype=torch.long))
    pm = TranscriptionModel(ModelConfig(n_mels=16, hidden_size=8, num_layers=1))
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        pm.train()(torch.zeros(1, 16, 4))


def test_predict_thresholds_sigmoid():
    cfg = dict(model_type="cnn_rnn", n_mels=16, hidden_size=8, num_layers=1)
    jm, variables = _jax_model(seed=4, **cfg)
    pm = _port(variables, **cfg)
    x = np.random.default_rng(5).standard_normal((2, 16, 9)).astype(np.float32)
    ref = np.asarray(jm.predict(variables, jnp.asarray(x), threshold=0.5))
    with torch.no_grad():
        got = pm.predict(torch.from_numpy(x), threshold=0.5).numpy()
    assert np.array_equal(got, ref)


# the port's own model's fields, after the JAX package's (models/hft.py)
HFT_FIELDS = [("ffn_dim", 512), ("conv_channels", 4), ("conv_kernel", 5),
              ("segment_frames", 128), ("margin_frames", 32), ("velocity_classes", 128)]


def test_config_copies_keep_the_jax_fields_and_defaults():
    for ours, ref in ((AudioConfig, JAudioConfig), (ModelConfig, JModelConfig),
                      (TrainConfig, JTrainConfig)):
        assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
            [(f.name, f.default) for f in dataclasses.fields(ref)] + \
            (HFT_FIELDS if ours is ModelConfig else [])
    # a model section written by the port holds the JAX package's keys, but
    # for hFT, and loads there, and back
    model = config_to_dict(ModelConfig(n_mels=64, hidden_size=32))
    assert model == config_to_dict(JModelConfig(**model))
    assert config_to_dict(config_from_dict(ModelConfig, model)) == model
    hft = config_to_dict(ModelConfig(model_type="hft"))
    assert [k for k in hft if k not in model] == [k for k, _ in HFT_FIELDS]
    # a parameters.json section written by either package loads in the other
    train = config_to_dict(JTrainConfig(epochs=3, partitioning="dp", stall_timeout_s=5.0))
    assert config_to_dict(TrainConfig(**train)) == train
    for bad in (dict(save_best_every=0), dict(save_every=-1)):
        for cls in (TrainConfig, JTrainConfig):
            with pytest.raises(ValueError):
                cls(**bad)
