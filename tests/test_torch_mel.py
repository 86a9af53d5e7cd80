"""PyTorch port: log-mel frontend against the JAX package and the float64
oracle (bound 6e-2 dB, as tests/test_mel.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_transcription_tpu.config import AudioConfig as JAudioConfig
from music_transcription_tpu.ops import mel as JMEL
from music_transcription_tpu_torch.config import AudioConfig
from music_transcription_tpu_torch.ops import mel as MEL

DB_TOL = 6e-2  # fp32 device paths vs the float64 oracle, in dB


def _both(y, **cfg):
    """(port, JAX, numpy-oracle) log-mel of a (B, n) batch."""
    ours = MEL.log_mel_batch(torch.from_numpy(y), AudioConfig(**cfg)).numpy()
    jax_out = np.asarray(JMEL.log_mel_batch(jnp.asarray(y), JAudioConfig(**cfg)))
    oracle = np.stack([JMEL.log_mel_numpy(row, JAudioConfig(**cfg)) for row in y])
    return ours, jax_out, oracle


@pytest.mark.parametrize("cfg", [
    {},                                          # shipped: n_mels 320, hop 512
    {"n_mels": 64, "chunk_length": 1.0},
    {"n_mels": 32, "win_length": 1024},
])
def test_log_mel_batch_matches_jax_and_oracle(cfg):
    rng = np.random.default_rng(0)
    y = (0.1 * rng.standard_normal((2, 16000))).astype(np.float32)
    ours, jax_out, oracle = _both(y, **cfg)
    assert ours.shape == jax_out.shape == oracle.shape
    assert np.abs(ours - jax_out).max() < DB_TOL
    assert np.abs(ours - oracle).max() < DB_TOL


def test_numpy_helpers_are_copies():
    for args in ((16000, 2048, 320), (22050, 1024, 64, 30.0, 8000.0)):
        np.testing.assert_array_equal(MEL.mel_filterbank(*args), JMEL.mel_filterbank(*args))
    np.testing.assert_array_equal(MEL._padded_window(2048, 1024), JMEL._padded_window(2048, 1024))
    assert MEL.num_frames(480000, 512) == JMEL.num_frames(480000, 512) == 938
    y = np.random.default_rng(6).standard_normal(4000).astype(np.float32)
    cfg = dict(n_mels=32, hop_length=256)
    np.testing.assert_array_equal(MEL.log_mel_numpy(y, AudioConfig(**cfg)),
                                  JMEL.log_mel_numpy(y, JAudioConfig(**cfg)))


def test_per_chunk_db_floor():
    """top_db floor per batch element (per chunk), as tests/test_mel.py."""
    rng = np.random.default_rng(1)
    loud = (0.9 * rng.standard_normal(8192)).astype(np.float32)
    quiet = (1e-6 * rng.standard_normal(8192)).astype(np.float32)
    cfg = AudioConfig()
    batch = MEL.log_mel_batch(torch.from_numpy(np.stack([loud, quiet])), cfg).numpy()
    single_quiet = MEL.log_mel_batch(torch.from_numpy(quiet[None]), cfg).numpy()[0]
    assert np.abs(batch[1] - single_quiet).max() < 1e-4
    for i in range(2):
        assert batch[i].max() - batch[i].min() <= cfg.top_db + 1e-3
    ref = np.asarray(JMEL.log_mel_batch(jnp.asarray(np.stack([loud, quiet])), JAudioConfig()))
    assert np.abs(batch - ref).max() < DB_TOL


def test_gather_framing_hop_500():
    """hop that does not divide n_fft (the JAX package's gather framing)."""
    rng = np.random.default_rng(3)
    y = (0.1 * rng.standard_normal((1, 8000))).astype(np.float32)
    ours, jax_out, oracle = _both(y, n_mels=32, hop_length=500, n_fft=2048, chunk_length=1.0)
    assert ours.shape == (1, 32, 1 + 8000 // 500)
    assert np.abs(ours - jax_out).max() < DB_TOL
    assert np.abs(ours - oracle).max() < DB_TOL


def test_apply_floor_false_matches_jax():
    rng = np.random.default_rng(4)
    # one loud and one very quiet half per row: more than top_db of range
    y = np.concatenate([0.3 * rng.standard_normal((2, 8192)),
                        1e-5 * rng.standard_normal((2, 8192))], axis=1).astype(np.float32)
    cfg = dict(n_mels=32)
    ours = MEL.log_mel_batch(torch.from_numpy(y), AudioConfig(**cfg), apply_floor=False).numpy()
    ref = np.asarray(JMEL.log_mel_batch(jnp.asarray(y), JAudioConfig(**cfg), apply_floor=False))
    assert np.abs(ours - ref).max() < DB_TOL
    assert ours[0].max() - ours[0].min() > AudioConfig().top_db  # the floor really is off

