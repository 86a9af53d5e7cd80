"""PyTorch port: the clamped attention.

The plain version (the twin of the K3 kernel) is held against the JAX flash
kernel run in interpret mode (as tests/test_attention_pallas.py runs it) and
against the JAX model's XLA branch, at ragged T and with the clamp binding:
1e-5 in fp32. In bf16 the flash kernel normalizes after P.v and the plain
version before, so there the bound is 2e-2 (about two bf16 ulps of the
outputs' magnitude). The hand-written kernel is held against the plain
version on the card in tests/test_torch_gpu.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from music_transcription_tpu.models.cnn_rnn import MultiHeadSelfAttention as JAttention
from music_transcription_tpu.ops.attention_pallas import flash_attention_clamped as j_flash
from music_transcription_tpu_torch.models.cnn_rnn import MultiHeadSelfAttention
from music_transcription_tpu_torch.ops import attention_kernel as AK

FP32_TOL, BF16_TOL = 1e-5, 2e-2


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _qkv(t, h=2, d=32, b=2, qk_mag=1.0, seed=0):
    rng = np.random.default_rng(seed)
    return [(m * rng.standard_normal((b, t, h, d))).astype(np.float32) for m in (qk_mag, qk_mag, 1.0)]


@pytest.mark.parametrize("t", [37, 130])  # not a multiple of the 128 tile
def test_plain_matches_jax_flash_kernel(t):
    q, k, v = _qkv(t)
    scale = 32**-0.5
    ref = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), scale=scale))
    got = AK.attention_clamped_plain(*map(torch.from_numpy, (q, k, v)), scale).numpy()
    assert got.shape == ref.shape == q.shape
    assert np.abs(got - ref).max() < FP32_TOL


def test_plain_follows_the_clamp():
    q, k, v = _qkv(128, h=1, b=1, qk_mag=10.0, seed=1)
    scale = 32**-0.5
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    clamped = AK.attention_clamped_plain(qt, kt, vt, scale, 10.0).numpy()
    unclamped = AK.attention_clamped_plain(qt, kt, vt, scale, 1e9).numpy()
    assert np.abs(clamped - unclamped).max() > 1e-3  # the clamp binds here
    ref = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), scale=scale))
    assert np.abs(clamped - ref).max() < FP32_TOL


def test_plain_takes_fewer_keys_than_queries():
    q, k, v = _qkv(40, qk_mag=4.0, seed=2)
    scale = 32**-0.5
    s = np.einsum("bthd,bshd->bhts", q, k[:, :29]).astype(np.float64) * scale
    p = np.exp(np.clip(s, -10.0, 10.0))
    ref = np.einsum("bhts,bshd->bthd", p / p.sum(-1, keepdims=True), v[:, :29])
    got = AK.attention_clamped_plain(*map(torch.from_numpy, (q, k[:, :29], v[:, :29])), scale)
    assert got.shape == q.shape
    assert np.abs(got.numpy() - ref).max() < FP32_TOL


def test_plain_bf16_matches_jax_flash_kernel():
    q, k, v = _qkv(130, qk_mag=3.0, seed=2)
    scale = 32**-0.5
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(j_flash(jq, jk, jv, scale=scale).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = AK.attention_clamped_plain(tq, tk, tv, scale)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - ref).max() < BF16_TOL


def _modules(t, dtype, backend):
    hidden, heads = 24, 2
    x = np.random.default_rng(3).standard_normal((2, t, hidden)).astype(np.float32)
    jm = JAttention(hidden_dim=hidden, num_heads=heads, dropout=0.0, dtype=jnp.dtype(dtype),
                    backend="xla")
    variables = jm.init(jax.random.key(0), jnp.asarray(x), train=False)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False).astype(jnp.float32))
    pm = MultiHeadSelfAttention(hidden, heads, backend=backend).eval()
    p = jax.tree.map(np.asarray, variables["params"])
    with torch.no_grad():
        for name in ("qkv", "proj"):
            getattr(pm, name).weight.copy_(torch.from_numpy(p[name]["kernel"].T))
            getattr(pm, name).bias.copy_(torch.from_numpy(p[name]["bias"]))
        got = pm(torch.from_numpy(x), getattr(torch, dtype)).float().numpy()
    return got, ref


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("dtype,tol", [("float32", FP32_TOL), ("bfloat16", BF16_TOL)])
def test_attention_module_matches_jax_xla_branch(backend, dtype, tol):
    got, ref = _modules(37, dtype, backend)
    assert np.abs(got - ref).max() < tol


def test_auto_route_is_the_jax_rule():
    m = MultiHeadSelfAttention(48, 8, backend="auto")
    for b, t in ((1, 938), (16, 938), (4, 3751), (2, 4096), (1, 3751)):
        jax_route = "pallas" if 4.0 * b * 8 * t * t > 1.5e9 else "xla"
        assert m.route(b, t) == jax_route
    assert m.route(4, 3751) == "pallas" and m.route(16, 938) == "xla"


def test_wrapper_takes_plain_version_for_cpu_tensors():
    q, k, v = map(torch.from_numpy, _qkv(20))
    before = AK.flash_attention_clamped.launches
    assert torch.equal(AK.flash_attention_clamped(q, k, v, 0.2), AK.attention_clamped_plain(q, k, v, 0.2))
    assert AK.flash_attention_clamped.launches == before


def test_faulty_fwd_plain_fails_where_plain_passes():
    """K3's stale-stage fault (one key tile's v from the tile before) is far
    outside the tolerance that the plain version meets against JAX's kernel."""
    q, k, v = _qkv(130, d=24, qk_mag=3.0, seed=4)
    scale = 24**-0.5
    ref = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), scale=scale))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert np.abs(AK.attention_clamped_plain(tq, tk, tv, scale).numpy() - ref).max() < FP32_TOL
    assert np.abs(AK.faulty_fwd_plain(tq, tk, tv, scale).numpy() - ref).max() > 100 * FP32_TOL
    with pytest.raises(ValueError):  # T=37 is one key tile: no stage before it
        AK.faulty_fwd_plain(*map(torch.from_numpy, _qkv(37, d=24)), scale)
