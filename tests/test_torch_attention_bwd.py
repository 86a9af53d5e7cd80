"""PyTorch port: the clamped flash attention's training path, K3 with lse,
K4a and K4b, through their plain versions on the CPU.

The same seeded inputs (heads of 2, D=32, T=37 and 130: not multiples of
the 128-row Pallas tiles; the clamp binding on part of the logits) go through
the JAX package's flash attention in interpret mode (as
tests/test_attention_pallas.py runs it) and through the port.

Tolerances: fp32, the forward's output and lse within 1e-5 and the
gradients within 2e-4 (the JAX package's own bound for its VJP against
autodiff). bf16: the gradients within 2^-6 of each gradient's largest
magnitude. Both sides round dS and p to bf16 before the products, but their
inputs differ in the last bf16 place where the forward's outputs do (the
Pallas kernel normalizes o after P.v, the plain forward before), and a
rounding boundary crossed there moves dS by a bf16 unit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from music_transcription_tpu.models.cnn_rnn import MultiHeadSelfAttention as JAttention
from music_transcription_tpu.ops.attention_pallas import _fwd_call, _recompute_p_ds
from music_transcription_tpu.ops.attention_pallas import flash_attention_clamped as j_flash
from music_transcription_tpu_torch.models.cnn_rnn import MultiHeadSelfAttention
from music_transcription_tpu_torch.ops import attention_kernel as AK

FP32_TOL, GRAD_FP32_TOL, GRAD_BF16_REL = 1e-5, 2e-4, 2.0**-6
D, SCALE = 32, 32**-0.5


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(t, seed=0, qk_mag=3.0, b=2, h=2):
    """q, k, v and an output cotangent; at qk_mag 3 about a quarter of the
    scaled logits pass +-10."""
    rng = np.random.default_rng(seed)
    return [(m * rng.standard_normal((b, t, h, D))).astype(np.float32)
            for m in (qk_mag, qk_mag, 1.0, 1.0)]


@functools.lru_cache(maxsize=None)
def _reference(t, seed, dtype=jnp.float32):
    """The inputs of ``_inputs(t, seed)`` and JAX's output and gradients."""
    q, k, v, do = inputs = _inputs(t, seed=seed)
    return inputs, _jax_vjp(q, k, v, do, dtype)


def _jax_vjp(q, k, v, do, dtype=jnp.float32):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(lambda a, b_, c: j_flash(a, b_, c, scale=SCALE), *args)
    grads = vjp(jnp.asarray(do, dtype))
    return [np.asarray(g.astype(jnp.float32)) for g in (out, *grads)]


@pytest.mark.parametrize("t", [37, 130])
def test_forward_with_lse_matches_jax(t):
    q, k, v, _ = _inputs(t)
    b, _, h, d = q.shape

    def to_bh(x):
        return jnp.transpose(jnp.asarray(x), (0, 2, 1, 3)).reshape(b * h, t, d)

    t_pad = -(-t // 128) * 128
    qh, kh, vh = (jnp.pad(to_bh(x), ((0, 0), (0, t_pad - t), (0, 0))) for x in (q, k, v))
    out, lse = _fwd_call((SCALE, 10.0, t, 128, 128), qh, kh, vh, with_lse=True)
    ref_o = np.asarray(out[:, :t]).reshape(b, h, t, d).transpose(0, 2, 1, 3)
    ref_lse = np.asarray(lse[:, :t, 0])
    got_o, got_lse = AK.flash_attention_clamped_fwd(*map(torch.from_numpy, (q, k, v)), SCALE)
    assert got_lse.shape == (b, h, t) and got_lse.dtype == torch.float32
    assert np.abs(got_lse.reshape(b * h, t).numpy() - ref_lse).max() < FP32_TOL
    assert np.abs(got_o.numpy() - ref_o).max() < FP32_TOL


def _port_grads(q, k, v, do, dtype, fn):
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
    out = fn(tq, tk, tv)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do).to(dtype))
    return [g.float().numpy() for g in (out.detach(), *grads)]


def _via_plain(q, k, v, do, dtype):
    """The plain forward with lse, then the plain backward."""
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    o, lse = AK.attention_clamped_fwd_plain(tq, tk, tv, SCALE)
    grads = AK.attention_clamped_bwd_plain(tq, tk, tv, o, tdo, lse, SCALE)
    return [g.float().numpy() for g in (o, *grads)]


def _via_function(q, k, v, do, dtype):
    """The wrapper with a gradient wanted: FlashAttentionClamped."""
    return _port_grads(q, k, v, do, dtype, lambda a, b_, c: AK.flash_attention_clamped(a, b_, c, SCALE))


@pytest.mark.parametrize("route", [_via_plain, _via_function], ids=["plain", "function"])
@pytest.mark.parametrize("t", [37, 130])
def test_gradients_match_jax_vjp_fp32(t, route):
    (q, k, v, do), ref = _reference(t, t)
    got = route(q, k, v, do, torch.float32)
    assert np.abs(got[0] - ref[0]).max() < FP32_TOL
    for name, g, r in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
        assert np.abs(g - r).max() < GRAD_FP32_TOL, name


@pytest.mark.parametrize("route", [_via_plain, _via_function], ids=["plain", "function"])
def test_gradients_match_jax_vjp_bf16(route):
    (q, k, v, do), ref = _reference(130, 5, jnp.bfloat16)
    got = route(q, k, v, do, torch.bfloat16)
    for name, g, r in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
        assert np.abs(g - r).max() <= GRAD_BF16_REL * np.abs(r).max(), name


def test_backward_gates_on_the_pre_clip_logits():
    """The clamp binds here, so a backward that ignored its gate would be far
    off; the plain backward is not."""
    q, k, v, do = _inputs(37, seed=9, qk_mag=6.0)
    ref = _jax_vjp(q, k, v, do)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = AK.attention_clamped_fwd_plain(tq, tk, tv, SCALE)
    gated = AK.attention_clamped_bwd_plain(tq, tk, tv, o, tdo, lse, SCALE)
    assert np.abs(gated[0].numpy() - ref[1]).max() < GRAD_FP32_TOL
    # dq without the gate: dS = p (dP - delta) scale everywhere
    z = torch.einsum("bthd,bshd->bhts", tq, tk) * SCALE
    p = torch.exp(torch.clamp(z, -10.0, 10.0) - lse[..., None])
    delta = (tdo * o).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (torch.einsum("bthd,bshd->bhts", tdo, tv) - delta) * SCALE
    ungated_dq = torch.einsum("bhts,bshd->bthd", ds, tk)
    assert np.abs(ungated_dq.numpy() - ref[1]).max() > 100 * GRAD_FP32_TOL


def test_cpu_gradient_takes_the_function_and_no_kernel():
    q, k, v, do = _inputs(20, seed=3)
    counters = (AK.flash_attention_clamped, AK.flash_attention_clamped_fwd,
                AK.flash_attention_clamped_dq, AK.flash_attention_clamped_dkv)
    before = [c.launches for c in counters]
    tq = torch.from_numpy(q).requires_grad_()
    out = AK.flash_attention_clamped(tq, torch.from_numpy(k), torch.from_numpy(v), SCALE)
    assert out.grad_fn is not None and "FlashAttentionClamped" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(do))
    assert tq.grad is not None and tq.grad.shape == tq.shape
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("t", [37, 130])
def test_module_training_gradients_match_jax(t):
    """MultiHeadSelfAttention with backend "pallas" in training, dropout 0:
    the gradients of its input and of qkv / proj against the JAX module's."""
    hidden, heads = 64, 2  # head_dim 32
    rng = np.random.default_rng(t + 1)
    x = (2.0 * rng.standard_normal((2, t, hidden))).astype(np.float32)
    cot = rng.standard_normal((2, t, hidden)).astype(np.float32)
    jm = JAttention(hidden_dim=hidden, num_heads=heads, dropout=0.0, backend="pallas")
    variables = jm.init(jax.random.key(0), jnp.asarray(x), train=False)
    params = variables["params"]
    # larger qkv weights so the clamp binds on part of the logits
    params = jax.tree.map(lambda a: a * 3.0 if a.ndim == 2 else a, params)

    def j_loss(p, xx):
        return jnp.vdot(jm.apply({"params": p}, xx, train=True), jnp.asarray(cot))

    j_gp, j_gx = jax.grad(j_loss, argnums=(0, 1))(params, jnp.asarray(x))

    pm = MultiHeadSelfAttention(hidden, heads, backend="pallas", dropout=0.0).train()
    with torch.no_grad():
        for name in ("qkv", "proj"):
            getattr(pm, name).weight.copy_(torch.from_numpy(np.array(params[name]["kernel"]).T))
            getattr(pm, name).bias.copy_(torch.from_numpy(np.array(params[name]["bias"])))
    tx = torch.from_numpy(x).requires_grad_()
    out = pm(tx, torch.float32, generator=torch.Generator().manual_seed(0))
    (out * torch.from_numpy(cot)).sum().backward()
    assert np.abs(tx.grad.numpy() - np.asarray(j_gx)).max() < GRAD_FP32_TOL
    for name in ("qkv", "proj"):
        g_w = getattr(pm, name).weight.grad.numpy().T
        ref_w = np.asarray(j_gp[name]["kernel"])
        assert np.abs(g_w - ref_w).max() <= 1e-5 * np.abs(ref_w).max(), name
        ref_b = np.asarray(j_gp[name]["bias"])
        assert np.abs(getattr(pm, name).bias.grad.numpy() - ref_b).max() <= 1e-5 * np.abs(ref_b).max()


D_SMALL = 24


def _small_inputs(t, seed):
    rng = np.random.default_rng(seed)
    return [(m * rng.standard_normal((2, t, 2, D_SMALL))).astype(np.float32)
            for m in (3.0, 3.0, 1.0, 1.0)]


@pytest.mark.parametrize("fault,t", [("skip_last_query_tile", 37), ("skip_last_query_tile", 130),
                                     ("stale_query_stage", 130)])
def test_faulty_dkv_plain_fails_where_plain_passes(fault, t):
    """K4b's ring faults: dk and dv far outside the tolerance that the plain
    backward meets against JAX's VJP (at T=37 the only query tile is partial,
    so skipping it leaves nothing)."""
    q, k, v, do = _small_inputs(t, seed=t + 11)
    scale = D_SMALL**-0.5
    args = [jnp.asarray(x) for x in (q, k, v)]
    _, vjp = jax.vjp(lambda a, b_, c: j_flash(a, b_, c, scale=scale), *args)
    ref = [np.asarray(g) for g in vjp(jnp.asarray(do))][1:]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = AK.attention_clamped_fwd_plain(tq, tk, tv, scale)
    plain = AK.attention_clamped_bwd_plain(tq, tk, tv, o, tdo, lse, scale)[1:]
    faulty = AK.faulty_dkv_plain(tq, tk, tv, o, tdo, lse, scale, fault=fault)
    for g, f, r in zip(plain, faulty, ref):
        assert np.abs(g.numpy() - r).max() < GRAD_FP32_TOL
    assert max(np.abs(f.numpy() - r).max() for f, r in zip(faulty, ref)) > 100 * GRAD_FP32_TOL


@pytest.mark.parametrize("fault,t,tile", [
    *(pytest.param(f, t, AK.K4A_KEY_TILE, id=f"{f}-{t}")
      for f, t in [("skip_last_key_tile", 37), ("skip_last_key_tile", 130),
                   ("stale_key_stage", 130)]),
    # the fp32 K4a's sum of its two warp pairs' partial dq, at T = 2 key tiles + 1
    # (its tile faults are the bf16 cases': both kernels take key tiles of 64)
    pytest.param("dropped_pair_partial", 2 * AK.K4A_KEY_TILE_F32 + 1, AK.K4A_KEY_TILE_F32,
                 id=f"dropped_pair_partial-fp32_tile{AK.K4A_KEY_TILE_F32}")])
def test_faulty_dq_plain_fails_where_plain_passes(fault, t, tile):
    """K4a's ring faults: dq far outside the tolerance that the plain backward
    meets against JAX's VJP (at T=37 the only key tile is partial, so skipping
    it leaves nothing), and the fp32 kernel's dropped pair sum."""
    q, k, v, do = _small_inputs(t, seed=t + 13)
    scale = D_SMALL**-0.5
    args = [jnp.asarray(x) for x in (q, k, v)]
    _, vjp = jax.vjp(lambda a, b_, c: j_flash(a, b_, c, scale=scale), *args)
    ref = np.asarray(vjp(jnp.asarray(do))[0])
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = AK.attention_clamped_fwd_plain(tq, tk, tv, scale)
    plain = AK.attention_clamped_bwd_plain(tq, tk, tv, o, tdo, lse, scale)[0]
    faulty = AK.faulty_dq_plain(tq, tk, tv, o, tdo, lse, scale, fault=fault, tile=tile)
    assert np.abs(plain.numpy() - ref).max() < GRAD_FP32_TOL
    assert np.abs(faulty.numpy() - ref).max() > 100 * GRAD_FP32_TOL


@pytest.mark.parametrize("d,run", [(24, 8), (192, 8), (200, 4), (256, 4)])
def test_dropped_pair_partial_follows_the_kernels_key_runs(d, run):
    """The fault drops the keys of the fp32 K4a's second warp pair: runs of
    8 keys (4 at head_dim > 192, ``F32DqTiles::kRW``) alternating with the
    first pair's. A change to the k row of a dropped key leaves the faulty dq
    as it was; one to a kept key's row moves it."""
    assert AK.k4a_pair_keys_f32(d) == run
    rng = np.random.default_rng(d)
    t = 4 * run
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, t, 1, d)).astype(np.float32))
                   for _ in range(4))
    scale = d**-0.5
    o, lse = AK.attention_clamped_fwd_plain(q, k, v, scale)

    def faulty(k_):
        return AK.faulty_dq_plain(q, k_, v, o, do, lse, scale, fault="dropped_pair_partial")

    base = faulty(k)
    assert not torch.equal(base, AK.attention_clamped_bwd_plain(q, k, v, o, do, lse, scale)[0])
    for key, dropped in ((run - 1, False), (run, True), (2 * run - 1, True), (2 * run, False)):
        moved = k.clone()
        moved[:, key] += 1.0
        assert torch.equal(faulty(moved), base) == dropped, key


def test_delta_plain_matches_jax_recompute():
    """K4b's pre-pass, delta = rowsum(dO o), against the delta inside
    ``_recompute_p_ds``: with v = 0, k = 0, lse = 0, scale 1 and no clamp,
    p = 1 and dP = 0, so its dS is exactly -delta."""
    q, _, _, do = _small_inputs(37, seed=5)
    o = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    got = AK.attention_delta_plain(torch.from_numpy(o), torch.from_numpy(do)).numpy()
    assert got.shape == (2, 2, 37) and got.dtype == np.float32
    t = q.shape[1]
    zeros = jnp.zeros((t, D_SMALL), jnp.float32)
    for b in range(2):
        for h in range(2):
            p, ds = _recompute_p_ds(jnp.asarray(q[b, :, h]), zeros, zeros, jnp.asarray(o[b, :, h]),
                                    jnp.asarray(do[b, :, h]), jnp.zeros((t, 1), jnp.float32), 0,
                                    scale=1.0, clip_val=1e9, t_valid=t)
            assert np.all(np.asarray(p) == 1.0)
            ref = -np.asarray(ds)[:, 0]
            assert np.abs(got[b, h] - ref).max() <= 1e-6 * np.abs(ref).max()
