"""Clamped flash attention: K3 (forward, with or without the per-row
logsumexp), K4a (dQ) and K4b (dK, dV).

Ports of ``flash_attention_clamped`` / ``_fwd_call`` / ``_flash_kernel`` (K3),
and of ``_flash_bwd``'s ``_bwd_dq_kernel`` (K4a) and ``_bwd_dkv_kernel`` (K4b)
in the JAX package's ``ops/attention_pallas.py``: per (batch, head),
``softmax(clip(q @ k^T * scale, -clip, clip)) @ v``, with q, k, v laid out
(B, T, H, D) as the model produces them. The logsumexp ``lse`` is fp32
(B, H, T), one value per row (the Pallas kernel broadcasts it over 128 lanes
for the TPU's tiles).

Each wrapper launches its hand-written CUDA kernel
(``csrc/flash_attention_clamped.cu``) for a CUDA tensor and takes its plain
version only for a CPU tensor. The plain forward is the arithmetic of the
model's materialized-scores ("xla") branch: fp32 scores from compute-dtype q
and k, the clamp, an fp32 softmax, probabilities cast to the compute dtype
before ``@ v`` with fp32 accumulation. The plain backward rounds where
``_recompute_p_ds`` and the Pallas backward kernels round.

``FlashAttentionClamped`` is the differentiable attention (the JAX package's
``_flash`` custom VJP): K3 with lse forward, K4a and K4b backward.
``flash_attention_clamped`` takes it when a gradient is wanted and K3 without
lse otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from music_transcription_tpu_torch.ops import _build
from music_transcription_tpu_torch.ops.precision import full_fp32, matmul_f32

MAX_HEAD_DIM = 256  # the kernels' shared-memory tiles hold head_dim <= 256
MAX_BATCH_HEADS = 65535  # B * H: the kernels' grids take one (batch, head) a row of blocks
K3_KEY_TILE = 64  # keys a bf16 K3 stage holds
K4A_KEY_TILE = 64  # keys a bf16 K4a stage holds
K4B_QUERY_TILE = 64  # query rows a bf16 K4b stage holds
K3_KEY_TILE_F32 = 64  # keys of an fp32 K3 tile (its ring's k and v chunks)
K4A_KEY_TILE_F32 = 32  # keys of an fp32 K4a tile
K4B_QUERY_TILE_F32 = 64  # query rows of an fp32 K4b tile (its ring's q and dO chunks)
_SUFFIX = {torch.bfloat16: "", torch.float32: "_f32"}  # of each launch function's name


def _heads(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, D) -> (B*H, T, D)."""
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d)


def _unheads(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """(B*H, T, D) -> (B, T, H, D)."""
    return x.view(b, h, x.shape[1], x.shape[2]).permute(0, 2, 1, 3)


def attention_clamped_plain(q, k, v, scale: float, clip_val: float = 10.0,
                            prob_dropout=None) -> torch.Tensor:
    """(B, T, H, D) q and (B, S, H, D) k/v -> (B, T, H, D) in q's dtype,
    scores materialized. ``prob_dropout``, a function of the fp32
    probabilities, is the model's attention dropout in training."""
    b, t, h, d = q.shape
    s = matmul_f32(_heads(q), _heads(k).transpose(1, 2)) * scale
    p = torch.softmax(torch.clamp(s, -clip_val, clip_val), dim=-1)
    if prob_dropout is not None:
        p = prob_dropout(p)
    out = matmul_f32(p.to(v.dtype), _heads(v))
    return _unheads(out, b, h).to(q.dtype)


def attention_clamped_fwd_plain(q, k, v, scale: float, clip_val: float = 10.0):
    """K3-with-lse's plain version: (o, lse), o as ``attention_clamped_plain``
    and lse (B, H, T) fp32 the logsumexp of each row's clamped scores."""
    b, t, h, _ = q.shape
    s = matmul_f32(_heads(q), _heads(k).transpose(1, 2)) * scale
    lse = torch.logsumexp(torch.clamp(s, -clip_val, clip_val), dim=-1)
    return attention_clamped_plain(q, k, v, scale, clip_val), lse.view(b, h, t)


def attention_clamped_bwd_plain(q, k, v, o, do, lse, scale: float, clip_val: float = 10.0):
    """K4a's and K4b's plain version: (dq, dk, dv) in q's dtype, from the
    forward's inputs, its output ``o``, the output gradient ``do`` and
    ``lse`` (B, H, T). As ``_recompute_p_ds``: z = q k^T scale in fp32,
    p = exp(clip(z) - lse), delta = rowsum(do o) in fp32 from the stored o,
    dp = do v^T in fp32, ds = p (dp - delta) 1{-clip <= z <= clip} scale; ds
    and p cast to the input dtype before dq = ds k, dk = ds^T q, dv = p^T do,
    each accumulated in fp32."""
    b, t, h, _ = q.shape
    dt = q.dtype
    qh, kh, vh, oh, doh = (_heads(x) for x in (q, k, v, o, do))
    with full_fp32():
        z = matmul_f32(qh, kh.transpose(1, 2)) * scale
        p = torch.exp(torch.clamp(z, -clip_val, clip_val) - lse.reshape(b * h, t, 1).float())
        delta = (doh.float() * oh.float()).sum(-1, keepdim=True)
        dp = torch.matmul(doh.float(), vh.float().transpose(1, 2))
        gate = (z >= -clip_val) & (z <= clip_val)
        ds = torch.where(gate, p * (dp - delta), torch.zeros_like(p)) * scale
        ds, p = ds.to(dt), p.to(dt)
        dq = matmul_f32(ds, kh)
        dk = matmul_f32(ds.transpose(1, 2), qh)
        dv = matmul_f32(p.transpose(1, 2), doh)
    return tuple(_unheads(g, b, h).to(dt) for g in (dq, dk, dv))


def attention_delta_plain(o, do) -> torch.Tensor:
    """The K4b pre-pass's plain version: delta = rowsum(do * o) in fp32,
    (B, H, T) from (B, T, H, D) o and do, as ``_recompute_p_ds`` sums it."""
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()


def faulty_fwd_plain(q, k, v, scale: float, clip_val: float = 10.0, *, tile: int = K3_KEY_TILE):
    """What K3 would give if one stage of its ring were read before it was
    refilled: the plain version with key tile ``nk // 2``'s v rows taken
    from the tile before it (``tile`` keys a tile: ``K3_KEY_TILE`` in bf16,
    ``K3_KEY_TILE_F32`` in fp32). For showing that K3's tolerance catches a
    stale stage."""
    t = k.shape[1]
    j = -(-t // tile) // 2
    if j < 1:
        raise ValueError(f"a stale stage needs two key tiles of {tile}, T={t}")
    stale = v.clone()
    stale[:, j * tile:(j + 1) * tile] = v[:, (j - 1) * tile:j * tile][:, :t - j * tile]
    return attention_clamped_plain(q, k, stale, scale, clip_val)


DKV_FAULTS = ("skip_last_query_tile", "stale_query_stage")


def faulty_dkv_plain(q, k, v, o, do, lse, scale: float, clip_val: float = 10.0, *,
                     fault: str, tile: int = K4B_QUERY_TILE):
    """What K4b would give with a broken query ring, (dk, dv) of the plain
    backward: "skip_last_query_tile" leaves out the query rows past the last
    whole tile of ``tile`` (``K4B_QUERY_TILE`` in bf16, ``K4B_QUERY_TILE_F32``
    in fp32: the partial tail); "stale_query_stage" gives query tile
    ``nq // 2`` the q, dO, lse and delta (o) of the tile before it. For
    showing that K4b's tolerance catches either."""
    t = q.shape[1]
    if fault == "skip_last_query_tile":
        kept = t // tile * tile
        q, o, do, lse = q[:, :kept], o[:, :kept], do[:, :kept], lse[..., :kept]
    elif fault == "stale_query_stage":
        j = -(-t // tile) // 2
        if j < 1:
            raise ValueError(f"a stale stage needs two query tiles of {tile}, T={t}")
        rows = slice(j * tile, min((j + 1) * tile, t))
        n = rows.stop - rows.start
        q, o, do, lse = (x.clone() for x in (q, o, do, lse))
        for x in (q, o, do):
            x[:, rows] = x[:, (j - 1) * tile:(j - 1) * tile + n]
        lse[..., rows] = lse[..., (j - 1) * tile:(j - 1) * tile + n]
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {DKV_FAULTS}")
    return attention_clamped_bwd_plain(q, k, v, o, do, lse, scale, clip_val)[1:]


DQ_FAULTS = ("skip_last_key_tile", "stale_key_stage")


def faulty_dq_plain(q, k, v, o, do, lse, scale: float, clip_val: float = 10.0, *, fault: str,
                    tile: int = K4A_KEY_TILE):
    """What K4a would give with a broken key ring, dq of the plain backward:
    "skip_last_key_tile" leaves out the keys past the last whole tile of
    ``tile`` (``K4A_KEY_TILE`` in bf16, ``K4A_KEY_TILE_F32`` in fp32: the
    partial tail); "stale_key_stage" gives key tile ``nk // 2`` the k and v
    of the tile before it. For showing that K4a's tolerance catches either."""
    t = k.shape[1]
    if fault == "skip_last_key_tile":
        kept = t // tile * tile
        k, v = k[:, :kept], v[:, :kept]
    elif fault == "stale_key_stage":
        j = -(-t // tile) // 2
        if j < 1:
            raise ValueError(f"a stale stage needs two key tiles of {tile}, T={t}")
        n = min((j + 1) * tile, t) - j * tile
        k, v = k.clone(), v.clone()
        for x in (k, v):
            x[:, j * tile:j * tile + n] = x[:, (j - 1) * tile:(j - 1) * tile + n]
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {DQ_FAULTS}")
    return attention_clamped_bwd_plain(q, k, v, o, do, lse, scale, clip_val)[0]


def _check(name, *tensors):
    """Device, dtype and shape checks of a kernel's (B, T, H, D) inputs;
    returns (B, T, H, D) and the contiguous tensors."""
    q = tensors[0]
    if not q.is_cuda or any(x.device != q.device for x in tensors):
        raise ValueError(f"{name}: inputs on {[str(x.device) for x in tensors]}")
    if q.dim() != 4 or any(x.shape != q.shape for x in tensors):
        raise ValueError(f"{name}: shapes {[tuple(x.shape) for x in tensors]}")
    if q.dtype not in _SUFFIX or any(x.dtype != q.dtype for x in tensors):
        raise ValueError(f"{name} takes bf16 or fp32, got {[x.dtype for x in tensors]}")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {q.shape[3]} > {MAX_HEAD_DIM}")
    if q.shape[0] * q.shape[2] > MAX_BATCH_HEADS:
        raise ValueError(f"{name}: batch x heads {q.shape[0] * q.shape[2]} > {MAX_BATCH_HEADS}")
    return tuple(q.shape), tuple(x.contiguous() for x in tensors)


def _check_lse(name, lse, shape):
    b, t, h, _ = shape
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, t):
        raise ValueError(f"{name}: lse must be fp32 {(b, h, t)}, got {lse.dtype} {tuple(lse.shape)}")
    return lse.contiguous()


def _launch(entry: str, dtype, pointers, shape, scale: float, clip_val: float) -> None:
    """Launch ``entry`` (with its dtype's suffix) on the current stream of
    the current device, which the caller sets to the tensors'."""
    lib = _build.load("flash_attention_clamped")
    fn = getattr(lib, entry + _SUFFIX[dtype])
    fn.argtypes = ([ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(*pointers, *shape, float(scale), float(clip_val),
             torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"{entry} kernel")


def _forward(q, k, v, scale, clip_val, with_lse: bool):
    shape, (q, k, v) = _check("flash_attention_clamped", q, k, v)
    out = torch.empty_like(q)
    b, t, h, _ = shape
    lse = torch.empty((b, h, t), device=q.device, dtype=torch.float32) if with_lse else None
    if out.numel():
        with torch.cuda.device(q.device):
            _launch("flash_attention_clamped_forward", q.dtype,
                    (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr() if with_lse else None), shape, scale, clip_val)
    return out, lse


def flash_attention_clamped(q, k, v, scale: float, clip_val: float = 10.0) -> torch.Tensor:
    """(B, T, H, D) bf16 or fp32 q/k/v -> (B, T, H, D) in the same dtype.

    With a gradient wanted, ``FlashAttentionClamped`` (K3 with lse, K4a,
    K4b). Otherwise a CUDA tensor goes through K3 without lse (or raises)
    and a CPU tensor through ``attention_clamped_plain``.
    ``flash_attention_clamped.launches`` counts K3's launches without lse.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionClamped.apply(q, k, v, scale, clip_val)
    if q.device.type == "cpu":
        return attention_clamped_plain(q, k, v, scale, clip_val)
    out, _ = _forward(q, k, v, scale, clip_val, with_lse=False)
    if out.numel():
        flash_attention_clamped.launches += 1
    return out


def flash_attention_clamped_fwd(q, k, v, scale: float, clip_val: float = 10.0):
    """K3 with lse: (o (B, T, H, D), lse (B, H, T) fp32).
    ``flash_attention_clamped_fwd.launches`` counts launches."""
    if q.device.type == "cpu":
        return attention_clamped_fwd_plain(q, k, v, scale, clip_val)
    out, lse = _forward(q, k, v, scale, clip_val, with_lse=True)
    if out.numel():
        flash_attention_clamped_fwd.launches += 1
    return out, lse


def flash_attention_clamped_dq(q, k, v, o, do, lse, scale: float, clip_val: float = 10.0):
    """K4a: dq (B, T, H, D) in q's dtype. ``flash_attention_clamped_dq.launches``
    counts launches."""
    if q.device.type == "cpu":
        return attention_clamped_bwd_plain(q, k, v, o, do, lse, scale, clip_val)[0]
    shape, (q, k, v, o, do) = _check("flash_attention_clamped_dq", q, k, v, o, do)
    lse = _check_lse("flash_attention_clamped_dq", lse, shape)
    dq = torch.empty_like(q)
    if dq.numel():
        with torch.cuda.device(q.device):
            _launch("flash_attention_clamped_backward_dq", q.dtype,
                    tuple(x.data_ptr() for x in (q, k, v, o, do, lse, dq)), shape, scale, clip_val)
        flash_attention_clamped_dq.launches += 1
    return dq


def flash_attention_clamped_dkv(q, k, v, o, do, lse, scale: float, clip_val: float = 10.0):
    """K4b: (dk, dv), each (B, T, H, D) in q's dtype. The launch runs a
    pre-pass that writes delta = rowsum(do * o) (``attention_delta_plain``)
    into scratch allocated here, then the kernel; both count as one launch in
    ``flash_attention_clamped_dkv.launches``."""
    if q.device.type == "cpu":
        return attention_clamped_bwd_plain(q, k, v, o, do, lse, scale, clip_val)[1:]
    shape, (q, k, v, o, do) = _check("flash_attention_clamped_dkv", q, k, v, o, do)
    lse = _check_lse("flash_attention_clamped_dkv", lse, shape)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel():
        delta = torch.empty_like(lse)
        with torch.cuda.device(q.device):
            _launch("flash_attention_clamped_backward_dkv", q.dtype,
                    tuple(x.data_ptr() for x in (q, k, v, o, do, lse, delta, dk, dv)), shape,
                    scale, clip_val)
        flash_attention_clamped_dkv.launches += 1
    return dk, dv


flash_attention_clamped.launches = 0
flash_attention_clamped_fwd.launches = 0
flash_attention_clamped_dq.launches = 0
flash_attention_clamped_dkv.launches = 0


class FlashAttentionClamped(torch.autograd.Function):
    """The differentiable clamped attention (the JAX package's ``_flash``
    custom VJP): K3 with lse forward, K4a and K4b backward; on CPU tensors
    their plain versions, which round where the Pallas kernels round (autograd
    through the materialized forward would not)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, clip_val):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_clamped_fwd(q, k, v, scale, clip_val)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.clip_val = scale, clip_val
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        args = (q, k, v, o, do, lse, ctx.scale, ctx.clip_val)
        dk, dv = flash_attention_clamped_dkv(*args)
        return flash_attention_clamped_dq(*args), dk, dv, None, None
