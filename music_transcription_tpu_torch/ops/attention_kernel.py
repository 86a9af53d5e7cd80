"""K3: clamped flash attention, forward only.

Port of ``flash_attention_clamped`` / ``_fwd_call`` / ``_flash_kernel`` in
the JAX package's ``ops/attention_pallas.py``: per (batch, head),
``softmax(clip(q @ k^T * scale, -clip, clip)) @ v``, with q, k, v laid out
(B, T, H, D) as the model produces them.

``flash_attention_clamped`` launches the hand-written CUDA kernel
(``csrc/flash_attention_clamped.cu``) for a CUDA tensor and takes the plain
version only for a CPU tensor. The plain version is the arithmetic of the
model's materialized-scores ("xla") branch: fp32 scores from compute-dtype
q and k, the clamp, an fp32 softmax, probabilities cast to the compute dtype
before ``@ v`` with fp32 accumulation.

The kernel has no backward yet (K4a/K4b, ``_flash_bwd`` in the JAX
package): with a gradient wanted on a CUDA tensor the wrapper raises rather
than return an output that gradients cannot flow through.
"""

from __future__ import annotations

import ctypes

import torch

from music_transcription_tpu_torch.ops import _build
from music_transcription_tpu_torch.ops.precision import matmul_f32

MAX_HEAD_DIM = 256  # the kernel's shared-memory tiles hold head_dim <= 256
# the library's launch function for each input dtype
_ENTRY = {torch.bfloat16: "flash_attention_clamped_forward",
          torch.float32: "flash_attention_clamped_forward_f32"}


def attention_clamped_plain(q, k, v, scale: float, clip_val: float = 10.0,
                            prob_dropout=None) -> torch.Tensor:
    """(B, T, H, D) q and (B, S, H, D) k/v -> (B, T, H, D) in q's dtype,
    scores materialized. ``prob_dropout``, a function of the fp32
    probabilities, is the model's attention dropout in training."""
    b, t, h, d = q.shape

    def heads(x):  # (B, T, H, D) -> (B*H, T, D)
        return x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], d)

    qh, kh, vh = heads(q), heads(k), heads(v)
    s = matmul_f32(qh, kh.transpose(1, 2)) * scale
    p = torch.softmax(torch.clamp(s, -clip_val, clip_val), dim=-1)
    if prob_dropout is not None:
        p = prob_dropout(p)
    out = matmul_f32(p.to(v.dtype), vh)
    return out.view(b, h, t, d).permute(0, 2, 1, 3).to(q.dtype)


def flash_attention_clamped(q, k, v, scale: float, clip_val: float = 10.0) -> torch.Tensor:
    """(B, T, H, D) bf16 or fp32 q/k/v -> (B, T, H, D) in the same dtype.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor through
    ``attention_clamped_plain``. ``flash_attention_clamped.launches`` counts
    launches.
    """
    if q.device.type == "cpu":
        return attention_clamped_plain(q, k, v, scale, clip_val)
    if not q.is_cuda or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_clamped: q/k/v on {q.device}, {k.device}, {v.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "flash_attention_clamped has no backward kernel yet (K4a/K4b come with the "
            "next slice of the port, training with attention_backend='pallas'); train "
            "with attention_backend='xla'")
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"flash_attention_clamped: shapes {q.shape}, {k.shape}, {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ENTRY:
        raise ValueError(f"flash_attention_clamped takes bf16 or fp32, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    b, t, h, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_clamped: head_dim {d} > {MAX_HEAD_DIM}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("flash_attention_clamped")
    fn = getattr(lib, _ENTRY[q.dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, t, h, d, float(scale), float(clip_val), stream)
    _build.check(lib, err, "flash_attention_clamped kernel")
    flash_attention_clamped.launches += 1
    return out


flash_attention_clamped.launches = 0
