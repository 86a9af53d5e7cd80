"""Precision helpers shared by the frontend, the LSTM and the attention.

TF32: on a CUDA card PyTorch runs fp32 convolutions through cuDNN in TF32
by default (about three decimal digits). The mel frontend and every model
forward run under ``full_fp32()`` so that fp32 means fp32, as it does in the
JAX package (Precision.HIGHEST in the frontend, fp32 everywhere under
``compute_dtype="float32"``).

bf16 products with an fp32 result (``matmul_f32``) run on the tensor cores
both ways. Their backward multiplies the fp32 gradient by a bf16 operand:
``split_bf16`` cuts the gradient exactly into three bf16 terms, so the
backward's products are bf16 tensor-core GEMMs of exact fp32 products,
accumulated in fp32 (``split_backward``), not TF32 and not a gradient
rounded to bf16.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from music_transcription_tpu_torch.ops import _build


@contextlib.contextmanager
def full_fp32():
    """Run fp32 matmuls and convolutions in full fp32, not TF32; restore the
    caller's settings on exit."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


# The hi terms (see ``split_bf16``) that one tensor-core accumulator sums in
# ``split_backward``: a run. The H100's tensor cores add into their fp32
# accumulator with less care than an fp32 FMA rounds, so their largest error
# grows about with the run's length, the CUDA cores' fp32 GEMM's more slowly;
# and that GEMM errs less on narrower products (against an fp64 product at
# M = 22,512 rows: 3.1e-06 at I x N = 10,240 x 2,048, 5.8e-07 at 512 x
# 1,024). Unbroken, a projection's dW errs 6-14x as much as the fp32 GEMM.
# So a run is as long as the gradient's padded width W, kept within
# [RUN_MIN, RUN_MAX]: the (M / W) x I x W fp32 partial sums of the batched
# product then take no more memory than the fp32 widening of ``a`` (4 M I
# bytes) that the fp32 backward makes.
RUN_MIN, RUN_MAX = 512, 2048
ALIGN = 8  # bf16 columns a 16-byte load: each block of the split is padded to a multiple


def accumulation_run(w: int) -> int:
    """The hi terms one accumulator sums, for a gradient padded to ``w``
    columns (the comment above ``RUN_MIN``)."""
    return min(max(w, RUN_MIN), RUN_MAX)


def _top_half(x: torch.Tensor) -> torch.Tensor:
    """A contiguous fp32 tensor's upper 16 bits a value, as a strided bf16
    view: each value rounded toward zero to bf16 (little-endian, as x86 and
    the card store it)."""
    return x.view(torch.int16)[..., 1::2].view(torch.bfloat16)


def split_bf16_plain(g: torch.Tensor, width: int | None = None) -> torch.Tensor:
    """``split_bf16``'s plain version, in tensor operations: the CPU's path,
    and what the kernel is held to on the card."""
    g = g.contiguous()
    n = g.shape[-1]
    w = n if width is None else width
    parts = torch.zeros((*g.shape[:-1], 3 * w), dtype=torch.bfloat16, device=g.device)
    lo, mid, hi = (parts[..., i * w:i * w + n] for i in range(3))
    hi.copy_(_top_half(g))
    rest = g - hi
    mid.copy_(_top_half(rest))
    lo.copy_(rest.sub_(mid))
    return parts


def split_bf16(g: torch.Tensor, width: int | None = None) -> torch.Tensor:
    """fp32 (..., M, N) -> bf16 (..., M, 3W), the terms [lo | mid | hi] with
    hi + mid + lo == g, each block ``width`` (W >= N, N by default) columns
    wide and zero past its first N.

    hi is g rounded toward zero to bf16 (its upper 16 bits, so a finite g
    never gives an infinite hi), mid the same of g - hi, lo the rest. Each
    subtraction is exact in fp32 and each term keeps 8 of g's 24 significant
    bits, so the sum is g bit for bit, for every finite g whose lowest bit
    bf16 can hold: |g| from about 2^-110 up to fp32's largest value (below
    that, lo rounds at bf16's least subnormal, 2^-133). A NaN or an infinity
    in g gives NaN terms. The smallest term comes first, so that a product
    over the three sums it first.

    A CUDA tensor goes through the kernel (``csrc/split_bf16.cu``: one pass,
    4 bytes read and 6 written an element), a CPU tensor through
    ``split_bf16_plain``. ``split_bf16.launches`` counts launches."""
    if not g.is_cuda:
        return split_bf16_plain(g, width)
    if g.dtype != torch.float32:
        raise ValueError(f"split_bf16 takes fp32, got {g.dtype}")
    g = g.contiguous()
    n = g.shape[-1]
    w = n if width is None else width
    parts = torch.empty((*g.shape[:-1], 3 * w), dtype=torch.bfloat16, device=g.device)
    lib = _build.load("split_bf16")
    fn = lib.split_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(g.device):
        err = fn(g.data_ptr(), parts.data_ptr(), g.numel() // max(n, 1), n, w,
                 torch.cuda.current_stream().cuda_stream)
    if err == -1:
        raise ValueError(f"split_bf16: width {w} under the gradient's {n} columns")
    _build.check(lib, err, "split_bf16 kernel")
    split_bf16.launches += 1
    return parts


split_bf16.launches = 0


def _tensor_core_product(x: torch.Tensor, y: torch.Tensor, acc: torch.Tensor | None = None):
    """bf16 ``x @ y`` (2-D, or 3-D batched) as a tensor-core GEMM writing its
    fp32 accumulator, added to the fp32 ``acc`` where one is given (the
    GEMM's epilogue adds it in fp32)."""
    if acc is None:
        return (torch.mm if x.dim() == 2 else torch.bmm)(x, y, out_dtype=torch.float32)
    return (torch.addmm if x.dim() == 2 else torch.baddbmm)(acc, x, y, out_dtype=torch.float32)


def split_backward(a, b, grad, needs=(True, True), product=_tensor_core_product):
    """The fp32 gradients (grad_a, grad_b) of the fp32 ``a @ b`` for bf16
    ``a`` (..., M, K) and ``b`` (..., K, N) and the fp32 ``grad`` (..., M, N):
    ``grad @ b^T`` and ``a^T @ grad``, each None where ``needs`` says so.

    The gradient is split once (``split_bf16``) into [lo | mid | hi]
    (..., M, 3W), each block N columns padded with zeros to W, a multiple of
    ``ALIGN``, and shared. grad_b sums ``a^T @ hi`` in runs of rows
    (``accumulation_run``): one batched product over the whole runs, its
    partial sums added in fp32, the rest of the rows added on in a GEMM's
    epilogue; then ``a^T @ [lo | mid]`` with its two column blocks summed.
    grad_a is one product over a contraction of 3W against b^T three times
    over (zero rows in the pads), cut after a run of hi terms where W is
    longer than one. Every product of two bf16 values is exact in fp32, and
    so is the split; what differs from the fp32 product is how the sums are
    accumulated, on the card in the tensor cores' fp32 adds. Against an fp64
    product the largest error stays within 2x the fp32 GEMM's at the shapes
    that tests/test_torch_gpu.py measures (PERF.md), not at every shape.
    ``product(x, y, acc)`` multiplies two bf16 operands into fp32 and adds
    ``acc``: the tensor cores on the card; the tests pass a widened fp32
    product."""
    n, m, k = grad.shape[-1], grad.shape[-2], a.shape[-1]
    w = -(-n // ALIGN) * ALIGN
    run = accumulation_run(w)
    parts = split_bf16(grad, w)
    grad_a = grad_b = None
    if needs[1]:
        at, hi = a.transpose(-1, -2), parts[..., 2 * w:]
        whole = m // run
        if whole:  # (..., runs, K, run) @ (..., runs, run, W), batched over the runs
            ar = at[..., :whole * run].unflatten(-1, (whole, run)).transpose(-3, -2)
            hr = hi[..., :whole * run, :].unflatten(-2, (whole, run))
            grad_b = product(ar.reshape(-1, k, run), hr.reshape(-1, run, w)) \
                .view(*hi.shape[:-2], whole, k, w).sum(-3)
        if m > whole * run:
            grad_b = product(at[..., whole * run:], hi[..., whole * run:, :], grad_b)
        grad_b = (grad_b + product(at, parts[..., :2 * w]).unflatten(-1, (2, w)).sum(-2))[..., :n]
    if needs[0]:
        # b^T three times over with zero rows in the pads, copied along b's own layout
        bt = b.transpose(-1, -2)
        dim, src = (-2, bt) if bt.is_contiguous() else (-1, b)
        pad = list(src.shape)
        pad[dim] = w - n
        b3t = torch.cat([src, src.new_zeros(pad)] * 3 if w != n else [src] * 3, dim=dim)
        if dim == -1:
            b3t = b3t.transpose(-1, -2)
        cuts = [0, *range(2 * w + run, 3 * w, run), 3 * w]
        for c0, c1 in zip(cuts, cuts[1:]):
            grad_a = product(parts[..., c0:c1], b3t[..., c0:c1, :], grad_a)
    return grad_a, grad_b


def fp32_backward(a, b, grad, needs=(True, True)):
    """(grad_a, grad_b) of the fp32 ``a @ b`` as autograd through the widened
    product takes them: the fp32 gradient times the other operand widened to
    fp32, in full fp32 (the CUDA cores' GEMM on the card). The reference the
    tests hold ``split_backward`` to."""
    grad_a = grad_b = None
    with full_fp32():
        if needs[0]:
            grad_a = torch.matmul(grad, b.float().transpose(-1, -2))
        if needs[1]:
            grad_b = torch.matmul(a.float().transpose(-1, -2), grad)
    return grad_a, grad_b


class _TensorCoreMatmulF32(torch.autograd.Function):
    """bf16 ``a @ b`` on the card with an fp32 result (the tensor-core GEMM
    writes its fp32 accumulator). The backward is the JAX package's transpose
    of ``preferred_element_type=float32``: the fp32 gradient times the other
    operand, rounded to the operand's dtype, on the tensor cores over the
    gradient's exact three-term split (``split_backward``). It takes bf16
    operands alone: the models' narrow dtype (``compute_dtype`` is bf16 or
    fp32, and fp32 operands never reach it); fp16's narrow exponent range
    could not hold the split. ``matmul_f32.split_backwards`` counts the
    backwards."""

    @staticmethod
    def forward(ctx, a, b):
        if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
            raise TypeError(f"matmul_f32 on the card takes bf16 or fp32 operands, got "
                            f"{a.dtype} and {b.dtype}")
        ctx.save_for_backward(a, b)
        return _tensor_core_product(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        matmul_f32.split_backwards += 1
        grad_a, grad_b = split_backward(a, b, grad, ctx.needs_input_grad[:2], _tensor_core_product)
        return (None if grad_a is None else grad_a.to(a.dtype),
                None if grad_b is None else grad_b.to(b.dtype))


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D, or 3-D batched) with fp32 accumulation and an fp32
    result: the JAX package's ``preferred_element_type=float32``.

    For bf16 operands the products of two bf16 values are exact in fp32, so
    on the CPU the operands are widened and multiplied in fp32; on a CUDA
    card the bf16 tensor-core GEMM writes its fp32 accumulator directly, and
    the backward's products run on the tensor cores too
    (``_TensorCoreMatmulF32``, which takes bf16 alone).
    """
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        return _TensorCoreMatmulF32.apply(a, b)
    return torch.matmul(a.float(), b.float())


matmul_f32.split_backwards = 0
