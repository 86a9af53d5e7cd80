"""Precision helpers shared by the frontend, the LSTM and the attention.

TF32: on a CUDA card PyTorch runs fp32 convolutions through cuDNN in TF32
by default (about three decimal digits). The mel frontend and every model
forward run under ``full_fp32()`` so that fp32 means fp32, as it does in the
JAX package (Precision.HIGHEST in the frontend, fp32 everywhere under
``compute_dtype="float32"``).
"""

from __future__ import annotations

import contextlib

import torch


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


class _TensorCoreMatmulF32(torch.autograd.Function):
    """bf16 ``a @ b`` on the card with an fp32 result (the tensor-core GEMM
    writes its fp32 accumulator). The backward is the JAX package's transpose
    of ``preferred_element_type=float32``, and the same as autograd through
    the CPU path's widened product: the fp32 gradient times the other operand
    widened to fp32, in full fp32, rounded to the operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad_a = grad_b = None
        with full_fp32():
            if ctx.needs_input_grad[0]:
                grad_a = torch.matmul(grad, b.float().transpose(-1, -2)).to(a.dtype)
            if ctx.needs_input_grad[1]:
                grad_b = torch.matmul(a.float().transpose(-1, -2), grad).to(b.dtype)
        return grad_a, grad_b


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D, or 3-D batched) with fp32 accumulation and an fp32
    result: the JAX package's ``preferred_element_type=float32``.

    For bf16 operands the products of two bf16 values are exact in fp32, so
    on the CPU the operands are widened and multiplied in fp32; on a CUDA
    card the bf16 tensor-core GEMM writes its fp32 accumulator directly.
    """
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        return _TensorCoreMatmulF32.apply(a, b)
    return torch.matmul(a.float(), b.float())
