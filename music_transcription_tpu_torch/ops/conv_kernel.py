"""Fused inference ConvBNRelu [+ (2, 1) max-pool over frequency]: K5.

Port of ``fused_conv_bn_relu`` / ``_conv_bn_kernel`` in the JAX package's
``ops/conv_pallas.py``: a SAME kh x kw convolution of bf16 inputs and bf16
weights with fp32 accumulation, the conv bias added in fp32 and the sum
rounded to bf16 once, the BatchNorm running-statistics affine ``h * s + o``
in fp32 (``s = g / sqrt(var + 1e-5)``, ``o = b - mean * s``), ReLU, bf16,
then the max over row pairs (2f, 2f + 1) when ``pool`` is set. Those are the
Pallas kernel's rounding points, not the flax module's: the module (and the
port model's ``_conv``) rounds the product to bf16 before adding the bias in
bf16, and the port model's ``_bn`` applies ``(x - mean) * (rsqrt * g) + b``.

Layouts are the port's: x (B, C_in, F, T) NCHW, the weight in torch's
(C_out, C_in, kh, kw); the output is (B, C_out, F[/2], T) bf16. The Pallas
kernel's NHWC input and (kh, kw, C_in, C_out) kernel, and its TPU-only
``f_blk`` and ``interpret`` arguments, are not taken.

``fused_conv_bn_relu`` launches the hand-written CUDA kernel
(``csrc/conv_bn_relu.cu``) for a CUDA tensor and takes its plain version only
for a CPU tensor. Neither package wires K5 into its model: the model keeps
its own convolution and BatchNorm, and ``conv_bn_relu_stage`` runs one of the
model's ConvBNRelu stages through K5 on the model's own modules.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from music_transcription_tpu_torch.ops import _build
from music_transcription_tpu_torch.ops.precision import full_fp32

BN_EPS = 1e-5
# K5 against its plain version, element by element (``k5_score``):
#   |got - ref| <= 2^-7 |ref| + |s_c| (2^-7 |h| + 2 n 2^-23 m),
# h = bf16(acc + bias) the plain version's value before the affine, m the
# same convolution over magnitudes (|x| * |w| + |bias|), n = C_in kh kw the
# terms of a sum, s_c the channel's BN factor g / sqrt(var + eps); with pool
# h and m are the larger of the pair's. Both versions sum the exact products
# of bf16 values in fp32, in different orders: each sum is within n 2^-23 m
# of the exact one (2^-23, not 2^-24: tensor-core accumulators may truncate),
# so the two within 2 n 2^-23 m. Where they straddle a rounding boundary
# bf16(acc + bias) comes out one bf16 unit apart, at most 2^-7 |h|; the
# affine scales both by |s_c| (its fp32 rounding is far below these terms).
# Both round the output to bf16, one unit apart at most where the values
# before it straddle a boundary: 2^-7 |ref|. ReLU and the max of a pair move
# no two values further apart.
K5_TOL = 2.0**-7
# The inference CNN front end with both ConvBNRelu stages through K5 against
# the model's own (which adds the bias in bf16 after rounding the product,
# and applies the affine in another order): each stage may put an element a
# bf16 unit or two (2^-7 relative) apart, and the residual blocks and the 7x3
# conv carry such differences on as sums over many terms of either sign; at
# the 89M widths they come out near 2^-8 of the largest feature and 2^-10 of
# the rms, on the CPU at T=40 and on the card at T=938.
FRONT_END_TOL = {"max": 2.0**-5, "rms": 2.0**-7}


def _check_rows(f: int, pool: bool) -> None:
    """The JAX kernel's frequency-grid condition, with its error."""
    if f % 2 or (pool and f % 4):
        raise ValueError(f"F={f} must be divisible by 2 (by 4 with pool) for the blocked "
                         f"frequency grid")


def bn_affine(bn_scale, bn_bias, bn_mean, bn_var):
    """BN inference affine in fp32: (s, o) with s = g / sqrt(var + eps),
    o = b - mean * s, as ``_affine_params``."""
    s = bn_scale.float() / torch.sqrt(bn_var.float() + BN_EPS)
    return s, bn_bias.float() - bn_mean.float() * s


def same_pad(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """SAME zero padding of (B, C, F, T): kh // 2 rows and kw // 2 columns
    before, the rest after (the JAX kernel's windows)."""
    return F.pad(x, (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2))


def _padded(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """x's bf16 values in fp32, SAME-padded."""
    return same_pad(x.to(torch.bfloat16).float(), kh, kw)


def _pre_affine(xp, weight, conv_bias) -> torch.Tensor:
    """bf16(conv + bias) in fp32: the convolution of the padded ``xp`` sums
    the exact products of the bf16 values in fp32 (no TF32)."""
    with full_fp32():
        acc = F.conv2d(xp, weight.to(torch.bfloat16).float())
    return (acc + conv_bias.float().view(1, -1, 1, 1)).to(torch.bfloat16).float()


def _bn_relu_pool(h, bn_scale, bn_bias, bn_mean, bn_var, pool: bool) -> torch.Tensor:
    """The affine, ReLU and bf16 of K5's epilogue, then the (2, 1) max-pool."""
    s, o = bn_affine(bn_scale, bn_bias, bn_mean, bn_var)
    h = torch.relu(h * s.view(1, -1, 1, 1) + o.view(1, -1, 1, 1)).to(torch.bfloat16)
    return F.max_pool2d(h.float(), (2, 1)).to(torch.bfloat16) if pool else h


def fused_conv_bn_relu_plain(x, weight, conv_bias, bn_scale, bn_bias, bn_mean, bn_var, *,
                             pool: bool = False) -> torch.Tensor:
    """K5's plain version: (B, C_in, F, T) x and (C_out, C_in, kh, kw)
    weight -> (B, C_out, F[/2], T) bf16, rounded where the Pallas kernel
    rounds."""
    _check_rows(x.shape[2], pool)
    h = _pre_affine(_padded(x, *weight.shape[2:]), weight, conv_bias)
    return _bn_relu_pool(h, bn_scale, bn_bias, bn_mean, bn_var, pool)


def k5_score(got, ref, args, *, pool: bool) -> float:
    """Largest |got - ref| over its bound (``K5_TOL``) for K5 on ``args``
    (x, weight, conv bias, BN scale, bias, mean, variance) against
    ``ref = fused_conv_bn_relu_plain(*args, pool=pool)``: <= 1 passes."""
    x, weight, conv_bias = args[:3]
    kh, kw = weight.shape[2:]
    xp = _padded(x, kh, kw)
    h = _pre_affine(xp, weight, conv_bias).abs_()
    with full_fp32():
        m = F.conv2d(xp.abs_(), weight.to(torch.bfloat16).float().abs())
    m += conv_bias.float().abs().view(1, -1, 1, 1)
    if pool:
        h, m = F.max_pool2d(h, (2, 1)), F.max_pool2d(m, (2, 1))
    s = bn_affine(*args[3:])[0].abs().view(1, -1, 1, 1)
    terms = x.shape[1] * kh * kw
    bound = K5_TOL * ref.float().abs() + s * (K5_TOL * h + 2 * terms * 2.0**-23 * m)
    err = (got.float() - ref.float()).abs()
    return float(torch.where(err == 0, torch.zeros_like(err), err / bound).max())


def faulty_plain(args, fault: str, *, pool: bool) -> torch.Tensor:
    """What K5 on ``args`` would give with one of three mistakes, from its
    plain version: ``halo_no_zero_fill`` reads the bottom halo rows past F
    from the top of the plane instead of zeros; ``shifted_pool_pair`` pools
    the rows (2f + 1, 2f + 2) (the last pair (F - 1, F - 1)); and
    ``one_tap_of_a_chunk_dropped`` leaves out the last tap (kh - 1, kw - 1)
    of the last 16 input channels. For showing that ``k5_score``'s bound
    catches such mistakes (``FAULTS``)."""
    x, weight, conv_bias, *bn = args
    kh, kw = weight.shape[2:]
    if fault == "shifted_pool_pair":
        y = fused_conv_bn_relu_plain(*args, pool=False).float()
        y = torch.cat([y[:, :, 1:], y[:, :, -1:]], dim=2)
        return F.max_pool2d(y, (2, 1)).to(torch.bfloat16) if pool else y.to(torch.bfloat16)
    xp = _padded(x, kh, kw)
    if fault == "halo_no_zero_fill":
        below = kh - 1 - kh // 2  # padding rows after the last row: x's first rows instead
        xp[:, :, xp.shape[2] - below:] = xp[:, :, kh // 2: kh // 2 + below]
    elif fault == "one_tap_of_a_chunk_dropped":
        weight = weight.clone()
        weight[:, -16:, kh - 1, kw - 1] = 0
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return _bn_relu_pool(_pre_affine(xp, weight, conv_bias), *bn, pool)


FAULTS = ("halo_no_zero_fill", "shifted_pool_pair", "one_tap_of_a_chunk_dropped")


def _launch(x, weight, conv_bias, bn_scale, bn_bias, bn_mean, bn_var, pool: bool) -> torch.Tensor:
    """Check the inputs and launch K5 on the current stream of x's device;
    returns the output."""
    tensors = (x, weight, conv_bias, bn_scale, bn_bias, bn_mean, bn_var)
    if not x.is_cuda or any(t.device != x.device for t in tensors):
        raise ValueError(f"fused_conv_bn_relu: inputs on {[str(t.device) for t in tensors]}")
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[1] != x.shape[1]:
        raise ValueError(f"fused_conv_bn_relu: x {tuple(x.shape)}, weight {tuple(weight.shape)}")
    b, c_in, f, t = x.shape
    c_out, _, kh, kw = weight.shape
    if any(tuple(v.shape) != (c_out,) for v in tensors[2:]):
        raise ValueError(f"fused_conv_bn_relu: per-channel vectors must be ({c_out},), got "
                         f"{[tuple(v.shape) for v in tensors[2:]]}")
    if not all(t.is_floating_point() for t in tensors):
        raise ValueError(f"fused_conv_bn_relu takes floating inputs, got {[t.dtype for t in tensors]}")
    _check_rows(f, pool)
    xb = x.to(torch.bfloat16).contiguous()
    wk = weight.to(torch.bfloat16).permute(2, 3, 0, 1).contiguous()  # (kh, kw, C_out, C_in)
    bias = conv_bias.float().contiguous()
    s, o = (v.contiguous() for v in bn_affine(bn_scale, bn_bias, bn_mean, bn_var))
    out = torch.empty((b, c_out, f // 2 if pool else f, t), device=x.device, dtype=torch.bfloat16)
    args = (xb, wk, bias, s, o, out)
    if not all(a.is_contiguous() for a in args):
        raise ValueError("fused_conv_bn_relu: an input is not contiguous")
    if out.numel():
        lib, fn = _entry()
        with torch.cuda.device(x.device):
            err = fn(*(a.data_ptr() for a in args), b, c_in, c_out, f, t, kh, kw, int(pool),
                     torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "conv_bn_relu_forward kernel")
    return out


@functools.cache
def _entry():
    """The library and its launch function, typed once."""
    lib = _build.load("conv_bn_relu")
    fn = lib.conv_bn_relu_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def fused_conv_bn_relu(x, weight, conv_bias, bn_scale, bn_bias, bn_mean, bn_var, *,
                       pool: bool = False) -> torch.Tensor:
    """Fused Conv(SAME) + BN(inference) + ReLU [+ maxpool(2, 1)]: (B, C_in,
    F, T) x, (C_out, C_in, kh, kw) weight, (C_out,) conv bias and BN scale,
    bias, running mean and variance -> (B, C_out, F[/2], T) bf16.

    A CUDA tensor goes through K5 (or raises); a CPU tensor through
    ``fused_conv_bn_relu_plain``. ``fused_conv_bn_relu.launches`` counts
    K5's launches."""
    if x.device.type == "cpu":
        return fused_conv_bn_relu_plain(x, weight, conv_bias, bn_scale, bn_bias, bn_mean,
                                        bn_var, pool=pool)
    out = _launch(x, weight, conv_bias, bn_scale, bn_bias, bn_mean, bn_var, pool)
    if out.numel():
        fused_conv_bn_relu.launches += 1
    return out


fused_conv_bn_relu.launches = 0


def conv_bn_relu_stage(x, conv: torch.nn.Conv2d, bn: torch.nn.BatchNorm2d, *,
                       pool: bool) -> torch.Tensor:
    """One ConvBNRelu stage of a port model (e.g. ``model.conv1[0],
    model.conv1[1]``) through ``fused_conv_bn_relu``, with the BatchNorm's
    running statistics (K5 is an inference kernel)."""
    kh, kw = conv.kernel_size
    if conv.stride != (1, 1) or conv.padding != (kh // 2, kw // 2) or bn.eps != BN_EPS:
        raise ValueError(f"not a SAME stride-1 ConvBNRelu stage: {conv}, {bn}")
    with torch.no_grad():
        return fused_conv_bn_relu(x, conv.weight, conv.bias, bn.weight, bn.bias,
                                  bn.running_mean, bn.running_var, pool=pool)
