"""Fused inference conv kernels: K5 (ConvBNRelu [+ (2, 1) max-pool over
frequency]) and K6 (a whole ResidualBlock [+ the same pool]).

K5 ports ``fused_conv_bn_relu`` / ``_conv_bn_kernel`` in the JAX package's
``ops/conv_pallas.py``: a SAME kh x kw convolution of bf16 inputs and bf16
weights with fp32 accumulation, the conv bias added in fp32 and the sum
rounded to bf16 once, the BatchNorm running-statistics affine ``h * s + o``
in fp32 (``s = g / sqrt(var + 1e-5)``, ``o = b - mean * s``), ReLU, bf16,
then the max over row pairs (2f, 2f + 1) when ``pool`` is set. Those are the
Pallas kernel's rounding points, not the flax module's: the module (and the
port model's ``_conv``) rounds the product to bf16 before adding the bias in
bf16, and the port model's ``_bn`` applies ``(x - mean) * (rsqrt * g) + b``.

K6 ports ``fused_res_block`` / ``_res_block_kernel`` of the same file, at
the same rounding points: h1 = bf16(relu(bf16(conv3x3(x) + b1) s1 + o1)),
zero outside the tensor; h2 = bf16(conv3x3(h1) + b2) s2 + o2 in fp32; the
skip bf16(conv1x1(x) + bs) ss + os, or x itself (C_in == C_out, no skip
conv); out = bf16(relu(h2 + skip)), then the pool.

Layouts are the port's: x (B, C_in, F, T) NCHW, weights in torch's
(C_out, C_in, kh, kw); the output is (B, C_out, F[/2], T) bf16. The Pallas
kernels' NHWC input and (kh, kw, C_in, C_out) kernels, and their TPU-only
``f_blk`` and ``interpret`` arguments, are not taken.

``fused_conv_bn_relu`` and ``fused_res_block`` launch the hand-written CUDA
kernels (``csrc/conv_bn_relu.cu``, ``csrc/res_block.cu``) for a CUDA tensor
and take their plain versions only for a CPU tensor. Neither package wires
K5 or K6 into its model: the model keeps its own convolutions and
BatchNorms, and ``conv_bn_relu_stage`` / ``res_block_stage`` run one of the
model's stages through the kernel on the model's own modules.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
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
# The inference CNN front end with both ConvBNRelu stages through K5, and
# with both residual blocks through K6 too, against the model's own (which
# adds the bias in bf16 after rounding the product, and applies the affine
# in another order): each stage may put an element a bf16 unit or two (2^-7
# relative) apart, and the later stages carry such differences on as sums
# over many terms of either sign; at the 89M widths they come out near 2^-8
# of the largest feature and 2^-10 of the rms, through K5 alone and through
# K5 and K6 (on the CPU at T=40: 4.9e-3 and 1.19e-3), so one tolerance
# serves both.
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


# K5's plan (csrc/conv_bn_relu.cu segment_rows, make_plan). C_in >= 16 (or
# weights that do not fit the CUDA-core kernel's shared memory) takes the
# walk on the tensor cores: a block walks a strip of 64 output columns down a
# segment of rows, 4 rows a step; the segment height makes strips x B x
# segments fill the SMs, at least 8 rows, a multiple of 4 (or F). Shared
# memory: the x ring of every 16-channel input chunk, KH + 3 rows of 64 + KW
# - 1 pixels, bf16; the affines of every 64-channel output group (a float4
# per channel); each rounded up to 1 KiB; 1 KiB of alignment slack and two
# barriers a chunk; and at least one weight stage (7 taps, 3 for a 3x3
# filter, 1 for one whose taps are no multiple of 7 or 3; x 64 output
# channels x 16 input channels) with its two barriers. A step streams every
# stage of every group and chunk from L2 once.
K5_SMEM_LIMIT = 232448
K5_STRIP = 64
K5_STEP = 4
K5_MIN_SEGMENT_ROWS = 8
H100_SMS = 132
# the CUDA-core kernel (C_in < 16): blocks of 128 threads, 3 an SM at most,
# each thread 8 outputs a store; in conv1's case a thread's chunk of 8
# outputs of 16 channels shares one input window (two across a row end)
K5_CC_THREADS = 128
K5_CC_BLOCKS_PER_SM = 3
K5_CC_CHANNELS = 16


def _kib(n: int) -> int:
    return -(-n // 1024) * 1024


def _k5_tensor_cores(c_in: int, c_out: int, kh: int, kw: int) -> bool:
    """Whether K5 takes the walk on the tensor cores (else the CUDA-core
    chunks, whose weights and affines sit in shared memory)."""
    return c_in >= 16 or 16 * c_out + 4 * c_out * c_in * kh * kw > K5_SMEM_LIMIT


def _k5_stage_taps(kh: int, kw: int) -> tuple[int, int]:
    """Taps of a weight stage of K5's walk (7, 3 or 1: a divisor of the
    filter's taps) and stages a chunk."""
    taps = kh * kw
    spt = 7 if taps % 7 == 0 else 3 if taps % 3 == 0 else 1
    return spt, taps // spt


def _k5_smem_bytes(c_in: int, c_out: int, kh: int, kw: int) -> int:
    """The least shared memory K5's walk runs in: the x ring, the affines,
    the barriers and one weight stage."""
    nk, g = -(-c_in // 16), -(-c_out // 64)
    ring = _kib(nk * (kh + K5_STEP - 1) * (K5_STRIP + kw - 1) * 32)
    return 1024 + ring + _kib(16 * 64 * g) + 16 * nk + _k5_stage_taps(kh, kw)[0] * 64 * 32 + 16


def k5_segment_rows(b: int, f: int, t: int, sms: int = H100_SMS) -> int:
    """Output rows of a segment of K5's walk at (B, F, T) on a card of
    ``sms`` SMs (the kernel's ``segment_rows``)."""
    units = -(-t // K5_STRIP) * b
    nseg = 1 if units >= sms else sms // units
    rows = -(-f // nseg)
    rows = max(-(-rows // K5_STEP) * K5_STEP, K5_MIN_SEGMENT_ROWS)
    return min(rows, f)


def k5_traffic(b, c_in, c_out, f, t, kh, kw, pool: bool, sms: int = H100_SMS) -> dict:
    """What K5 reads at this shape (bf16 x): ``weights_l2``, the weight
    bytes its blocks read from L2 (the walk: every stage of a step once a
    step; the CUDA-core kernel: the fp32 weights once a block);
    ``x_gathered``, the x bytes it gathers into its rings or registers
    (zeros outside the tensor counted); ``x_bytes``, the input's size."""
    taps = kh * kw
    x_bytes = 2 * b * c_in * f * t
    if _k5_tensor_cores(c_in, c_out, kh, kw):
        seg = k5_segment_rows(b, f, t, sms)
        steps = [-(-min(seg, f - f0) // K5_STEP) for f0 in range(0, f, seg)]
        strips = b * -(-t // K5_STRIP)
        per_step = -(-c_out // 64) * -(-c_in // 16) * taps * 64 * 32
        rows = sum(K5_STEP * s + kh - 1 for s in steps)
        return {"weights_l2": strips * sum(steps) * per_step,
                "x_gathered": strips * rows * (K5_STRIP + kw - 1) * c_in * 2, "x_bytes": x_bytes}
    plane = (f // 2 if pool else f) * t
    if c_in == 1 and kh == kw == 3 and t >= 8 and plane % 8 == 0:  # windows of a chunk
        starts = np.arange(0, plane, 8) % t
        groups = -(-c_out // K5_CC_CHANNELS)
        windows = b * groups * (len(starts) + int((starts > t - 8).sum()))
        units, gathered = b * groups * plane // 8, windows * 4 * 10 * 2
    else:  # element by element
        units = -(-b * c_out * plane // 8)
        gathered = b * c_out * plane * c_in * taps * (2 if pool else 1) * 2
    blocks = min(-(-units // K5_CC_THREADS), K5_CC_BLOCKS_PER_SM * sms)
    return {"weights_l2": blocks * 4 * c_out * c_in * taps, "x_gathered": gathered,
            "x_bytes": x_bytes}


def _k5_walk_fault(xp, weight, conv_bias, h, seg_rows: int, fault: str):
    """The walk's bf16(conv + bias) ``h`` (from the SAME-padded ``xp``) as
    segments of ``seg_rows`` output rows would give it with ``fault``.
    ``x_row_ring_off_by_one_step``: the second step of each segment reads
    the x rows of the first (its 4 rows repeat the first 4).
    ``segment_border_halo_zeros``: each segment sees zeros for the x rows
    past its borders that lie inside the tensor."""
    kh = weight.shape[2]
    f = h.shape[2]
    h = h.clone()
    for f0 in range(0, f, seg_rows):
        f1 = min(f0 + seg_rows, f)
        if fault == "x_row_ring_off_by_one_step":
            if f1 - f0 >= 2 * K5_STEP:
                h[:, :, f0 + K5_STEP:f0 + 2 * K5_STEP] = h[:, :, f0:f0 + K5_STEP].clone()
        elif fault == "segment_border_halo_zeros":
            xs = xp[:, :, f0:f1 + kh - 1].clone()  # padded rows of x rows f0 - kh // 2 ..
            xs[:, :, :kh // 2] = 0
            xs[:, :, kh // 2 + f1 - f0:] = 0
            h[:, :, f0:f1] = _pre_affine(xs, weight, conv_bias)
        else:
            raise ValueError(f"unknown fault {fault!r}")
    return h


def faulty_plain(args, fault: str, *, pool: bool, sms: int = H100_SMS) -> torch.Tensor:
    """What K5 on ``args`` would give with one of six mistakes, from its
    plain version: ``halo_no_zero_fill`` reads the bottom halo rows past F
    from the top of the plane instead of zeros; ``shifted_pool_pair`` pools
    the rows (2f + 1, 2f + 2) (the last pair (F - 1, F - 1));
    ``one_tap_of_a_chunk_dropped`` leaves out the last tap (kh - 1, kw - 1)
    of the last 16 input channels. The walk's (C_in >= 16,
    ``K5_WALK_FAULTS``): ``stale_weight_stage`` multiplies the last input
    chunk's last weight stage of the last output group by the stage before
    it (the same chunk's previous taps; the previous chunk's taps when a
    chunk is one stage): a stage read before it was refilled;
    ``x_row_ring_off_by_one_step`` and ``segment_border_halo_zeros``
    (``_k5_walk_fault``) on the segments the walk takes at this shape on a
    card of ``sms`` SMs. For showing that ``k5_score``'s bound catches such
    mistakes (``FAULTS``)."""
    x, weight, conv_bias, *bn = args
    c_out, c_in, kh, kw = weight.shape
    if fault in K5_WALK_FAULTS and not _k5_tensor_cores(c_in, c_out, kh, kw):
        raise ValueError(f"{fault!r} is a fault of the walk on the tensor cores (C_in >= 16)")
    if fault == "shifted_pool_pair":
        y = fused_conv_bn_relu_plain(*args, pool=False).float()
        y = torch.cat([y[:, :, 1:], y[:, :, -1:]], dim=2)
        return F.max_pool2d(y, (2, 1)).to(torch.bfloat16) if pool else y.to(torch.bfloat16)
    xp = _padded(x, kh, kw)
    if fault in ("x_row_ring_off_by_one_step", "segment_border_halo_zeros"):
        b, _, f, t = x.shape
        h = _k5_walk_fault(xp, weight, conv_bias, _pre_affine(xp, weight, conv_bias),
                           k5_segment_rows(b, f, t, sms), fault)
        return _bn_relu_pool(h, *bn, pool)
    if fault == "halo_no_zero_fill":
        below = kh - 1 - kh // 2  # padding rows after the last row: x's first rows instead
        xp[:, :, xp.shape[2] - below:] = xp[:, :, kh // 2: kh // 2 + below]
    elif fault == "one_tap_of_a_chunk_dropped":
        weight = weight.clone()
        weight[:, -16:, kh - 1, kw - 1] = 0
    elif fault == "stale_weight_stage":
        spt, sper = _k5_stage_taps(kh, kw)
        n0, c0 = 64 * ((c_out - 1) // 64), 16 * ((c_in - 1) // 16)
        w = weight.clone().reshape(c_out, c_in, kh * kw)
        if sper > 1:
            last = spt * (sper - 1)
            w[n0:, c0:, last:] = w[n0:, c0:, last - spt:last].clone()
        elif c0 > 0:
            w[n0:, c0:] = w[n0:, c0 - 16:c_in - 16].clone()
        else:
            raise ValueError("stale_weight_stage needs two weight stages in a step")
        weight = w.reshape(weight.shape)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return _bn_relu_pool(_pre_affine(xp, weight, conv_bias), *bn, pool)


K5_WALK_FAULTS = ("stale_weight_stage", "x_row_ring_off_by_one_step", "segment_border_halo_zeros")
FAULTS = ("halo_no_zero_fill", "shifted_pool_pair", "one_tap_of_a_chunk_dropped") + K5_WALK_FAULTS
# the raw tensors' dtype codes for the kernels (csrc/conv_bn_relu.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.float64: 3}


def _launch(x, weight, conv_bias, bn_scale, bn_bias, bn_mean, bn_var, pool: bool) -> torch.Tensor:
    """Check the inputs and launch K5 on the current stream of x's device
    (the packing of the raw weights and vectors, then the kernel); returns
    the output."""
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
    if any(t.dtype not in _DTYPE_CODES for t in tensors):
        raise ValueError(f"fused_conv_bn_relu takes fp32, bf16, fp16 or fp64 inputs, got "
                         f"{[t.dtype for t in tensors]}")
    _check_rows(f, pool)
    if _k5_tensor_cores(c_in, c_out, kh, kw) and _k5_smem_bytes(c_in, c_out, kh, kw) > K5_SMEM_LIMIT:
        raise ValueError(f"fused_conv_bn_relu: the x ring of {c_in} input channels at kh={kh}, "
                         f"kw={kw} exceeds the kernel's shared memory")
    if b > 65535:
        raise ValueError(f"fused_conv_bn_relu: grid too large for B={b}")
    tensors = tuple(a.contiguous() for a in tensors)
    shape = (b, c_out, f // 2 if pool else f, t)
    n = b * c_out * shape[2] * t
    # storage padded to whole 16-byte stores of 8 outputs
    out = torch.empty(-(-n // 8) * 8, device=x.device, dtype=torch.bfloat16)[:n].view(shape)
    if n:
        lib, fn = _entry()
        scratch = torch.empty(_k5_scratch_bytes(c_in, c_out, kh, kw), device=x.device,
                              dtype=torch.uint8)
        dtypes = sum(_DTYPE_CODES[a.dtype] << 3 * i for i, a in enumerate(tensors))
        with (contextlib.nullcontext() if x.device.index == torch.cuda.current_device()
              else torch.cuda.device(x.device)):
            err = fn(*(a.data_ptr() for a in tensors), out.data_ptr(), scratch.data_ptr(), dtypes,
                     b, c_in, c_out, f, t, kh, kw, int(pool), torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "conv_bn_relu_forward kernel")
    return out


@functools.cache
def _k5_scratch_bytes(c_in: int, c_out: int, kh: int, kw: int) -> int:
    """Bytes of the scratch K5 packs the affines and weights into."""
    return _entry()[0].conv_bn_relu_scratch_bytes(c_in, c_out, kh, kw)


@functools.cache
def _entry():
    """The library and its launch function, typed once."""
    lib = _build.load("conv_bn_relu")
    fn = lib.conv_bn_relu_forward
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.conv_bn_relu_segment_rows.argtypes = [ctypes.c_int] * 3
    lib.conv_bn_relu_segment_rows.restype = ctypes.c_int
    lib.conv_bn_relu_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.conv_bn_relu_scratch_bytes.restype = ctypes.c_longlong
    return lib, fn


def k5_device_segment_rows(b: int, f: int, t: int) -> int:
    """The segment height K5's walk takes at (B, F, T) on the current card
    (its library's ``conv_bn_relu_segment_rows``), for holding
    ``k5_segment_rows`` to it."""
    return _entry()[0].conv_bn_relu_segment_rows(b, f, t)


def fused_conv_bn_relu(x, weight, conv_bias, bn_scale, bn_bias, bn_mean, bn_var, *,
                       pool: bool = False) -> torch.Tensor:
    """Fused Conv(SAME) + BN(inference) + ReLU [+ maxpool(2, 1)]: (B, C_in,
    F, T) x, (C_out, C_in, kh, kw) weight, (C_out,) conv bias and BN scale,
    bias, running mean and variance -> (B, C_out, F[/2], T) bf16.

    A CUDA tensor goes through K5 (or raises ``ValueError`` on what it does
    not take); a CPU tensor through ``fused_conv_bn_relu_plain``.
    ``fused_conv_bn_relu.launches`` counts K5's launches (a call that
    launches counts once)."""
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


# ---------------------------------------------------------------------------
# K6: ResidualBlock [+ (2, 1) max-pool]
# ---------------------------------------------------------------------------

# K6 against its plain version, element by element (``k6_score``). The two
# differ only where a sum taken in another order lands on the other side of
# a rounding point, so the bound follows every value through the block as an
# interval around the plain version's and takes the width of the output's:
#   * each fp32 conv sum of n exact products of bf16 values is within
#     n 2^-23 m of the exact one, m the same sum over magnitudes (2^-23, not
#     2^-24: tensor-core accumulators may truncate), so the two versions'
#     sums v are within e = 2 n 2^-23 m of each other, and their roundings
#     bf16(v) within spread(v, e) = bf16(v + e) - bf16(v - e), which is 0
#     unless [v - e, v + e] holds a rounding boundary;
#   * the affine h s + o moves that by |s| spread, and by 2^-22 (|h s| + |b|
#     + |mean s|) for an fp32 product and sum rounded once (a fused
#     multiply-add) or twice, and o's own rounding;
#   * ReLU and the rounding to bf16 are monotone, so h1 = bf16(relu(a)) of
#     an affine value a known to within w is known to within
#     bf16(relu(a + w)) - bf16(relu(a - w)): d1, 0 for most elements;
#   * conv2 carries d1 as the sum conv3x3(d1, |w2|), beside its own order
#     term 2 n2 2^-23 m2 (m2 over |h1| + d1); h2's affine and the skip's
#     (1x1 conv, n = C_in; the identity skip is exact) as above;
#   * out = bf16(relu(h2 + skip)), the sum within the two widths and
#     2^-22 (|h2| + |skip|), so out within bf16(relu(p + d)) - bf16(relu(p - d));
#     with pool the larger of the pair's (a max moves no further).
# So the bound is exact where no rounding boundary is near: the two must
# agree bit for bit there. (Counting every h1 element as possibly one bf16
# unit off, 2^-7 conv3x3(|h1|, |w2|), would put the bound near a quarter of
# a typical h2 at the 89M widths, loose enough to let a dropped tap pass.)
SUM_ULP = 2.0**-23
AFFINE_ULP = 2.0**-22
FAULTS_K6 = ("h1_halo_not_zeroed", "skip_column_shifted", "shifted_pool_pair",
             "one_tap_of_a_chunk_dropped", "stale_weight_stage", "row_ring_off_by_one_step",
             "segment_border_not_recomputed")
# K6's plan (csrc/res_block.cu segment_rows, make_plan). A block walks a
# strip of 62 output columns down a segment of rows, 2 rows a step; the
# segment height makes strips x B x segments fill the SMs, at least 8 rows.
# Shared memory: x rows in a ring of 6 x 66 pixels, h1 rows in a ring of
# 4 x 66 pixels, all channels, bf16; the per-channel affines (a float4 per
# channel of conv1, conv2 and the skip); each rounded up to 1 KiB; 1 KiB of
# alignment slack and 6 x-ring barriers; and at least one weight stage of 9
# taps x 64 output channels x 16 input channels with its two barriers (all
# of a step's weights, when they fit, stay resident).
K6_SMEM_LIMIT = 232448
K6_STRIP = 62
K6_MIN_SEGMENT_ROWS = 8


def _k6_smem_bytes(c_in: int, c_mid: int, c_out: int) -> int:
    """The least shared memory K6 runs in: the rings, the affines and one
    weight stage."""
    rings = _kib(6 * 66 * 2 * c_in) + _kib(4 * 66 * 2 * c_mid)
    return 1024 + rings + _kib(16 * (c_mid + 2 * c_out)) + 8 * 6 + 9 * 64 * 32 + 16


def k6_segment_rows(b: int, f: int, t: int, sms: int = H100_SMS) -> int:
    """Output rows of a segment of K6's walk at (B, F, T) on a card of
    ``sms`` SMs (the kernel's ``segment_rows``)."""
    units = -(-t // K6_STRIP) * b
    nseg = 1 if units >= sms else sms // units
    rows = -(-f // nseg)
    rows = max(rows + rows % 2, K6_MIN_SEGMENT_ROWS)
    return min(rows, f)


def k6_work(b, c_in, c_mid, c_out, f, t, skip: bool, sms: int = H100_SMS) -> dict:
    """The multiply-adds (x 2: FLOP) K6 executes at this shape, beside those
    the block needs: conv1 over every h1 pixel of the tensor once, conv2 and
    the skip over every output pixel once. Executed counts what the walk
    computes and drops: the 2 halo columns of a strip's 64 h1 columns and 2
    dropped output columns, the last strip's columns past T (a warpgroup's
    32 columns unless all lie past T), the 2 h1 rows a segment computes
    again, rows outside the tensor, and output channels padded to the
    tile."""
    seg = k6_segment_rows(b, f, t, sms)
    rows = [min(seg, f - f0) for f0 in range(0, f, seg)]
    pad_mid, pad_out = -(-c_mid // 64) * 64, -(-c_out // 64) * 64
    cols1 = cols2 = 0  # a warpgroup takes 32 columns, skipped when all lie past T
    for t0 in range(0, t, K6_STRIP):
        for wg in (0, 1):
            cols1 += 32 * (t0 - 1 + 32 * wg < t)
            cols2 += 32 * (t0 + 32 * wg < t)
    per_px1, per_px2 = 2 * 9 * c_in, 2 * (9 * c_mid + (c_in if skip else 0))
    conv1 = (b * cols1 * sum(r + 2 for r in rows) * per_px1 * pad_mid,
             b * f * t * per_px1 * c_mid)
    rest = (b * cols2 * sum(rows) * per_px2 * pad_out, b * f * t * per_px2 * c_out)
    return {"conv1_executed": conv1[0], "conv1_useful": conv1[1],
            "executed": conv1[0] + rest[0], "useful": conv1[1] + rest[1]}


def _k6_split(args):
    """(x, conv1, conv2, skip) from K6's flat arguments, each conv a tuple
    (weight, conv bias, BN scale, bias, mean, variance); skip None without
    a skip conv."""
    x, rest = args[0], tuple(args[1:])
    rest += (None,) * (18 - len(rest))
    skip = rest[12:18]
    if any(t is None for t in skip) and not all(t is None for t in skip):
        raise ValueError("fused_res_block: give all six skip tensors or none")
    return x, rest[0:6], rest[6:12], None if skip[0] is None else skip


def _affine(h, g, b, mean, var):
    s, o = bn_affine(g, b, mean, var)
    return h * s.view(1, -1, 1, 1) + o.view(1, -1, 1, 1)


def _k6_plain(args, pool: bool, *, zero_h1_halo: bool = True, skip_shift: int = 0,
              conv2_fault=None, seg_rows: int = 0):
    """K6's plain version, with three of ``faulty_plain_k6``'s mistakes as
    options (``conv2_fault``: one of the segment walk's, on segments of
    ``seg_rows`` output rows)."""
    x, (w1, b1, *bn1), (w2, b2, *bn2), skip = _k6_split(args)
    _check_rows(x.shape[2], pool)
    if skip is None and x.shape[1] != w2.shape[0]:
        raise ValueError(f"fused_res_block: no skip conv, but C_in {x.shape[1]} != C_out "
                         f"{w2.shape[0]}")
    xb = x.to(torch.bfloat16).float()
    if zero_h1_halo:  # conv2's SAME padding: zeros outside the tensor
        h1 = same_pad(_bn_relu_pool(_pre_affine(same_pad(xb, 3, 3), w1, b1), *bn1, False).float(),
                      3, 3)
    else:  # h1 computed on the ring outside the tensor too, and kept
        h1 = _bn_relu_pool(_pre_affine(F.pad(xb, (2, 2, 2, 2)), w1, b1), *bn1, False).float()
    a2 = _pre_affine(h1, w2, b2)
    if conv2_fault is not None:
        a2 = _segment_walk_fault(h1, w2, b2, a2, seg_rows, conv2_fault)
    h2 = _affine(a2, *bn2)
    xs = F.pad(xb[..., skip_shift:], (0, skip_shift)) if skip_shift else xb
    sk = xs if skip is None else _affine(_pre_affine(xs, skip[0], skip[1]), *skip[2:])
    out = torch.relu(h2 + sk).to(torch.bfloat16)
    return F.max_pool2d(out.float(), (2, 1)).to(torch.bfloat16) if pool else out


def _segment_walk_fault(h1, w2, b2, a2, seg_rows: int, fault: str):
    """conv2's bf16(conv + bias) ``a2`` (from the padded ``h1``) as a walk
    over segments of ``seg_rows`` output rows would give it with ``fault``.
    ``row_ring_off_by_one_step``: the second step's row pair of each
    segment reads the h1 rows of the first step.
    ``segment_border_not_recomputed``: each segment sees zeros for the h1
    rows past its borders that its neighbour computes (f0 - 1 and
    f0 + seg_rows inside the tensor)."""
    f = a2.shape[2]
    a2 = a2.clone()
    for f0 in range(0, f, seg_rows):
        f1 = min(f0 + seg_rows, f)
        if fault == "row_ring_off_by_one_step":
            if f1 - f0 >= 4:
                a2[:, :, f0 + 2:f0 + 4] = a2[:, :, f0:f0 + 2].clone()
        elif fault == "segment_border_not_recomputed":
            h = h1[:, :, f0:f1 + 2].clone()  # padded rows of global f0 - 1 .. f1
            if f0 > 0:
                h[:, :, 0] = 0
            if f1 < f:
                h[:, :, -1] = 0
            a2[:, :, f0:f1] = _pre_affine(h, w2, b2)
        else:
            raise ValueError(f"unknown fault {fault!r}")
    return a2


def fused_res_block_plain(x, w1, b1, g1, be1, m1, v1, w2, b2, g2, be2, m2, v2, ws=None,
                          bs=None, gs=None, bes=None, ms=None, vs=None, *,
                          pool: bool = False) -> torch.Tensor:
    """K6's plain version: (B, C_in, F, T) x; conv1 (C_mid, C_in, 3, 3)
    with its conv bias and BN scale, bias, mean, variance; conv2 (C_out,
    C_mid, 3, 3) and its five vectors; the skip conv (C_out, C_in, 1, 1) and
    its five, or none when C_in == C_out -> (B, C_out, F[/2], T) bf16,
    rounded where the Pallas kernel rounds."""
    return _k6_plain((x, w1, b1, g1, be1, m1, v1, w2, b2, g2, be2, m2, v2,
                      ws, bs, gs, bes, ms, vs), pool)


def _spread(v, e):
    """How far apart bf16 roundings of two values within e of v can be."""
    return (v + e).to(torch.bfloat16).float() - (v - e).to(torch.bfloat16).float()


def _relu_spread(a, w):
    return torch.relu(a + w).to(torch.bfloat16).float() - torch.relu(a - w).to(torch.bfloat16).float()


def _conv_interval(inp, d_inp, weight, conv_bias, g, b, mean, var):
    """One conv + bias + bf16 + affine of the plain version, on ``inp``
    known to within ``d_inp`` (None: exact): (the affine's value, how far
    the kernel's may be from it)."""
    wb = weight.to(torch.bfloat16).float()
    with full_fp32():
        v = F.conv2d(inp, wb) + conv_bias.float().view(1, -1, 1, 1)
        mag = inp.abs() if d_inp is None else inp.abs() + d_inp
        m = F.conv2d(mag, wb.abs()) + conv_bias.float().abs().view(1, -1, 1, 1)
        e = 2 * weight[0].numel() * SUM_ULP * m
        if d_inp is not None:
            e += F.conv2d(d_inp, wb.abs())
    s, o = (t.view(1, -1, 1, 1) for t in bn_affine(g, b, mean, var))
    zs = v.to(torch.bfloat16).float() * s
    slack = AFFINE_ULP * (zs.abs() + b.float().abs().view(1, -1, 1, 1) + (mean.float().view(1, -1, 1, 1) * s).abs())
    return zs + o, s.abs() * _spread(v, e) + slack


@torch.no_grad()
def k6_score(got, ref, args, *, pool: bool) -> float:
    """Largest |got - ref| over its bound (derived above) for K6 on
    ``args`` (``fused_res_block_plain``'s) against
    ``ref = fused_res_block_plain(*args, pool=pool)``: <= 1 passes; an
    element that differs where the bound is 0 scores inf."""
    x, conv1, conv2, skip = _k6_split(args)
    xb = x.to(torch.bfloat16).float()
    a1, w1 = _conv_interval(same_pad(xb, 3, 3), None, *conv1)
    h1, d1 = torch.relu(a1).to(torch.bfloat16).float(), _relu_spread(a1, w1)
    h2, dh2 = _conv_interval(same_pad(h1, 3, 3), same_pad(d1, 3, 3), *conv2)
    sk, dsk = (xb, 0.0) if skip is None else _conv_interval(xb, None, *skip)
    p = h2 + sk
    bound = _relu_spread(p, dh2 + dsk + AFFINE_ULP * (h2.abs() + sk.abs()))
    if pool:
        bound = F.max_pool2d(bound, (2, 1))
    err = (got.float() - ref.float()).abs()
    return float(torch.where(err == 0, torch.zeros_like(err), err / bound).max())


@torch.no_grad()
def faulty_plain_k6(args, fault: str, *, pool: bool, sms: int = H100_SMS) -> torch.Tensor:
    """What K6 on ``args`` would give with one of seven mistakes, from its
    plain version: ``h1_halo_not_zeroed`` keeps h1's values computed on the
    ring outside the tensor (from the zero-padded x: not zero) for conv2;
    ``skip_column_shifted`` reads the skip's input one column later (zeros
    past the last); ``shifted_pool_pair`` pools the rows (2f + 1, 2f + 2)
    (the last pair (F - 1, F - 1)), or without pool shifts the rows by one;
    ``one_tap_of_a_chunk_dropped`` leaves out conv2's last tap (2, 2) of the
    last 16 h1 channels; ``stale_weight_stage`` multiplies conv2's last 16
    h1 channels by the weights of the 16 before them (a weight stage read
    before it was refilled); ``row_ring_off_by_one_step`` and
    ``segment_border_not_recomputed`` (``_segment_walk_fault``) are the
    walk's, on the segments K6 takes at this shape on a card of ``sms`` SMs.
    For showing that ``k6_score``'s bound catches such mistakes
    (``FAULTS_K6``)."""
    if fault == "h1_halo_not_zeroed":
        return _k6_plain(args, pool, zero_h1_halo=False)
    if fault == "skip_column_shifted":
        return _k6_plain(args, pool, skip_shift=1)
    if fault == "shifted_pool_pair":
        y = _k6_plain(args, False).float()
        y = torch.cat([y[:, :, 1:], y[:, :, -1:]], dim=2)
        return F.max_pool2d(y, (2, 1)).to(torch.bfloat16) if pool else y.to(torch.bfloat16)
    if fault in ("one_tap_of_a_chunk_dropped", "stale_weight_stage"):
        args = list(args)
        args[7] = args[7].clone()
        if fault == "one_tap_of_a_chunk_dropped":
            args[7][:, -16:, 2, 2] = 0
        else:
            args[7][:, -16:] = args[7][:, -32:-16]
        return _k6_plain(args, pool)
    if fault in ("row_ring_off_by_one_step", "segment_border_not_recomputed"):
        b, _, f, t = args[0].shape
        return _k6_plain(args, pool, conv2_fault=fault, seg_rows=k6_segment_rows(b, f, t, sms))
    raise ValueError(f"unknown fault {fault!r}")


def _launch_k6(args, pool: bool) -> torch.Tensor:
    """Check the inputs and launch K6 on the current stream of x's device;
    returns the output."""
    x, conv1, conv2, skip = _k6_split(args)
    tensors = (x, *conv1, *conv2, *(skip or ()))
    if not x.is_cuda or any(t.device != x.device for t in tensors):
        raise ValueError(f"fused_res_block: inputs on {[str(t.device) for t in tensors]}")
    if not all(t.is_floating_point() for t in tensors):
        raise ValueError(f"fused_res_block takes floating inputs, got {[t.dtype for t in tensors]}")
    if x.dim() != 4:
        raise ValueError(f"fused_res_block: x {tuple(x.shape)}")
    b, c_in, f, t = x.shape
    c_mid, c_out = conv1[0].shape[0], conv2[0].shape[0]
    shapes = [(conv1[0], (c_mid, c_in, 3, 3)), (conv2[0], (c_out, c_mid, 3, 3))]
    shapes += [(v, (c_mid,)) for v in conv1[1:]] + [(v, (c_out,)) for v in conv2[1:]]
    if skip is None:
        shapes.append((x, (b, c_out, f, t)))  # the identity skip: C_in == C_out
    else:
        shapes += [(skip[0], (c_out, c_in, 1, 1))] + [(v, (c_out,)) for v in skip[1:]]
    bad = [(tuple(a.shape), want) for a, want in shapes if tuple(a.shape) != want]
    if bad:
        raise ValueError(f"fused_res_block: shapes (got, want) {bad}")
    if (c_in % 16 or c_mid % 16 or c_out % 16
            or _k6_smem_bytes(c_in, c_mid, c_out) > K6_SMEM_LIMIT):
        raise ValueError(f"fused_res_block: the kernel takes channel counts that are multiples "
                         f"of 16 and fit its shared memory, got {c_in} -> {c_mid} -> {c_out}")
    _check_rows(f, pool)
    if -(-f // K6_MIN_SEGMENT_ROWS) > 65535 or b > 65535:  # the grid's segments, images
        raise ValueError(f"fused_res_block: grid too large for B={b}, F={f}")
    xb = x.to(torch.bfloat16).contiguous()
    convs = [conv1, conv2] + ([skip] if skip is not None else [])
    ptrs = []
    for weight, conv_bias, *bn in convs:  # weights as (kh, kw, C_out, C_in)
        ptrs += [weight.to(torch.bfloat16).permute(2, 3, 0, 1).contiguous(),
                 conv_bias.float().contiguous(), *(v.contiguous() for v in bn_affine(*bn))]
    out = torch.empty((b, c_out, f // 2 if pool else f, t), device=x.device, dtype=torch.bfloat16)
    if out.numel():
        lib, fn = _entry_k6()
        # the weights packed as the kernel's stages hold them
        n = lib.res_block_scratch_bytes(c_in, c_mid, c_out, int(skip is not None))
        scratch = torch.empty(n, device=x.device, dtype=torch.uint8)
        addrs = [a.data_ptr() for a in ptrs] + [None] * (12 - len(ptrs))
        with torch.cuda.device(x.device):
            err = fn(xb.data_ptr(), *addrs, out.data_ptr(), b, c_in, c_mid, c_out, f, t,
                     int(pool), scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "res_block_forward kernel")
    return out


@functools.cache
def _entry_k6():
    lib = _build.load("res_block")
    fn = lib.res_block_forward
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    lib.res_block_segment_rows.argtypes = [ctypes.c_int] * 3
    lib.res_block_segment_rows.restype = ctypes.c_int
    lib.res_block_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.res_block_scratch_bytes.restype = ctypes.c_longlong
    return lib, fn


def k6_device_segment_rows(b: int, f: int, t: int) -> int:
    """The segment height K6 takes at (B, F, T) on the current card (its
    library's ``res_block_segment_rows``), for holding ``k6_segment_rows``
    to it."""
    return _entry_k6()[0].res_block_segment_rows(b, f, t)


def fused_res_block(x, w1, b1, g1, be1, m1, v1, w2, b2, g2, be2, m2, v2, ws=None, bs=None,
                    gs=None, bes=None, ms=None, vs=None, *, pool: bool = False) -> torch.Tensor:
    """Fused ResidualBlock (inference) [+ maxpool(2, 1)], on the arguments
    of ``fused_res_block_plain`` -> (B, C_out, F[/2], T) bf16.

    A CUDA tensor goes through K6 (or raises ``ValueError`` on what it does
    not take); a CPU tensor through ``fused_res_block_plain``.
    ``fused_res_block.launches`` counts K6's launches."""
    args = (x, w1, b1, g1, be1, m1, v1, w2, b2, g2, be2, m2, v2, ws, bs, gs, bes, ms, vs)
    if x.device.type == "cpu":
        return _k6_plain(args, pool)
    out = _launch_k6(args, pool)
    if out.numel():
        fused_res_block.launches += 1
    return out


fused_res_block.launches = 0


def res_block_args(block) -> tuple:
    """A port ``ResidualBlock``'s weights and running statistics as K6's
    arguments after x (without the skip's when ``block.skip`` is None)."""
    pairs = [(block.conv1, block.bn1), (block.conv2, block.bn2)]
    if block.skip is not None:
        pairs.append((block.skip[0], block.skip[1]))
    for conv, bn in pairs:
        k = conv.kernel_size[0]
        if conv.stride != (1, 1) or conv.padding != (k // 2, k // 2) or bn.eps != BN_EPS:
            raise ValueError(f"not a SAME stride-1 residual block: {conv}, {bn}")
    return tuple(t for conv, bn in pairs
                 for t in (conv.weight, conv.bias, bn.weight, bn.bias, bn.running_mean,
                           bn.running_var))


def res_block_stage(x, block, *, pool: bool) -> torch.Tensor:
    """A port model's ``ResidualBlock`` (with or without ``skip``) through
    ``fused_res_block``, with its BatchNorms' running statistics (K6 is an
    inference kernel)."""
    with torch.no_grad():
        return fused_res_block(x, *res_block_args(block), pool=pool)
