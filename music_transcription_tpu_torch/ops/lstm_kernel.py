"""The fused-direction LSTM recurrence: K1 (forward), K2a (forward with the
cell states, for training) and K2b (backward through time).

Ports of ``lstm_recurrence_pallas`` / ``_recurrence_kernel`` (K1),
``_lstm_recurrence_fwd_impl`` / ``_recurrence_fwd_kernel`` (K2a) and
``_lstm_recurrence_bwd`` / ``_recurrence_bwd_kernel`` (K2b) in the JAX
package's ``ops/lstm_pallas.py``. Inputs are the hoisted input projections
``xw`` (2B, T, 4H), forward rows first and the time-reversed backward rows
after them, and the stacked recurrent weights ``wh`` (2, H, 4H); the output
is ``h`` (2B, T, H). Each step computes, in fp32 and torch gate order
(i, f, g, o), from a zero initial state::

    gates = xw[:, t] + blockdiag(h_{t-1}) @ wh     # rows [:B] use wh[0], [B:] wh[1]
    c = sigmoid(f) * c + sigmoid(i) * tanh(g)
    h = sigmoid(o) * tanh(c)

``LSTMRecurrence`` is the differentiable recurrence: K2a forward, K2b for
dxw, and dW_hh = sum_t h_{t-1}^T dgates_t as one matrix product outside the
kernel (as the JAX package computes it outside Pallas). ``recurrence`` picks
it when a gradient is wanted and K1 otherwise.

Each wrapper launches its hand-written CUDA kernel (``csrc/lstm_recurrence.cu``)
for a CUDA tensor and takes its plain version only for a CPU tensor.
``faulty_fwd_plain`` and ``faulty_bwd_plain`` are the outputs a barrier that
races would give, built from the plain versions for the checks;
``lstm_recurrence_floor`` times the kernels' T barriers alone.
"""

from __future__ import annotations

import ctypes

import torch

from music_transcription_tpu_torch.ops import _build
from music_transcription_tpu_torch.ops.precision import full_fp32


def _gates(xw_t, h_prev, wh):
    """(2B, 4H) gates of one step from h_{t-1} (2B, H)."""
    two_b, hidden = h_prev.shape
    hw = torch.bmm(h_prev.view(2, two_b // 2, hidden), wh).view(two_b, 4 * hidden)
    return xw_t + hw


def _fwd_loop(xw, wh, stale_step=None):
    """(h, c) of the recurrence; at step ``stale_step`` (if any) the gates read
    h_{t-2} in place of h_{t-1}."""
    two_b, t, four_h = xw.shape
    hidden = four_h // 4
    xw, wh = xw.float(), wh.float()
    h = h_before = xw.new_zeros(two_b, hidden)
    c = xw.new_zeros(two_b, hidden)
    h_out = xw.new_empty(two_b, t, hidden)
    c_out = xw.new_empty(two_b, t, hidden)
    with full_fp32():
        for s in range(t):
            i, f, g, o = _gates(xw[:, s], h_before if s == stale_step else h, wh).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_before, h = h, torch.sigmoid(o) * torch.tanh(c)
            h_out[:, s] = h
            c_out[:, s] = c
    return h_out, c_out


def lstm_recurrence_fwd_plain(xw: torch.Tensor, wh: torch.Tensor):
    """The recurrence as a Python loop over time of fp32 tensor ops:
    (h, c), each (2B, T, H)."""
    return _fwd_loop(xw, wh)


def lstm_recurrence_plain(xw: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """K1's plain version: h of ``lstm_recurrence_fwd_plain``."""
    return lstm_recurrence_fwd_plain(xw, wh)[0]


def _bwd_loop(xw, wh, h, c, dh, stale_step=None):
    """dxw of the reverse-time loop; at step ``stale_step`` (if any) the dh
    carry is the one a step older (the carry step + 1 received)."""
    two_b, t, four_h = xw.shape
    hidden = four_h // 4
    b = two_b // 2
    xw, wh = xw.float(), wh.float()
    dxw = xw.new_empty(two_b, t, four_h)
    dh_carry = dh_older = xw.new_zeros(two_b, hidden)
    dc_carry = xw.new_zeros(two_b, hidden)
    zero = xw.new_zeros(two_b, hidden)
    wh_t = wh.transpose(1, 2)
    with full_fp32():
        for s in reversed(range(t)):
            h_prev, c_prev = (h[:, s - 1], c[:, s - 1]) if s > 0 else (zero, zero)
            i, f, g, o = _gates(xw[:, s], h_prev, wh).chunk(4, dim=-1)
            i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
            tanh_c = torch.tanh(c[:, s])
            dh_total = dh[:, s] + (dh_older if s == stale_step else dh_carry)
            dc_total = dh_total * o * (1.0 - tanh_c * tanh_c) + dc_carry
            dgates = torch.cat([dc_total * g * i * (1.0 - i),
                                dc_total * c_prev * f * (1.0 - f),
                                dc_total * i * (1.0 - g * g),
                                dh_total * tanh_c * o * (1.0 - o)], dim=-1)
            dxw[:, s] = dgates
            dh_older = dh_carry
            dh_carry = torch.bmm(dgates.view(2, b, four_h), wh_t).view(two_b, hidden)
            dc_carry = dc_total * f
    return dxw


def lstm_recurrence_bwd_plain(xw, wh, h, c, dh) -> torch.Tensor:
    """K2b's plain version: an explicit reverse-time loop, as
    ``_recurrence_bwd_kernel`` walks it. The gates are recomputed from xw and
    h_{t-1}; the dh and dc carries start at zero. Returns dxw (2B, T, 4H),
    the gradient of the gates (= of xw)."""
    return _bwd_loop(xw, wh, h, c, dh)


def faulty_fwd_plain(xw: torch.Tensor, wh: torch.Tensor):
    """What K2a would give if its barrier let one step run early: (h, c) of
    the plain version with step T // 2 reading h_{t-2} in place of h_{t-1}.
    For showing that the forward's 1e-4 tolerance catches such a race."""
    return _fwd_loop(xw, wh, stale_step=xw.shape[1] // 2)


def faulty_bwd_plain(xw, wh, h, c, dh) -> torch.Tensor:
    """What K2b would give if its barrier let one step run early: dxw of the
    plain version with step T // 2 using the dh carry one step stale. For
    showing that K2b's tolerance (1e-4 of the largest |dxw|) catches it."""
    return _bwd_loop(xw, wh, h, c, dh, stale_step=xw.shape[1] // 2)


def recurrent_weight_grad(h: torch.Tensor, dxw: torch.Tensor) -> torch.Tensor:
    """dW_hh[d] = sum_t h_{t-1}[d]^T dgates_t[d] (h_{-1} = 0): (2, H, 4H)."""
    two_b, t, hidden = h.shape
    h_prev = torch.cat([h.new_zeros(two_b, 1, hidden), h[:, :-1]], dim=1)
    with full_fp32():
        return torch.bmm(h_prev.reshape(2, -1, hidden).transpose(1, 2),
                         dxw.reshape(2, -1, 4 * hidden))


def _check(name, xw, wh, *more):
    """Device, dtype and shape checks of a kernel's inputs; returns
    (2B, T, H) and the contiguous tensors."""
    tensors = (xw, wh) + more
    if not xw.is_cuda or any(x.device != xw.device for x in tensors):
        raise ValueError(f"{name}: inputs on {[str(x.device) for x in tensors]}")
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError(f"{name} takes fp32, got {[x.dtype for x in tensors]}")
    two_b, t, four_h = xw.shape
    hidden = four_h // 4
    if (two_b % 2 or four_h % 4 or tuple(wh.shape) != (2, hidden, four_h)
            or any(tuple(x.shape) != (two_b, t, hidden) for x in more)):
        raise ValueError(f"{name}: bad shapes {[tuple(x.shape) for x in tensors]}")
    return (two_b, t, hidden), tuple(x.contiguous() for x in tensors)


def _entry(name: str, n_ptrs: int):
    lib = _build.load("lstm_recurrence")
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


_NOT_TAKEN = -1  # the C side's code for a shape the kernels do not take


def _launch(name: str, tensors, shape) -> None:
    """Launch ``name`` on the current stream of the tensors' device, with 64
    zeroed words of device memory for the two directions' barrier counters.
    A shape the kernels do not take raises ValueError."""
    sync = torch.zeros(64, dtype=torch.int32, device=tensors[0].device)
    lib, fn = _entry(name, len(tensors) + 1)
    with torch.cuda.device(tensors[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(x.data_ptr() for x in tensors), sync.data_ptr(), *shape, stream)
    if err == _NOT_TAKEN:
        raise ValueError(f"{name}: the kernels do not take (2B, T, H) = {shape} "
                         "(H above 512 with 8 units a block, above 1024 with 4, above 256 for "
                         "K2b with 1 or 2; or a batch whose rows outgrow shared memory)")
    _build.check(lib, err, f"{name} kernel")


def lstm_recurrence_floor(two_b: int, t: int, hidden: int, device="cuda") -> None:
    """The sequential floor of K1/K2a/K2b at (2B, T, H): their grid doing the T
    per-direction barriers and nothing else. For timing only; no path calls
    it, and it has no plain version (there is nothing to compute)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"lstm_recurrence_floor runs on a CUDA device, not {device}")
    sync = torch.zeros(64, dtype=torch.int32, device=device)
    lib, fn = _entry("lstm_recurrence_floor", 1)
    with torch.cuda.device(device):
        err = fn(sync.data_ptr(), two_b, t, hidden, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "lstm_recurrence_floor kernel")


def lstm_recurrence(xw: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """K1: (2B, T, 4H) fp32, (2, H, 4H) fp32 -> h (2B, T, H) fp32, no gradient.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor through
    ``lstm_recurrence_plain``. ``lstm_recurrence.launches`` counts launches.
    """
    if xw.device.type == "cpu":
        return lstm_recurrence_plain(xw, wh)
    shape, (xw, wh) = _check("lstm_recurrence", xw, wh)
    out = torch.empty(shape, device=xw.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    _launch("lstm_recurrence_forward", (xw, wh, out), shape)
    lstm_recurrence.launches += 1
    return out


def lstm_recurrence_fwd(xw: torch.Tensor, wh: torch.Tensor):
    """K2a: K1 that also returns the cell states, (h, c) each (2B, T, H).
    ``lstm_recurrence_fwd.launches`` counts launches."""
    if xw.device.type == "cpu":
        return lstm_recurrence_fwd_plain(xw, wh)
    shape, (xw, wh) = _check("lstm_recurrence_fwd", xw, wh)
    h = torch.empty(shape, device=xw.device, dtype=torch.float32)
    c = torch.empty_like(h)
    if h.numel() == 0:
        return h, c
    _launch("lstm_recurrence_forward_train", (xw, wh, h, c), shape)
    lstm_recurrence_fwd.launches += 1
    return h, c


def lstm_recurrence_bwd(xw, wh, h, c, dh) -> torch.Tensor:
    """K2b: dxw (2B, T, 4H) from xw, wh, the forward's h and c and the
    gradient dh of h. ``lstm_recurrence_bwd.launches`` counts launches."""
    if xw.device.type == "cpu":
        return lstm_recurrence_bwd_plain(xw, wh, h, c, dh)
    shape, tensors = _check("lstm_recurrence_bwd", xw, wh, h, c, dh)
    dxw = torch.empty_like(tensors[0])
    if dxw.numel() == 0:
        return dxw
    _launch("lstm_recurrence_backward", tensors + (dxw,), shape)
    lstm_recurrence_bwd.launches += 1
    return dxw


lstm_recurrence.launches = 0
lstm_recurrence_fwd.launches = 0
lstm_recurrence_bwd.launches = 0


class LSTMRecurrence(torch.autograd.Function):
    """The differentiable recurrence (the JAX package's ``lstm_recurrence``
    custom VJP): K2a forward, K2b + one matrix product backward."""

    @staticmethod
    def forward(ctx, xw, wh):
        xw, wh = xw.float().contiguous(), wh.float().contiguous()
        h, c = lstm_recurrence_fwd(xw, wh)
        ctx.save_for_backward(xw, wh, h, c)
        return h

    @staticmethod
    def backward(ctx, dh):
        xw, wh, h, c = ctx.saved_tensors
        dxw = lstm_recurrence_bwd(xw, wh, h, c, dh.float().contiguous())
        return dxw, recurrent_weight_grad(h, dxw)


def recurrence(xw: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """``LSTMRecurrence`` (K2a/K2b) when a gradient is wanted, else K1."""
    if torch.is_grad_enabled() and (xw.requires_grad or wh.requires_grad):
        return LSTMRecurrence.apply(xw, wh)
    return lstm_recurrence(xw, wh)
