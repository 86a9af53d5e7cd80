"""K1: the fused-direction LSTM recurrence, forward only.

Port of ``lstm_recurrence_pallas`` / ``_recurrence_kernel`` in the JAX
package's ``ops/lstm_pallas.py``. Inputs are the hoisted input projections
``xw`` (2B, T, 4H), forward rows first and the time-reversed backward rows
after them, and the stacked recurrent weights ``wh`` (2, H, 4H); the output
is ``h`` (2B, T, H). Each step computes, in fp32 and torch gate order
(i, f, g, o), from a zero initial state::

    gates = xw[:, t] + blockdiag(h_{t-1}) @ wh     # rows [:B] use wh[0], [B:] wh[1]
    c = sigmoid(f) * c + sigmoid(i) * tanh(g)
    h = sigmoid(o) * tanh(c)

``lstm_recurrence`` launches the hand-written CUDA kernel
(``csrc/lstm_recurrence.cu``) for a CUDA tensor and takes the plain version
only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from music_transcription_tpu_torch.ops import _build
from music_transcription_tpu_torch.ops.precision import full_fp32


def lstm_recurrence_plain(xw: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """The recurrence as a Python loop over time of fp32 tensor ops."""
    two_b, t, four_h = xw.shape
    hidden, b = four_h // 4, two_b // 2
    xw, wh = xw.float(), wh.float()
    h = xw.new_zeros(two_b, hidden)
    c = xw.new_zeros(two_b, hidden)
    out = xw.new_empty(two_b, t, hidden)
    with full_fp32():
        for s in range(t):
            hw = torch.bmm(h.view(2, b, hidden), wh).view(two_b, four_h)
            i, f, g, o = (xw[:, s] + hw).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out[:, s] = h
    return out


def lstm_recurrence(xw: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """(2B, T, 4H) fp32, (2, H, 4H) fp32 -> (2B, T, H) fp32.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor through
    ``lstm_recurrence_plain``. ``lstm_recurrence.launches`` counts launches.
    """
    if xw.device.type == "cpu":
        return lstm_recurrence_plain(xw, wh)
    if not xw.is_cuda or wh.device != xw.device:
        raise ValueError(f"lstm_recurrence: xw on {xw.device}, wh on {wh.device}")
    two_b, t, four_h = xw.shape
    hidden = four_h // 4
    if xw.dtype != torch.float32 or wh.dtype != torch.float32:
        raise ValueError(f"lstm_recurrence takes fp32, got {xw.dtype} and {wh.dtype}")
    if two_b % 2 or four_h % 4 or tuple(wh.shape) != (2, hidden, four_h):
        raise ValueError(f"lstm_recurrence: bad shapes xw {tuple(xw.shape)}, wh {tuple(wh.shape)}")
    xw, wh = xw.contiguous(), wh.contiguous()
    out = torch.empty(two_b, t, hidden, device=xw.device, dtype=torch.float32)
    if t == 0 or two_b == 0:
        return out
    lib = _build.load("lstm_recurrence")
    fn = lib.lstm_recurrence_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xw.data_ptr(), wh.data_ptr(), out.data_ptr(), two_b, t, hidden, stream)
    _build.check(lib, err, "lstm_recurrence kernel")
    lstm_recurrence.launches += 1
    return out


lstm_recurrence.launches = 0
