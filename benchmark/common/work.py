"""Operations and bytes of the program's recurrence kernels, from their
shapes: the yardstick of their roofline shares.

A launch runs one BiLSTM layer's recurrence over 2B rows (both directions)
of T steps at hidden size H, in float32 on the CUDA cores. Each step of a
row is the product h_{t-1} W_hh (2 * H * 4H operations) and the gates;
the elementwise work is not counted. Bytes: each input read once and each
output written once.

  * K2a (forward): reads xw (2B, T, 4H) and W_hh (2, H, 4H), writes h and
    c (2B, T, H);
  * K2b (backward): reads xw, W_hh, h, c and dh, writes dxw (2B, T, 4H); from
    these inputs a step needs the gates again (h_{t-1} W_hh) beside
    dh_{t-1} = dgates_t W_hh^T: two products.
"""

from __future__ import annotations

from benchmark.common.device import PEAK_FP32, bound_s


def recurrence_bound_s(two_b: int, t: int, h: int, kind: str) -> float:
    """The least time of one launch: ``kind`` is "K2a" or "K2b"."""
    product = 2.0 * two_b * t * h * 4 * h
    xw, wh, seq = two_b * t * 4 * h, 2 * h * 4 * h, two_b * t * h
    if kind == "K2a":
        return bound_s(product, 4.0 * (xw + wh + 2 * seq), PEAK_FP32)
    if kind == "K2b":
        return bound_s(2 * product, 4.0 * (2 * xw + wh + 3 * seq), PEAK_FP32)
    raise ValueError(kind)
