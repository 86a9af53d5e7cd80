"""The window's share of the card's bfloat16 peak, in %: a step's model
operations (3x the forward's, the configuration's count, times the rows),
times the steps outside the profiled stretch, over their time."""

from benchmark.common.device import PEAK_BF16


def read(w):
    steps = w.steps - w.traced_steps
    seconds = w.seconds - w.traced_s
    if not w.batch or steps <= 0 or seconds <= 0:
        return None
    flops = 3.0 * w.batch * w.reference.forward_flops(w.model, w.frames)
    return 100.0 * steps * flops / seconds / PEAK_BF16
