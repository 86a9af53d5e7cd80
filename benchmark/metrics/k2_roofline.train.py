"""K2a's and K2b's share of their roofline in the profiled stretch, in %:
the least time of each step's launches (every BiLSTM layer over the batch,
both directions, forward and backward) over the device time of the events
named ``lstm_recurrence_kernel`` and ``lstm_recurrence_bwd_kernel``."""

from benchmark.common.work import recurrence_bound_s


def read(w):
    if w.trace is None or not w.traced_steps:
        return None
    spent = w.trace.seconds_matching("lstm_recurrence_kernel", "lstm_recurrence_bwd_kernel")
    two_b = 2 * w.batch
    least = w.traced_steps * sum(recurrence_bound_s(two_b, w.frames, h, "K2a")
                                 + recurrence_bound_s(two_b, w.frames, h, "K2b")
                                 for h in w.reference.recurrences(w.model))
    return 100.0 * least / spent if spent > 0 else None
