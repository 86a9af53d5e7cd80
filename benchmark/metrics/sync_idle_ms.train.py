"""The card's idle time a step waiting on the guard's read and on Adam's
launch, in ms: the profiled stretch's idle gaps whose middle falls in the
program's ``train.host_read`` or ``train.update`` span, over the
stretch's steps. None when the trace has neither span."""

SPANS = ("train.host_read", "train.update")


def read(w):
    if w.trace is None or not w.trace.device or not w.traced_steps:
        return None
    held = [(e.start_ns, e.end_ns) for e in w.trace.host if e.name in SPANS]
    if not held:
        return None
    idle = sum(sec for sec, a, b in w.trace.idle_gaps()
               if any(s <= (a + b) // 2 <= e for s, e in held))
    return 1e3 * idle / w.traced_steps
