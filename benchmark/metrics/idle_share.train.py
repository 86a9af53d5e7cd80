"""The card's idle share of the profiled stretch (whole train steps), in
%: 1 - the union of the device's event intervals over the stretch's wall
time."""


def read(w):
    if w.trace is None or not w.trace.device or w.trace.wall_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s() / w.trace.wall_s)
