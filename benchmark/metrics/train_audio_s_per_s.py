"""Seconds of audio trained a second: every step completed in the window
times its rows times a chunk's length, over the window (host clock)."""


def read(w):
    if not w.batch or not w.seconds:
        return None
    return w.steps * w.batch * w.chunk_s / w.seconds
