"""The card's peak of allocated memory over the window (the caching
allocator's ``max_memory_allocated`` after a reset at the window's start),
in GiB."""


def read(w):
    return w.peak_bytes / 2**30 if w.peak_bytes else None
