"""Set-up: from the process's start to the window's, in seconds (host
clock): imports, inputs and weights, loading, warming every shape."""


def read(w):
    return w.setup_s
