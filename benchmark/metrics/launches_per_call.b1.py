"""Kernels launched on the card per call of the traced window."""


def read(r):
    if r.trace is None or not r.calls:
        return None
    return r.trace.kernels / r.calls
