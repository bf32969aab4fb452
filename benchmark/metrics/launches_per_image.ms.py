"""Kernels launched on the card per image completed in the traced window."""


def read(r):
    if r.trace is None or not r.images:
        return None
    return r.trace.kernels / r.images
