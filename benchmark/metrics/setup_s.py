"""Process start to the first timed call: imports, the card, the model,
the inputs, the detector and its warm-up calls (and, in a checkout's first
run, the kernels' build)."""


def read(r):
    return r.setup_s
