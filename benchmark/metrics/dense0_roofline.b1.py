"""The dense stage-0 filter's share of its roofline (%): its least time
(yardstick.ladder_bound over the reference's cart visits on the same
images) over the profiled time of its head and survivor kernels, summed
over the traced calls."""


def read(r):
    if r.trace is None or r.trace.dense0_s <= 0:
        return None
    return 100.0 * r.dense0_bound_s / r.trace.dense0_s
