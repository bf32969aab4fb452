"""The whole call's share of the card's float32 peak outside the tensor
cores (%), on the multi-scale model: the cascade's counted operations on
the traced calls' images (reference_ms.counted_ops, which is
reference.counted_ops) over the traced wall time times 67e12."""

from benchmark.yardstick import FP32_OPS_PER_S


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * r.traced_ops / (r.trace.window_s * FP32_OPS_PER_S)
