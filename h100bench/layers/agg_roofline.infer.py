"""The aggregation's roofline bound (by operation: CSR, x and the outputs
once, 2 nnz k FLOPs) over its device time, %."""


def read(t):
    if t.steps == 0 or t.agg_device_s <= 0:
        return None
    return 100.0 * t.agg_bound_s * t.steps / t.agg_device_s
