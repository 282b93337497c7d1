"""Device ms a step spends on operations launched inside aggregation,
forward and backward."""


def read(t):
    if t.steps == 0 or t.agg_device_s <= 0:
        return None
    return 1e3 * t.agg_device_s / t.steps
