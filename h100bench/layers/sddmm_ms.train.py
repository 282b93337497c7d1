"""Device ms a step spends on operations launched inside the program's
``agg.sddmm`` ranges (the attention gradient's SDDMM kernel); None where
the slice holds none."""


def read(t):
    spans = getattr(t, "spans", None)
    if spans is None or t.steps == 0 or "agg.sddmm" not in spans.by_name:
        return None
    return 1e3 * spans.by_name["agg.sddmm"].device_s / t.steps
