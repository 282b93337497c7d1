"""The SDDMM's roofline bound (``work/gat.py``: the CSR structure, ȳ and z
read once, ᾱ written once, 2 nnz H C FLOPs) over its device time inside
the program's ``agg.sddmm`` ranges, %; None where the slice holds none."""


def read(t):
    spans = getattr(t, "spans", None)
    if spans is None or t.steps == 0 or "agg.sddmm" not in spans.by_name:
        return None
    device_s = spans.by_name["agg.sddmm"].device_s
    if device_s <= 0:
        return None
    return 100.0 * t.sddmm_bound_s * t.steps / device_s
