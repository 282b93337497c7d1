"""Device ms a step spends on operations launched inside the program's
``agg.attention`` ranges (the edge scores, the softmax and the rewrite of
A's tile values) and ``agg.attention_backward`` ranges (the rewrite of
Aᵀ's, the softmax's backward and the score gradients); None where the
slice holds neither."""


def read(t):
    spans = getattr(t, "spans", None)
    if spans is None or t.steps == 0:
        return None
    found = [spans.by_name[name] for name in ("agg.attention", "agg.attention_backward")
             if name in spans.by_name]
    if not found:
        return None
    return 1e3 * sum(s.device_s for s in found) / t.steps
