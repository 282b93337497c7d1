"""The model's FLOPs of each forward in the traced slice over the slice's
time at the card's float32 peak (outside the tensor cores), %."""


def read(t):
    if t.steps == 0 or t.window_s <= 0:
        return None
    return 100.0 * t.model_flops * t.steps / (t.window_s * t.peak_flops)
