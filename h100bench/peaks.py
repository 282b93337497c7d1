"""The peak rates of the card the benchmark runs on, frozen here.

Copied from ``repro_torch.analysis.roofline`` (``H100_SXM``): NVIDIA's data
sheet for the H100 SXM, dense rates, at the full power limit.
``fp32_flops`` is the float32 rate outside the tensor cores.  The
benchmark runs on that card alone; any other raises.
"""
from __future__ import annotations

from typing import NamedTuple


class Peaks(NamedTuple):
    name: str
    fp32_flops: float  # FLOP/s
    hbm_bytes: float  # bytes/s


H100_SXM = Peaks("h100_sxm", 67e12, 3.35e12)
# the names torch.cuda.get_device_name() gives the H100 SXM
H100_SXM_NAMES = ("NVIDIA H100 80GB HBM3",)


def peaks_for(device_name: str) -> Peaks:
    """The H100 SXM's peaks; raises ``ValueError`` for any other card."""
    if device_name in H100_SXM_NAMES:
        return H100_SXM
    raise ValueError(f"no peak rates for {device_name!r}: the benchmark knows the H100 SXM "
                     f"alone ({', '.join(H100_SXM_NAMES)})")
