"""The card's peak rates, and roofline terms over them.

A :class:`HardwareSpec` carries the rates the bandwidth attribution
(:mod:`repro_torch.obs.attribution`) and the explain report divide by:

* ``hbm_bw``     — device-memory bytes per second;
* ``peak_flops`` — float32 operations per second outside the tensor cores,
  the rate the HBP kernels run at (they multiply and add f32 in CUDA
  cores; no tensor-core rate applies to a gather-bound sparse product);
* ``link_bw``    — NVLink bytes per second in one direction;
* ``hbm_bytes``  — device-memory capacity.

The figures are NVIDIA's data-sheet numbers for each part at its full
power limit; a card set below it runs slower under load, so a reading
against these peaks is stated with the card's power limit beside it.
:func:`spec_for` maps a device name (``torch.cuda.get_device_name``,
``nvidia-smi --query-gpu=name``) to its part and raises on a part it does
not know: no figure of another device stands in.  :func:`card_spec`
resolves the caller's card, and raises when there is none.

:class:`RooflineTerms` is the per-call (compute, memory, collective)
decomposition over one spec.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = [
    "HardwareSpec",
    "H100_SXM",
    "H100_PCIE",
    "H100_NVL",
    "H200",
    "SPECS",
    "spec_for",
    "card_spec",
    "RooflineTerms",
]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float  # FLOP/s, float32 outside the tensor cores (the kernels' rate)
    hbm_bw: float  # B/s device memory
    link_bw: float  # B/s NVLink, one direction
    hbm_bytes: float


H100_SXM = HardwareSpec("h100_sxm", 67e12, 3.35e12, 450e9, 80e9)
H100_PCIE = HardwareSpec("h100_pcie", 51e12, 2.0e12, 300e9, 80e9)
H100_NVL = HardwareSpec("h100_nvl", 60e12, 3.9e12, 300e9, 94e9)
H200 = HardwareSpec("h200", 67e12, 4.8e12, 450e9, 141e9)

# (words every one of which the device name holds, spec): the first match
# wins, so the plain "H100" (the SXM part, "NVIDIA H100 80GB HBM3") comes
# after the H100 variants that name themselves
_PARTS = (
    (("H200",), H200),
    (("H100", "PCIe"), H100_PCIE),
    (("H100", "NVL"), H100_NVL),
    (("H100",), H100_SXM),
)
SPECS: Dict[str, HardwareSpec] = {spec.name: spec for _, spec in _PARTS}


def spec_for(device_name: str) -> HardwareSpec:
    """The spec of the part ``device_name`` names (a CUDA device name, or a
    spec's own ``name`` such as ``"h100_sxm"``); raises ``ValueError`` for
    a part this table does not hold."""
    if device_name in SPECS:
        return SPECS[device_name]
    words = device_name.split()
    for part, spec in _PARTS:
        if all(w in words for w in part):
            return spec
    raise ValueError(
        f"no peak rates known for device {device_name!r} "
        f"(known parts: {', '.join(sorted(SPECS))}); pass hw= explicitly"
    )


def card_spec(device=None) -> HardwareSpec:
    """The spec of the card ``device`` names (default: the current card);
    raises ``RuntimeError`` when no CUDA card is present."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"peak rates are per CUDA card; got device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available to take peak rates from; pass hw= "
            "(a HardwareSpec, or spec_for(<device name>)) explicitly"
        )
    return spec_for(torch.cuda.get_device_name(dev))


@dataclasses.dataclass
class RooflineTerms:
    flops: float  # per device
    bytes: float  # per device memory traffic
    coll_bytes: float  # per device wire bytes
    hw: HardwareSpec

    @property
    def t_compute(self) -> float:
        return self.flops / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.hw.link_bw

    @property
    def bottleneck(self) -> str:
        ts = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(ts, key=ts.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> Dict[str, float]:
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes,
            "coll_bytes_per_device": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
        }
