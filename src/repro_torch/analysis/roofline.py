"""The card's peak rates, and roofline terms over them.

A :class:`HardwareSpec` carries the rates the bandwidth attribution
(:mod:`repro_torch.obs.attribution`) and the explain report divide by:

* ``hbm_bw``     — device-memory bytes per second;
* ``peak_flops`` — float32 operations per second outside the tensor cores,
  the rate the HBP kernels run at (they multiply and add f32 in CUDA
  cores; no tensor-core rate applies to a gather-bound sparse product);
* ``link_bw``    — NVLink bytes per second in one direction;
* ``hbm_bytes``  — device-memory capacity;
* ``bf16_flops`` — dense bf16 tensor-core operations per second, the rate
  the LM roofline's compute term divides by.

The figures are NVIDIA's data-sheet numbers for each part at its full
power limit; a card set below it runs slower under load, so a reading
against these peaks is stated with the card's power limit beside it.
:func:`spec_for` maps a device name (``torch.cuda.get_device_name``,
``nvidia-smi --query-gpu=name``) to its part and raises on a part it does
not know: no figure of another device stands in.  :func:`card_spec`
resolves the caller's card, and raises when there is none.

:class:`RooflineTerms` is the per-call (compute, memory, collective)
decomposition over one spec.  :func:`parse_collective_bytes` reads the
collective wire bytes of an optimized HLO text, as the JAX package's does,
so that the two packages' dry-run records can be read side by side;
:func:`roofline_from_costs` extrapolates a step's costs from its 1-group
and 2-group unrolled versions: ``per_group = c(2) - c(1)``, ``base = c(1)
- per_group``, ``total = base + n_groups * per_group``.  Collective wire
bytes use ring factors on the group size g: all-reduce 2·(g−1)/g·result,
all-gather (g−1)/g·result, reduce-scatter (g−1)·result (result is the
scattered shard), all-to-all (g−1)/g·result, collective-permute 1·result.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

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
    "parse_collective_bytes",
    "roofline_from_costs",
]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float  # FLOP/s, float32 outside the tensor cores (the kernels' rate)
    hbm_bw: float  # B/s device memory
    link_bw: float  # B/s NVLink, one direction
    hbm_bytes: float
    bf16_flops: float = 0.0  # FLOP/s, dense bf16 on the tensor cores (0: not known)


H100_SXM = HardwareSpec("h100_sxm", 67e12, 3.35e12, 450e9, 80e9, 989e12)
H100_PCIE = HardwareSpec("h100_pcie", 51e12, 2.0e12, 300e9, 80e9, 756e12)
H100_NVL = HardwareSpec("h100_nvl", 60e12, 3.9e12, 300e9, 94e9, 835e12)
H200 = HardwareSpec("h200", 67e12, 4.8e12, 450e9, 141e9, 989e12)

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


_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def _shape_bytes(shape_str: str) -> float:
    m = _SHAPE_RE.match(shape_str)
    if not m:
        return 0.0
    dt, dims = m.groups()
    size = _DTYPE_BYTES.get(dt, 4)
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return float(size * n)


def _group_size(line: str, world: int) -> int:
    # explicit groups: replica_groups={{0,1,2},{...}}
    m = re.search(r"replica_groups=\{\{([^}]*)\}", line)
    if m:
        return len([t for t in m.group(1).split(",") if t.strip() != ""])
    # iota format: replica_groups=[32,16]<=[512] -> group size = dims[-1]
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]", line)
    if m:
        return int(m.group(2))
    return world


def _wire_bytes(kind: str, result_bytes: float, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    if kind == "collective-permute":
        return result_bytes
    return 0.0


def _split_computations(hlo: str) -> Dict[str, str]:
    """computation name -> body text, from optimized HLO."""
    comps: Dict[str, List[str]] = {}
    cur: Optional[str] = None
    for line in hlo.splitlines():
        m = re.match(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*\(.*\)\s*->.*\{", line)
        if m:
            cur = m.group(1)
            comps[cur] = []
        elif cur is not None:
            comps[cur].append(line)
    return {k: "\n".join(v) for k, v in comps.items()}


def parse_collective_bytes(
    hlo: str, *, world: int, default_trip: int = 1
) -> Tuple[float, Dict[str, float]]:
    """Total per-device collective wire bytes (+ per-kind breakdown).

    Collectives inside scan bodies are weighted by the enclosing whiles'
    ``known_trip_count`` (falling back to ``default_trip``); nesting
    composes multiplicatively.
    """
    comps = _split_computations(hlo)
    # weight per computation: entry-reachable while bodies get trip factors
    weights: Dict[str, float] = {name: 1.0 for name in comps}
    # build parent -> (body, trips) and propagate breadth-first
    edges: Dict[str, List[Tuple[str, int]]] = {name: [] for name in comps}
    for name, body in comps.items():
        for line in body.splitlines():
            if " while(" in line:
                mb = re.search(r"body=%?([\w\.\-]+)", line)
                mc = re.search(r"condition=%?([\w\.\-]+)", line)
                mt = re.search(
                    r'known_trip_count[\'"]?\s*:\s*\{\s*[\'"]n[\'"]\s*:\s*[\'"](\d+)[\'"]', line
                )
                trips = int(mt.group(1)) if mt else default_trip
                if mb:
                    edges[name].append((mb.group(1), trips))
                if mc:
                    edges[name].append((mc.group(1), 1))
    # propagate weights topologically (HLO call graph is acyclic)
    changed = True
    it = 0
    while changed and it < 64:
        changed = False
        it += 1
        for parent, childs in edges.items():
            for child, trips in childs:
                w = weights.get(parent, 1.0) * trips
                if child in weights and abs(weights[child] - w) > 1e-9 and w > weights[child]:
                    weights[child] = w
                    changed = True

    total = 0.0
    by_kind: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    for name, body in comps.items():
        w = weights.get(name, 1.0)
        for line in body.splitlines():
            for kind in _COLLECTIVES:
                # result-typed op: "%x = TYPE[shape] kind(" or fused start
                m = re.search(r"=\s*(?:\()?(\w+\[[\d,]*\])[^=]*\s" + kind + r"(?:-start|-done)?\(", line)
                if m and f" {kind}" in line:
                    rb = _shape_bytes(m.group(1))
                    # tuple results: sum every typed buffer in the tuple
                    tup = re.search(r"=\s*\(([^)]*)\)\s*" + kind, line)
                    if tup:
                        rb = sum(_shape_bytes(s) for s in re.findall(r"\w+\[[\d,]*\]", tup.group(1)))
                    g = _group_size(line, world)
                    wb = _wire_bytes(kind, rb, g) * w
                    total += wb
                    by_kind[kind] += wb
                    break
    return total, by_kind


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


def roofline_from_costs(
    c1: Dict[str, float],
    c2: Dict[str, float],
    n_groups: int,
    coll_bytes: float,
    hw: HardwareSpec,
) -> RooflineTerms:
    """Linear extrapolation from 1-group and 2-group unrolled costs."""

    def extrap(key: str) -> float:
        per = c2.get(key, 0.0) - c1.get(key, 0.0)
        base = c1.get(key, 0.0) - per
        return max(base + n_groups * per, 0.0)

    return RooflineTerms(extrap("flops"), extrap("bytes accessed"), coll_bytes, hw)
