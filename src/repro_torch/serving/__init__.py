"""SpMV-traffic serving: admit a matrix once (content-hashed, autotuned,
device-resident), then coalesce concurrent ``y = A @ x`` requests into
``[n, k]`` micro-batches served by one SpMM launch each.

Multi-tenant policy lives in :mod:`repro_torch.serving.qos` (deadline
classes, typed backpressure, weighted-fair flush order) and
:mod:`repro_torch.serving.eviction` (device-memory-budgeted LRU
residency).
"""
from .autotune import (
    AutotuneCache,
    AutotuneResult,
    Probe,
    autotune_partition,
    cg_probe,
    matrix_hash,
    measure_k_tilings,
    pick_k_tiling,
    spmm_probe,
)
from .batcher import MicroBatcher, SpMVRequest
from .engine import ServingEngine, Ticket
from .eviction import LRUEvictor, plan_device_bytes
from .qos import (
    BEST_EFFORT,
    GOLD,
    STANDARD,
    BackpressureError,
    QoSClass,
    WeightedFairScheduler,
)
from .registry import MatrixPlan, MatrixRegistry

__all__ = [
    "AutotuneCache",
    "AutotuneResult",
    "Probe",
    "spmm_probe",
    "cg_probe",
    "measure_k_tilings",
    "pick_k_tiling",
    "autotune_partition",
    "matrix_hash",
    "MicroBatcher",
    "SpMVRequest",
    "ServingEngine",
    "Ticket",
    "MatrixPlan",
    "MatrixRegistry",
    "QoSClass",
    "BackpressureError",
    "WeightedFairScheduler",
    "GOLD",
    "STANDARD",
    "BEST_EFFORT",
    "LRUEvictor",
    "plan_device_bytes",
]
