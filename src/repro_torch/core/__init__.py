# The paper's primary contribution: the Hash-Based Partition (HBP) SpMV
# pipeline — 2D partitioning, nonlinear hash reordering, tile construction,
# mixed-execution scheduling (host side, numpy) — and the SpMV front door
# (``spmv``/``spmm`` over CSR, HBP and tile inputs) with the CSR baselines
# it is evaluated against.
from .formats import COOMatrix, CSRMatrix, csr_from_coo, csr_from_dense
from .hash import HashParams, hash_reorder, hash_slot, sample_params
from .hbp import HBPMatrix, build_hbp, hbp_spmv_reference
from .partition import Partition2D, PartitionConfig, enumerate_configs
from .reorder import REORDER_METHODS, group_stddev, padding_waste
from .schedule import Schedule, contiguous_schedule, lpt_schedule, mixed_schedule
from .spmv import csr_spmm_torch, csr_spmv_torch, spmm, spmv
from .tile import HBPTiles, build_tiles, tiles_from_arrays, tuned_partition_config

__all__ = [
    "COOMatrix",
    "CSRMatrix",
    "csr_from_coo",
    "csr_from_dense",
    "HashParams",
    "hash_reorder",
    "hash_slot",
    "sample_params",
    "HBPMatrix",
    "build_hbp",
    "hbp_spmv_reference",
    "Partition2D",
    "PartitionConfig",
    "enumerate_configs",
    "REORDER_METHODS",
    "group_stddev",
    "padding_waste",
    "Schedule",
    "contiguous_schedule",
    "lpt_schedule",
    "mixed_schedule",
    "csr_spmv_torch",
    "csr_spmm_torch",
    "spmv",
    "spmm",
    "HBPTiles",
    "build_tiles",
    "tiles_from_arrays",
    "tuned_partition_config",
]
