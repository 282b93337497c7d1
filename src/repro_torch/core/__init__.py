# Host-side admission of the HBP pipeline — 2D partitioning, nonlinear hash
# reordering, tile construction, mixed-execution scheduling — in numpy.
# The SpMV front door (``spmv``/``spmm`` over CSR/HBP inputs) is not part
# of this package yet.
from .formats import COOMatrix, CSRMatrix, csr_from_coo, csr_from_dense
from .hash import HashParams, hash_reorder, hash_slot, sample_params
from .partition import Partition2D, PartitionConfig, enumerate_configs
from .reorder import REORDER_METHODS, group_stddev, padding_waste
from .schedule import Schedule, contiguous_schedule, lpt_schedule, mixed_schedule
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
    "HBPTiles",
    "build_tiles",
    "tiles_from_arrays",
    "tuned_partition_config",
]
