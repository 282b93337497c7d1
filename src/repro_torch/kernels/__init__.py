# The HBP SpMV/SpMM kernels for Hopper.  hbp_spmv.py holds the wrappers of
# the hand-written CUDA kernels (csrc/*.cu, built at first use by build.py)
# beside their plain PyTorch versions, ops.py the public entry points,
# ref.py the plain references they are checked against (and the argmax
# SpMM's torch chains), autodiff.py the autograd layer (backward = the transpose-tiles
# SpMM; GAT's attention aggregation, whose backward adds the SDDMM of
# csrc/hbp_sddmm.cu).  As in the JAX package, the name ``hbp_spmv`` here is the ops
# entry point; import the kernel module's wrappers with
# ``from repro_torch.kernels.hbp_spmv import``.
from . import autodiff, ops, ref
from .autodiff import PairedTiles, diff_aggregator, hbp_transpose
from .ops import (
    K_BUCKETS,
    DeviceTiles,
    bucket_k,
    device_tiles,
    hbp_spmm,
    hbp_spmm_argmax,
    hbp_spmm_bucketed,
    hbp_spmv,
)

__all__ = [
    "ops",
    "ref",
    "autodiff",
    "DeviceTiles",
    "device_tiles",
    "hbp_spmm",
    "hbp_spmm_argmax",
    "hbp_spmm_bucketed",
    "hbp_spmv",
    "bucket_k",
    "K_BUCKETS",
    "PairedTiles",
    "hbp_transpose",
    "diff_aggregator",
]
