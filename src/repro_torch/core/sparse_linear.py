"""HBP-backed sparse linear layers — the paper's technique inside the LM.

A pruned linear layer's product is a batch of SpMVs: the weight matrix is
magnitude-sparsified offline, converted once to the HBP tile format (2D
partition + nonlinear hash reordering), staged once on the layer's
device, and applied to each token's activation.

``SparseLinear.apply`` consumes ``x [..., in]`` and returns
``[..., out]`` in float32.  One token runs the fused SpMV (kernel 1 on the
card); several run the fused SpMM (kernel 2) on the ``[in, tokens]``
block.  The SpMV is bit for bit the SpMM's column in this package, so the
block launch gives what the JAX package's ``vmap`` of per-token SpMVs
means.  Backends are named as in the front door (:mod:`.spmv`):
``"cuda"`` (the JAX package's ``"pallas"``) runs strategy ``"fused"``,
whose kernels launch on the card and whose plain versions run on the CPU;
``"torch"`` (the JAX package's ``"jnp"``) runs the einsum oracle
(``"reference"``) on the layer's device.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ops import DeviceTiles

from .formats import csr_from_dense
from .partition import PartitionConfig
from .tile import HBPTiles, build_tiles

__all__ = ["SparseLinear", "magnitude_prune"]

_STRATEGY = {"cuda": "fused", "torch": "reference"}


def magnitude_prune(w: np.ndarray, sparsity: float) -> np.ndarray:
    """Zero the smallest-|w| entries to the requested sparsity."""
    if not 0.0 <= sparsity < 1.0:
        raise ValueError(sparsity)
    k = int(w.size * sparsity)
    if k == 0:
        return w.copy()
    thresh = np.partition(np.abs(w).reshape(-1), k)[k]
    out = w.copy()
    out[np.abs(out) < thresh] = 0.0
    return out


@dataclasses.dataclass
class SparseLinear:
    """y = W_sparse @ x with W in HBP tile format (W: [out, in]), the tiles
    staged once on the layer's device (``dt``)."""

    tiles: HBPTiles
    dt: DeviceTiles
    out_features: int
    in_features: int
    backend: Literal["cuda", "torch"] = "cuda"

    @classmethod
    def from_dense(
        cls,
        w: np.ndarray,  # [out, in]
        *,
        sparsity: float = 0.9,
        cfg: PartitionConfig | None = None,
        backend: Literal["cuda", "torch"] = "cuda",
        device=None,
    ) -> "SparseLinear":
        """Prune ``w`` (as float32) and admit it on ``device`` (default: the card)."""
        if backend not in _STRATEGY:
            raise ValueError(f"unknown backend {backend!r} (expected one of {tuple(_STRATEGY)})")
        cfg = cfg or PartitionConfig(row_block=256, col_block=512)
        pruned = magnitude_prune(np.asarray(w, np.float32), sparsity)
        tiles = build_tiles(csr_from_dense(pruned), cfg, method="hash")
        return cls(tiles, ops.device_tiles(tiles, device), w.shape[0], w.shape[1], backend)

    def apply(self, x) -> torch.Tensor:
        """x: [..., in_features] -> f32 [..., out_features] on the layer's device."""
        x = torch.as_tensor(x, dtype=torch.float32)
        lead = x.shape[:-1]
        flat = x.reshape(-1, self.in_features)
        strategy = _STRATEGY[self.backend]
        if flat.shape[0] == 1:
            y = ops.hbp_spmv(self.dt, flat[0], strategy=strategy)[None]
        else:
            y = ops.hbp_spmm(self.dt, flat.T, strategy=strategy).T
        return y.reshape(*lead, self.out_features)

    def density(self) -> float:
        return float(np.count_nonzero(self.tiles.data)) / (
            self.out_features * self.in_features
        )
