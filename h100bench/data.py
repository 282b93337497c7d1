"""Inputs of a cell, made from its parameters and the run's seed.

The graph is an R-MAT (Kronecker) graph at the scale of SuiteSparse
``kron_g500-logn16``, drawn on the device in a few large calls.  Its seed
is part of the workload file, not of ``--seed``: the graph stands in for
a dataset (ogbn-arxiv), which is one fixed graph, and every run of a cell
then does the same work.  Features, labels and weights come from
``--seed``.

The R-MAT recursion is copied from ``repro_torch.core.matrices.rmat``
(Graph500 quadrant probabilities), moved to torch on the device.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch


class Graph(NamedTuple):
    """A binary adjacency in CSR (row = destination), int64 and float32
    tensors on one device."""

    indptr: torch.Tensor
    indices: torch.Tensor
    values: torch.Tensor
    n: int

    @property
    def nnz(self) -> int:
        return int(self.indices.numel())


def rmat_graph(p: dict, device) -> Graph:
    """The R-MAT graph a workload's ``graph`` entry describes: ``log2_nodes``,
    ``edge_factor`` (edges drawn = nodes x factor, halved before mirroring
    when ``symmetric``), ``seed``, and the quadrant probabilities ``a``,
    ``b``, ``c``.  Duplicate edges collapse to one; values are 1."""
    scale = int(p["log2_nodes"])
    n = 1 << scale
    drawn = int(n * float(p["edge_factor"]))
    symmetric = bool(p["symmetric"])
    m = max(1, drawn // 2) if symmetric else drawn
    a, b, c = float(p["a"]), float(p["b"]), float(p["c"])
    g = torch.Generator(device=device).manual_seed(int(p["seed"]))
    rows = torch.zeros(m, dtype=torch.int64, device=device)
    cols = torch.zeros(m, dtype=torch.int64, device=device)
    for level in range(scale):
        r = torch.rand(m, generator=g, dtype=torch.float64, device=device)
        down = r >= a + b
        right = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        rows |= down.to(torch.int64) << level
        cols |= right.to(torch.int64) << level
    if symmetric:
        rows, cols = torch.cat([rows, cols]), torch.cat([cols, rows])
    key = torch.unique(rows * n + cols)  # sorted: row-major CSR order
    rows, cols = key // n, key % n
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return Graph(indptr, cols, torch.ones(cols.numel(), dtype=torch.float32, device=device), n)


def features(gen: torch.Generator, n: int, dim: int, count: int = 0) -> torch.Tensor:
    """Standard normal node features ``[n, dim]``, or ``[count, n, dim]``."""
    shape = (count, n, dim) if count else (n, dim)
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)


def labels(gen: torch.Generator, x: torch.Tensor, classes: int) -> torch.Tensor:
    """A learnable signal: the argmax of the features times a random
    projection."""
    proj = torch.randn((x.shape[1], classes), generator=gen, dtype=torch.float32,
                       device=gen.device)
    return torch.argmax(x @ proj, dim=1)


def weights(gen: torch.Generator, dims: Sequence[int], fields: int,
            bias_scale: float) -> List[Tuple[torch.Tensor, ...]]:
    """One tuple per layer: ``fields - 1`` Glorot-normal ``[d_in, d_out]``
    matrices and a normal bias of std ``bias_scale``, drawn in that order."""
    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        std = (2.0 / (d_in + d_out)) ** 0.5
        mats = torch.randn((fields - 1, d_in, d_out), generator=gen, dtype=torch.float32,
                           device=gen.device) * std
        bias = torch.randn((d_out,), generator=gen, dtype=torch.float32,
                           device=gen.device) * bias_scale
        layers.append((*mats.unbind(0), bias))
    return layers


def program_csr(g: Graph):
    """``g`` as the program's input: its host CSR matrix."""
    from repro_torch.core.formats import CSRMatrix

    return CSRMatrix(g.indptr.cpu().numpy(), g.indices.cpu().numpy(), g.values.cpu().numpy(),
                     (g.n, g.n))

