"""The work of one train step or forward, counted by operation: the
pieces here, and for each architecture a file ``work/<arch>.py`` whose
``nnz(graph)`` counts the entries of the matrix it aggregates over and
whose ``step_work(dims, n, nnz, train)`` lists the operations of one step,
``{"aggregation": [Work, ...], "dense": [Work, ...]}``.

Counts are those of the operations the model needs, not of the way the
program implements them, so a new tile format or kernel cannot move the
yardstick (``chip_smoke.kernel_bytes`` counted the tile arrays instead):

* an SpMM reads the matrix once as CSR (float32 values, int32 columns,
  int32 row pointers) and x once, and writes each output once: y, and
  for the max with its winners also idx and coeff; ``2 nnz k`` FLOPs;
* the backward of a sum is the same product over the transpose; the max
  backward reads ȳ, idx and coeff once and writes x̄ once, ``2 n k``
  FLOPs;
* a dense product ``[m, k] @ [k, n]`` is ``2 m k n`` FLOPs and reads and
  writes each operand once; a train step adds the backward products it
  needs (the weight gradients of every layer, the input gradients of every
  layer but the first).

Elementwise work (bias, activation, loss, optimizer) is not counted.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

F32 = I32 = 4


class Work(NamedTuple):
    flops: float
    bytes: float

    def bound_s(self, peaks) -> float:
        """The least time the card could take: the larger of the FLOPs over
        the float32 peak and the bytes over the memory bandwidth."""
        return max(self.flops / peaks.fp32_flops, self.bytes / peaks.hbm_bytes)


def spmm(n_rows: int, n_cols: int, nnz: int, k: int, outputs: int = 1) -> Work:
    csr = nnz * (F32 + I32) + (n_rows + 1) * I32
    return Work(2.0 * nnz * k, csr + n_cols * k * F32 + outputs * n_rows * k * F32)


def max_backward(n_rows: int, n_cols: int, k: int) -> Work:
    return Work(2.0 * n_rows * k, 3 * n_rows * k * F32 + n_cols * k * F32)


def matmul(m: int, k: int, n: int) -> Work:
    return Work(2.0 * m * k * n, (m * k + k * n + m * n) * F32)


def total(works: Sequence[Work]) -> Work:
    return Work(sum(w.flops for w in works), sum(w.bytes for w in works))


def bound_s(works: Sequence[Work], peaks) -> float:
    """The sum of each operation's own bound."""
    return sum(w.bound_s(peaks) for w in works)
