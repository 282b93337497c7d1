"""The nonlinear hash at the heart of the HBP format (paper §III-B, Fig. 3).

The hash takes the number of nonzero elements of a row as input and produces
the row's slot in a per-block hash table whose index order *is* the execution
order.  It decomposes into three stages:

* **Aggregation** — a nonlinear map that sends rows with *similar* nnz to the
  same bucket.  The paper uses a cheap bit shift ``nnz >> a`` and artificially
  clips the bucket range to ``[0, n_buckets)`` (= 9 in the paper, "0 to 8");
  rows that overflow are treated as bucket ``n_buckets - 1``.
* **Dispersion** — spreads each bucket to a disjoint region of the hash
  table: bucket ``k`` owns slots ``[k*c, (k+1)*c)``.  ``c`` is sampled from
  the input matrix together with ``a``.
* **Linear mapping** — a fine adjustment *within* the region to reduce
  collisions; the paper exemplifies it with a modulo.  Residual collisions
  are resolved by linear probing (atomic CAS on the GPU; here a sequential
  reference and a vectorised rank-based equivalent).

Parameters ``a`` and ``c`` are sampled from the matrix at runtime;
``b`` (table size = row-partition size) and ``d`` (linear-map modulus) are
fixed before the run — exactly the split described in the paper.

Two implementations are provided:

* :func:`hash_insert_probe` — the faithful GPU semantics: slots are claimed
  in thread order with linear probing.  Used as the reference oracle.
* :func:`hash_insert_ranked` — a vectorised, order-equivalent variant: rows
  are placed at ``slot0 + rank`` where ``rank`` is the row's position among
  all rows hashing to the same initial slot.  This is the data-parallel
  formulation used on TPU (no atomics on the vector unit), and produces the
  same *grouping* (bucket-contiguous execution order) as probing.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "HashParams",
    "sample_params",
    "hash_slot",
    "hash_insert_probe",
    "hash_insert_ranked",
    "hash_reorder",
]

N_BUCKETS = 9  # the paper maps "most numbers of nonzero elements" to 0..8


@dataclasses.dataclass(frozen=True)
class HashParams:
    """Parameters of the nonlinear hash h(nnz) (Fig. 3).

    ``a``/``c`` are *sampled* per matrix; ``b``/``d`` are fixed pre-run.
    """

    a: int  # aggregation shift: bucket = min(nnz >> a, n_buckets - 1)
    c: int  # dispersion stride: bucket k owns table slots [k*c, (k+1)*c)
    b: int  # table size == row-partition size (paper: 512)
    d: int  # linear-map modulus for the in-region fine adjustment
    n_buckets: int = N_BUCKETS


def sample_params(
    row_nnz: np.ndarray,
    table_size: int,
    *,
    quantile: float = 0.99,
    n_buckets: int = N_BUCKETS,
) -> HashParams:
    """Sample ``a`` and ``c`` from the input (paper: "a and c are dynamically
    determined based on the input matrix and sampled during program
    execution").

    ``a`` is chosen as the smallest shift such that the ``quantile`` heaviest
    row still lands inside the bucket range — "we allowed the existence of a
    small number of rows that exceed 8 after mapping".
    """
    nz = row_nnz[row_nnz > 0]
    if nz.size == 0:
        hi = 1.0
    else:
        hi = float(np.quantile(nz, quantile))
    a = 0
    while (int(hi) >> a) >= n_buckets:
        a += 1
    c = max(1, table_size // n_buckets)
    d = c  # fixed pre-run from the row-partition size, like b
    return HashParams(a=a, c=c, b=table_size, d=d, n_buckets=n_buckets)


def hash_slot(nnz: np.ndarray, p: HashParams) -> np.ndarray:
    """h(nnz): initial table slot before collision resolution.

    aggregation → dispersion → linear mapping, all O(1) per row and
    independent across rows (this is what makes the preprocessing parallel).
    """
    nnz = np.asarray(nnz)
    bucket = np.minimum(nnz >> p.a, p.n_buckets - 1)  # aggregation (clipped)
    base = bucket * p.c  # dispersion
    fine = (nnz % p.d) % p.c  # linear mapping within the region
    return np.minimum(base + fine, p.b - 1)


def hash_insert_probe(slot0: np.ndarray, table_size: int) -> np.ndarray:
    """Faithful linear-probing insertion (GPU atomic-CAS semantics).

    Rows are inserted in index order; each probes ``slot0, slot0+1, ...``
    (mod table) until a free slot is found.  Returns ``slots[i]`` = final
    table slot of row ``i``.  O(rows · probe-length) reference — the oracle
    the vectorised variant is validated against.
    """
    taken = np.zeros(table_size, dtype=bool)
    slots = np.empty(slot0.size, dtype=np.int64)
    for i, s in enumerate(slot0):
        s = int(s)
        while taken[s]:
            s = (s + 1) % table_size
        taken[s] = True
        slots[i] = s
    return slots


def hash_insert_ranked(slot0: np.ndarray, table_size: int) -> np.ndarray:
    """Vectorised collision resolution: row i goes to position
    ``rank`` among rows sorted by (slot0, i).

    Equivalent to probing in the dense limit (every slot eventually filled)
    and produces the same bucket-contiguous ordering; fully data-parallel
    (one stable counting-sort-by-key, no atomics), which is the TPU-native
    formulation of the paper's hash+probe.
    """
    if slot0.size > table_size:
        raise ValueError("more rows than table slots")
    order = np.argsort(slot0, kind="stable")  # counting sort by initial slot
    slots = np.empty(slot0.size, dtype=np.int64)
    slots[order] = np.arange(slot0.size)
    return slots


def hash_reorder(
    row_nnz: np.ndarray,
    params: HashParams | None = None,
    *,
    method: str = "ranked",
) -> np.ndarray:
    """Full hash-based reordering of one row block.

    Returns ``perm`` with ``perm[slot] = original_row`` — the paper's
    ``output_hash`` read the other way around: position in ``perm`` is the
    execution order, the value is the row computed at that position.
    """
    row_nnz = np.asarray(row_nnz)
    if params is None:
        params = sample_params(row_nnz, table_size=row_nnz.size)
    slot0 = hash_slot(row_nnz, params)
    if method == "probe":
        slots = hash_insert_probe(slot0, params.b)
    elif method == "ranked":
        slots = hash_insert_ranked(slot0, min(params.b, slot0.size) if slot0.size else params.b)
    else:
        raise ValueError(f"unknown method {method!r}")
    if method == "probe":
        # compress occupied slots to a dense execution order
        order = np.argsort(slots, kind="stable")
        return order
    perm = np.empty(slot0.size, dtype=np.int64)
    perm[slots] = np.arange(slot0.size)
    return perm
