"""A matrix whose tiles form row-group runs of chosen lengths (numpy only).

Shared by the port's CPU and card tests of the fused kernels' chunk
index.  Under :data:`hub_config` (row blocks of two groups, one tile per
column block per row) a row block holding one nonzero row with ``lane``
entries in each of ``L`` column blocks owns one run of exactly ``L``
tiles, and its other row group owns none.
"""
import numpy as np


def hub_config(lane: int) -> dict:
    """Partition settings under which a row's tiles are its column blocks."""
    return dict(row_block=16, col_block=max(16, lane), group=8, lane=lane)


def hub_coo(run_chunk: int, lane: int, seed: int = 0):
    """``(rows, cols, vals, shape)`` of a matrix with, in row-block order:
    a hub run of ``4 * run_chunk + 5`` tiles, runs of exactly
    ``run_chunk`` and ``run_chunk + 1`` tiles, two one-tile runs, an empty
    row block, and random rows whose runs vary in length.  Every row
    block but the empty one also has an empty row group."""
    rng = np.random.default_rng(seed)
    cb = hub_config(lane)["col_block"]
    runs = [4 * run_chunk + 5, run_chunk, run_chunk + 1, 1, 1, 0]
    n_blocks = runs[0] + 1
    rows, cols = [], []
    for b, length in enumerate(runs):
        blocks = rng.choice(n_blocks, size=length, replace=False)
        c = (blocks[:, None] * cb + np.arange(lane)).ravel()
        rows.append(np.full(c.size, 16 * b + int(rng.integers(16))))
        cols.append(c)
    n_rows = 16 * (len(runs) + 10)
    for r in range(16 * len(runs), n_rows):
        if rng.random() < 0.5:  # leave rows, and so some row groups, empty
            continue
        c = rng.choice(n_blocks * cb, size=int(rng.integers(1, 6 * lane)), replace=False)
        rows.append(np.full(c.size, r))
        cols.append(c)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals, (n_rows, n_blocks * cb)
