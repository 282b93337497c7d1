"""PyTorch/CUDA port of the HBP SpMV system (the JAX package ``repro`` is
the reference it is held against).

Layout mirrors ``repro``: ``core`` (host-side admission: CSR, 2D
partition, nonlinear hash reorder, packed tiles; the ``spmv``/``spmm``
front door; the sharded SpMV on ``torch.distributed``), ``kernels``
(device staging, the hand-written Hopper kernels and their plain PyTorch
versions, the argmax SpMM and the autograd layer), ``graph``
(adjacencies, aggregation, GCN/GraphSAGE, and ``graph.train``: sampling,
losses, the trainer), ``optim`` (AdamW), ``solvers`` (CG, BiCGSTAB,
Chebyshev, power iteration, PageRank and the Jacobi preconditioners over
the kernels), ``obs`` (telemetry, the dashboard and the OpenMetrics
exporter), ``analysis`` (the card's peak rates, diffs of dumps, the
report CLI) and ``serving`` (registry + micro-batching engine).  Entry
points run on the card unless the caller passes ``device="cpu"``.
"""
