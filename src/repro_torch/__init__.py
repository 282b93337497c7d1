"""PyTorch/CUDA port of the HBP SpMV system (the JAX package ``repro`` is
the reference it is held against).

Layout mirrors ``repro``: ``core`` (host-side admission: CSR, 2D
partition, nonlinear hash reorder, packed tiles), ``kernels`` (device
staging, the hand-written Hopper kernels and their plain PyTorch
versions), ``obs`` (telemetry) and ``serving`` (registry + micro-batching
engine).  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
