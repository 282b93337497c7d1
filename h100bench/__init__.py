"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on an NVIDIA
H100: ``python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout.  See ``harness`` for how a
cell's pieces are found by name."""
