#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``[lm]`` phase alone on one CUDA card.

    python3 scripts/lm_phase.py

Builds the kernels, then serves OLMo-1B at full width through the engine,
holds its cached decode to a full forward (float64), prunes and admits
the 48 FFN projections and times them, as the phase does inside the whole
script; its ``[lm]`` lines print here with nothing run before them.
"""
import importlib
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    from repro_torch.analysis.roofline import spec_for
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cs.log(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s")
    K = importlib.import_module("repro_torch.kernels.hbp_spmv")
    wrappers = {name: getattr(K, name) for name in cs.KERNELS}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    counts, _ = cs.lm_phase(torch.device("cuda"), spec_for(torch.cuda.get_device_name(0)), smi,
                         reset_counts, lambda names: {n: wrappers[n].launches for n in names})
    cs.log(f"[lm] kernel launches: {counts}")


if __name__ == "__main__":
    main()
