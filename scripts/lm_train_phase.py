#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``[lm-train]`` phase alone on one CUDA card.

    python3 scripts/lm_train_phase.py

Trains OLMo-1B at full width and depth for 8 steps through ``Trainer``,
then 2 steps with int8 moments, then at 2 layers holds a float32 step to
float64 and checks remat, microbatching and a restart, as the phase does
inside the whole script (no HBP kernel runs on this path, so none is
built); its ``[lm-train]`` lines print here with nothing run before them.
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (puts src/ on the path, sets the cuBLAS workspace)


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cs.log(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    cs.lm_train_phase(torch.device("cuda"), smi)


if __name__ == "__main__":
    main()
