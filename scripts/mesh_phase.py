#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``[mesh]`` phase alone on one CUDA card.

    python3 scripts/mesh_phase.py                        # as in chip_smoke.py
    python3 scripts/mesh_phase.py --arch mamba2-370m     # one model's part
    python3 scripts/mesh_phase.py --smoke [--arch ...]   # the CPU tests' configs: a try-out

Each model's train step (OLMo-1B at 4 layers, granite-moe-1b-a400m at all
24, mamba2-370m at 12 of 48; ``chip_smoke.MESH_MODELS``) on a 2 x 2
``("data", "model")`` mesh of 4 gloo ranks on ``cuda:0``, held to the
world-1 step in float32 and float64 (2 layers), with the placements, the
checkpoint's restore on world 1, the MoE routes and the dry run's
predicted peak beside each rank's; its ``[mesh]`` lines print here with
nothing run before them (no HBP kernel runs on this path, so none is
built).  ``--arch`` may be given more than once.
"""
import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (puts src/ on the path, sets the cuBLAS workspace)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--arch", action="append", choices=[a for a, _ in cs.MESH_MODELS],
                    help="run this model's part (default: every model of MESH_MODELS)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    from repro_torch.analysis.roofline import spec_for

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cs.log(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    cs.mesh_phase(torch.device("cuda"), spec_for(torch.cuda.get_device_name(0)), smi,
                  smoke=args.smoke, archs=args.arch)


if __name__ == "__main__":
    main()
