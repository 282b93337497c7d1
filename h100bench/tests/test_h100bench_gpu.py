"""On the card: a cell at a small size through the command line is
correct, and its TF32 control, at the same size, is not.  Skips without a
card (decided inside each test)."""
import json
import subprocess
import sys

import pytest
import torch

from h100bench import harness

CELLS = [c["name"] for c in harness.manifest()["workloads"]]


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_calibration_at_a_small_size_separates_program_and_control(name):
    needs_card()
    out = subprocess.run([sys.executable, "-m", "h100bench.calibrate", "--workload", name,
                          "--seeds", "1", "2", "--size", "12"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])["summary"]
    limits = harness.load_json(harness.HERE / "workloads" / f"{name}.json")["limits"]
    assert all(summary[k]["lower"] <= v for k, v in limits.items()), summary
    assert any(summary[k]["control"] > v for k, v in limits.items()), summary
