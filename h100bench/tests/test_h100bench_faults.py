"""Runs of every cell on the CPU at a small size, past the harness's look
for a card: sound, the result line is correct; with a fault planted in the
program underneath, or the TF32 control in its place, it is not."""
import json
import subprocess
import sys
import time

import pytest
import torch

from h100bench import check, harness
from h100bench.faults import FAULTS, planted

CELLS = [c["name"] for c in harness.manifest()["workloads"]]
SMALL = {"log2_nodes": 8, "edge_factor": 8.0}


def small(name):
    wl = harness.load_json(harness.HERE / "workloads" / f"{name}.json")
    return {"graph": {**wl["graph"], **SMALL}}


def run(name, seed=7, trace=False):
    harness.import_program()
    return harness.run_cell(name, seed, 0.3, trace, torch.device("cpu"), time.perf_counter(),
                            workload_patch=small(name))


def driver_of(name):
    wl = harness.load_json(harness.HERE / "workloads" / f"{name}.json")
    return harness.load_module(harness.HERE / "drivers" / f"{wl['driver']}.py")


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    line = run(name, seed=2 ** 31 + 12345)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert json.loads(json.dumps(line)) == line


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS for f in FAULTS])
def test_a_planted_fault_is_not_correct(name, fault):
    if fault not in driver_of(name).FAULTS:
        pytest.skip(f"the cell's driver cannot have the fault {fault!r}")
    with planted(fault):
        line = run(name)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_is_not_correct(name):
    harness.import_program()
    bench = harness.manifest()
    cell, workload, config = harness.cell_files(name, bench)
    workload = {**workload, **small(name)}
    ctx = harness.Context(name, cell, workload, config, 5, 0.3, False, torch.device("cpu"),
                          time.perf_counter())
    driver = driver_of(name)
    got, numbers, _ = driver.readings(driver.Cell(ctx), 5, 0.3, True)
    assert check.passes(check.verdict(got, workload["limits"])), got
    assert not check.passes(check.verdict(numbers, workload["limits"])), numbers


def test_the_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "h100bench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_command_refuses_without_the_program(tmp_path):
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "h100bench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "program" in out.stderr
