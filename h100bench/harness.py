"""Finds a cell's pieces by name and turns a driver's outcome into the
result line.

``BENCHMARK.json`` names the cells, configurations and metrics; a cell's
traffic is ``workloads/<cell>.json`` (its configuration, the name of its
driver, its parameters and the limits of its correctness numbers); a
configuration is ``configs/<config>.json``, whose ``arch`` names the
plain reference ``reference/<arch>.py`` and the work counts
``work/<arch>.py``, and whose ``program`` names what the program runs; a
driver is ``drivers/<driver>.py``; a per-layer metric is read by
``layers/<metric>.py``.  Nothing here names a cell, a configuration, an
architecture or a metric: a later one arrives as files and entries.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names the process that prints a result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Context(NamedTuple):
    name: str  # the cell
    cell: dict  # its entry in BENCHMARK.json
    workload: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t0: float  # perf_counter at process start

    def cache_dir(self, what: str) -> str:
        """A fixed directory for a cache of the program's, under TMPDIR."""
        return str(Path(tempfile.gettempdir()) / "h100bench" / what)


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A module of the benchmark's found by file name (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    rel = path.resolve().relative_to(HERE).with_suffix("")
    name = "h100bench_" + "_".join(rel.parts).replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def arch_module(kind: str, config: dict) -> ModuleType:
    """The configuration's architecture file of ``kind`` (``"reference"``
    or ``"work"``): ``<kind>/<arch>.py``."""
    return load_module(HERE / kind / f"{config['arch']}.py")


def cell_files(name: str, bench: dict):
    """The entry, workload and configuration of cell ``name``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    workload = load_json(HERE / "workloads" / f"{name}.json")
    if workload["config"] != cell["config"]:
        raise ValueError(f"{name}: workload file names config {workload['config']!r}, "
                         f"BENCHMARK.json {cell['config']!r}")
    config = load_json(ROOT / configs[cell["config"]]["file"])
    return cell, workload, config


def applies(metric: dict, cell: str, bench: dict) -> bool:
    """Whether ``metric`` is reported in ``cell``: the cells its
    ``workloads`` list, or, without the key, every cell (an end-to-end
    metric) or every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    return any(applies(m, cell, bench) for m in bench["end_to_end"] if m["name"] == moves)


def import_program(root: Path = ROOT) -> ModuleType:
    """``repro_torch`` from the checkout's ``src/``, and from nowhere else."""
    src = root / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise FileNotFoundError(f"the program is not in this checkout ({src / 'repro_torch'})")
    os.environ.setdefault("REPRO_FLIGHT_DIR", str(Path(tempfile.gettempdir()) / "h100bench"
                                                  / "flight"))
    sys.path.insert(0, str(src))
    import repro_torch

    if Path(repro_torch.__file__).resolve().parent != (src / "repro_torch").resolve():
        raise ImportError(f"repro_torch came from {repro_torch.__file__}, not {src}")
    return repro_torch


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def metrics_of(outcome: dict, ctx: Context, bench: dict) -> Dict:
    """The cell's end-to-end metrics, or with ``--trace 1`` its per-layer
    ones (a reader that finds nothing to read leaves its metric out)."""
    out = {}
    if not ctx.trace:
        for m in bench["end_to_end"]:
            if applies(m, ctx.name, bench):
                out[m["name"]] = {"value": outcome["e2e"][m["name"]], "unit": m["unit"]}
        return out
    if outcome["layer"] is None:  # no traced slice (or no card to rate it by)
        return out
    for m in bench["per_layer"]:
        if applies(m, ctx.name, bench):
            value = load_module(HERE / "layers" / f"{m['name']}.py").read(outcome["layer"])
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(outcome: dict, ctx: Context, bench: dict, checks: Dict, device: dict) -> dict:
    """The result line: ``checks`` comes last."""
    from h100bench.check import passes

    line = {
        "correct": passes(checks) and outcome["failed"] == 0,
        "attempted": outcome["attempted"],
        "failed": outcome["failed"],
        "metrics": metrics_of(outcome, ctx, bench),
        "device": device,
    }
    summary = outcome.get("summary")
    if ctx.trace and summary is not None:
        line["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
        line["traced"] = {"steps": outcome["layer"].steps if outcome["layer"] else 0,
                          "device_ops": summary.device_count,
                          "unlaunched": summary.unlaunched}
    line["setup_s"] = outcome["e2e"]["setup_s"]
    line["checks"] = {name: {k: v if math.isfinite(v) else 1e300 for k, v in c.items()}
                      for name, c in checks.items()}
    return line


def device_entry(ctx: Context, outcome: dict) -> dict:
    import torch

    if ctx.device.type == "cuda":
        entry = {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device),
                 "count": int(ctx.cell["chips"])}
    else:
        entry = {"platform": "cpu", "kind": "cpu", "count": 1}
    entry["memory_peak_bytes"] = int(outcome["memory_peak_bytes"])
    summary = outcome.get("summary")
    if ctx.trace and summary is not None:
        entry["busy_s"] = summary.busy_s
        entry["window_s"] = summary.window_s
    return entry


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t0: float,
             workload_patch: Optional[dict] = None) -> dict:
    """One run of cell ``name`` on ``device``: the driver's set-up, window
    and comparison, then the result line (not printed)."""
    from h100bench.check import verdict

    bench = manifest()
    cell, workload, config = cell_files(name, bench)
    if workload_patch:
        workload = {**workload, **workload_patch}
    ctx = Context(name, cell, workload, config, seed, seconds, trace, device, t0)
    driver = load_module(HERE / "drivers" / f"{workload['driver']}.py")
    outcome = driver.run(ctx)
    checks = verdict(outcome["numbers"], workload["limits"])
    return result(outcome, ctx, bench, checks, device_entry(ctx, outcome))
