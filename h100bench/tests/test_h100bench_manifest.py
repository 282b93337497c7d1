"""BENCHMARK.json against the benchmark's contract, and every piece a cell
needs found by name."""
import json
import re
from pathlib import Path

import pytest
import torch

from h100bench import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
# words of a width: never cut (see the contract's `reduced`)
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head",
               "expansion", "experts_per_tok", "channels")


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line_ok(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_have_their_keys_and_allowed_names(section):
    key = {"configs": "config", "workloads": "workload"}.get(section, section)
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        allowed = KEYS[key] | ({"workloads"} if section in ("end_to_end", "per_layer") else set())
        assert KEYS[key] <= set(e) <= allowed, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for field in ("why", "layer", "source"):
            if field in e and section in ("configs", "workloads", "per_layer"):
                assert line_ok(e[field]), (e["name"], field)


def test_configs_files_and_reductions():
    assert 1 <= len(BENCH["configs"]) <= 24
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        for k in c["reduced"]:
            assert not k.endswith(("_dim", "_rank")) and not any(w in k for w in WIDTH_WORDS)
        body = harness.load_json(harness.ROOT / c["file"])
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"]
        assert body["name"] == c["name"]


def test_cells_and_their_files_are_found_by_name():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    four = [c for c in cells if c["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)
    for c in cells:
        assert c["chips"] in (1, 4) and NAME.match(c["traffic"]) and NAME.match(c["config"])
        cell, workload, config = harness.cell_files(c["name"], BENCH)
        assert (harness.HERE / "drivers" / f"{workload['driver']}.py").is_file()
        assert set(workload["limits"]) and all(v > 0 for v in workload["limits"].values())
        assert config["dims"][0] == config["in_channels"]
        assert config["dims"][-1] == config["out_channels"]
        for kind in ("reference", "work"):
            assert (harness.HERE / kind / f"{config['arch']}.py").is_file(), (kind, config)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_a_configuration_names_what_the_program_runs(config):
    """The drivers read every architecture-specific choice from the file."""
    harness.import_program()
    import repro_torch.graph
    from repro_torch.graph.train import trainer

    body = harness.load_json(harness.ROOT / f"h100bench/configs/{config}.json")
    prog = body["program"]
    assert prog["model"] in trainer.MODELS
    assert issubclass(getattr(repro_torch.graph, prog["module"]), torch.nn.Module)
    module = getattr(repro_torch.graph, prog["module"])
    assert len(module._PARAMS._fields) == body["weight_fields"]


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for c in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if harness.applies(m, c["name"], BENCH)]
        assert "setup_s" in e2e and len(e2e) >= 2, c["name"]
        layers = [m for m in BENCH["per_layer"] if harness.applies(m, c["name"], BENCH)]
        assert layers, c["name"]


def test_metrics_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layer_names = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert harness.applies(e2e[m["moves"]], cell, BENCH), (m["name"], cell)
        assert (harness.HERE / "layers" / f"{m['name']}.py").is_file(), m["name"]
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layer_names.setdefault(m["layer"].lower(), m["layer"])
        assert layer_names[m["layer"].lower()] == m["layer"]


def test_a_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_paths_hold_only_the_benchmark():
    for p in BENCH["paths"]:
        assert (harness.ROOT / p).is_dir()
        assert not p.endswith("_torch")
    for word in BENCH["command"]:
        target = harness.ROOT / word
        if target.exists() and target.is_file():
            assert any(Path(word).parts[0] == Path(p).parts[0] for p in BENCH["paths"])
