"""What the harness and the reference load: never JAX or the JAX package
(top-level names compared whole: ``repro_torch`` begins with ``repro``),
and the reference nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from h100bench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_forbidden_top_level_name():
    for path in harness.HERE.rglob("*.py"):
        names = set(imports(path))
        tops = {n.split(".")[0] for n in names}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
        if "reference" in path.relative_to(harness.HERE).parts:
            assert tops <= {"__future__", "contextlib", "math", "typing", "warnings", "torch",
                            "h100bench"}, (path, tops)
            assert all(n == "h100bench.reference" for n in names
                       if n.split(".")[0] == "h100bench"), (path, names)


def loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after(
        "from h100bench import harness\n"
        "for path in (harness.HERE / 'reference').glob('*.py'):\n"
        "    harness.load_module(path)\n")
    assert not names & (FORBIDDEN | {"repro_torch"}), names


def test_a_run_of_every_cell_loads_no_jax():
    cells = [c["name"] for c in harness.manifest()["workloads"]]
    code = (
        "import time, torch\n"
        "from h100bench import harness\n"
        "harness.import_program()\n"
        f"for name in {cells!r}:\n"
        "    wl = harness.load_json(harness.HERE / 'workloads' / f'{name}.json')\n"
        "    g = dict(wl['graph'], log2_nodes=7, edge_factor=6.0)\n"
        "    line = harness.run_cell(name, 3, 0.2, False, torch.device('cpu'),\n"
        "                            time.perf_counter(), workload_patch={'graph': g})\n"
        "    assert line['correct'], line\n"
    )
    names = loaded_after(code)
    assert "repro_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN
