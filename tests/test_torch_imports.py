"""The PyTorch port stands alone: no JAX, nothing of the JAX package, and
its entry points default to the card without falling back to the CPU."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

# an import statement naming jax, or the JAX package (repro, repro.*)
_FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|repro)(?:\.|\s|,|$)|from\s+(?:jax|repro)(?:\.|\s))",
    re.MULTILINE,
)


def _port_files():
    # chip_smoke.py imports tests/hub_runs.py; scripts/ time the port
    files = sorted(PORT.rglob("*.py")) + sorted((ROOT / "scripts").glob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "hub_runs.py"]
    assert len(files) > 10
    return files


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    src = path.read_text()
    bad = _FORBIDDEN.findall(src)
    assert not bad, f"{path}: {bad}"
    assert "import jax" not in src


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro import obs", "from repro.core import x", "import repro.core"):
        assert _FORBIDDEN.search(line), line
    for line in ("from repro_torch import obs", "import repro_torch.core",
                 "from . import ops", "    from repro_torch.obs import x"):
        assert not _FORBIDDEN.search(line), line


def test_importing_the_port_loads_neither_jax_nor_triton():
    code = (
        "import sys\n"
        "import repro_torch.serving, repro_torch.kernels, repro_torch.obs, repro_torch.core\n"
        "import repro_torch.graph, repro_torch.graph.train, repro_torch.optim\n"
        "import repro_torch.kernels.hbp_spmv, repro_torch.kernels.build\n"
        "import repro_torch.kernels.autodiff, repro_torch.core.spmv\n"
        "bad = [m for m in ('jax', 'triton', 'repro') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    from repro_torch import graph
    from repro_torch.core import PartitionConfig, build_tiles, csr_from_dense
    from repro_torch.kernels import ops
    from repro_torch.serving import MatrixRegistry

    # decide "no card" here, inside the test, whatever the host has
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiles = build_tiles(csr_from_dense(torch.eye(8).numpy()), PartitionConfig(lane=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.device_tiles(tiles)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MatrixRegistry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.hbp_spmv(tiles, torch.ones(8))
    csr = csr_from_dense(torch.eye(8).numpy())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graph.make_aggregator(csr, op="max")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graph.aggregate(tiles, torch.ones(8, 2), op="max")
    # the training slice and the front door default to the card too
    from repro_torch.core import spmm, spmv
    from repro_torch.graph.train import NodeClassifierTrainer
    from repro_torch.kernels import autodiff

    with pytest.raises(RuntimeError, match="device='cpu'"):
        graph.make_diff_aggregator(csr, op="sum")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        autodiff.diff_aggregator(autodiff.hbp_transpose(csr), op="max")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.hbp_spmm_argmax(tiles, torch.ones(8, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NodeClassifierTrainer([4, 2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spmv(tiles, torch.ones(8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spmm(csr, torch.ones(8, 2), backend="cuda")
    assert NodeClassifierTrainer([4, 2], device="cpu").strategy == "stable"
    assert ops.device_tiles(tiles, "cpu").device == torch.device("cpu")
