"""The PyTorch port stands alone: no JAX, nothing of the JAX package, no
``ml_dtypes`` (the card's machine does not have it), and its entry points
default to the card without falling back to the CPU."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
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
    # chip_smoke.py imports tests/hub_runs.py; scripts/ time the port; the
    # mesh tests' ranks run the port alone
    files = sorted(PORT.rglob("*.py")) + sorted((ROOT / "scripts").glob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "hub_runs.py",
              ROOT / "tests" / "torch_mesh_worker.py"]  # the mesh tests' ranks
    assert len(files) > 10
    return files


def test_the_scan_covers_the_lm_modules():
    names = {str(p.relative_to(PORT)) for p in _port_files() if PORT in p.parents}
    for want in ("configs/base.py", "configs/olmo_1b.py", "models/params.py",
                 "models/attention.py", "models/transformer.py", "models/model.py",
                 "serve/engine.py", "serve/steps.py", "launch/serve.py",
                 "core/sparse_linear.py", "train/steps.py", "train/trainer.py",
                 "checkpoint/checkpointer.py", "data/pipeline.py", "optim/compression.py",
                 "launch/train.py", "launch/mesh.py", "launch/dryrun.py"):
        assert want in names, want


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    src = path.read_text()
    bad = _FORBIDDEN.findall(src)
    assert not bad, f"{path}: {bad}"
    assert "import jax" not in src
    assert not re.search(r"^\s*(?:import|from)\s+ml_dtypes\b", src, re.MULTILINE), path


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
        "import repro_torch.kernels.autodiff, repro_torch.core.spmv, repro_torch.solvers\n"
        "import repro_torch.core.distributed, repro_torch.analysis.report\n"
        "import repro_torch.analysis.diff, repro_torch.obs.planview\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.serve.engine\n"
        "import repro_torch.launch.serve, repro_torch.core.sparse_linear\n"
        "import repro_torch.train.trainer, repro_torch.checkpoint, repro_torch.data\n"
        "import repro_torch.optim.compression, repro_torch.launch.train\n"
        "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()  # importing the mesh starts no group\n"
        "bad = [m for m in ('jax', 'triton', 'repro', 'ml_dtypes') if m in sys.modules]\n"
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


def test_autotune_and_solvers_default_to_the_card_and_raise_without_one(monkeypatch, tmp_path):
    """Autotune's entry points, the solver surface and the distributed
    SpMV measure and run on the card unless given ``device="cpu"``; a bad
    strategy is refused before any device check."""
    from repro_torch import solvers
    from repro_torch.core import PartitionConfig, build_tiles
    from repro_torch.core.matrices import circuit
    from repro_torch.core.distributed import build_sharded_spmv
    from repro_torch.serving import autotune

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    csr = circuit(64, seed=1)
    cfg = PartitionConfig(row_block=32, col_block=64, group=8, lane=8)
    with pytest.raises(ValueError):
        autotune.spmm_probe(strategy="bogus")
    with pytest.raises(ValueError):
        autotune.cg_probe(strategy="bogus")
    for call in (
        lambda: autotune.spmm_probe(),
        lambda: autotune.cg_probe(),
        lambda: autotune._measure_spmm_us(csr, cfg, 8, 1, "stable"),
        lambda: autotune.autotune_partition(csr, cache=autotune.AutotuneCache(tmp_path)),
        lambda: solvers.aslinearoperator(build_tiles(csr, cfg)),
        lambda: solvers.aslinearoperator(csr),
        lambda: solvers.aslinearoperator(csr.to_dense()),
        lambda: solvers.jacobi(csr),
        lambda: solvers.block_jacobi(csr),
        lambda: solvers.cg(csr, np.ones(64, np.float32)),
        lambda: solvers.pagerank(csr),
        lambda: build_sharded_spmv(csr, cfg=cfg),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not any(tmp_path.iterdir())  # nothing was measured or cached
    assert autotune.spmm_probe(device="cpu").params[-1] == "cpu"


def test_lm_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    """The serving path's entry points (the model's init and cache, the
    carry of JAX weights, the engine, the pruned layer and the launcher)
    run on the card unless given ``device="cpu"``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.sparse_linear import SparseLinear
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import build_model, params_from_arrays
    from repro_torch.serve.engine import Engine, EngineConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(get_config("olmo-1b").smoke(), n_layers=2, vocab=128)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    w = np.random.default_rng(0).standard_normal((64, 96)).astype(np.float32)
    for call in (
        lambda: model.init(torch.Generator().manual_seed(0)),
        lambda: model.init_cache(2, 16),
        lambda: params_from_arrays({"w": w}),
        lambda: Engine(model, params, EngineConfig()),
        lambda: SparseLinear.from_dense(w),
        lambda: SparseLinear.from_dense(w, backend="torch"),
        lambda: launch_serve.main(["--arch", "olmo-1b", "--smoke"]),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert Engine(model, params, EngineConfig(), device="cpu").device == torch.device("cpu")
    assert SparseLinear.from_dense(w, device="cpu").dt.device == torch.device("cpu")
    assert params_from_arrays({"w": w}, device="cpu")["w"].device == torch.device("cpu")


def test_training_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    """The training slice's entry points (the train state, the data on the
    card, the trainer and the launcher) run on the card unless given
    ``device="cpu"``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, make_global_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(get_config("olmo-1b").smoke(), n_layers=2, vocab=128)
    model = build_model(cfg)
    dcfg = DataConfig(vocab=128, seq_len=8, global_batch=2)
    for call in (
        lambda: init_train_state(model, torch.Generator().manual_seed(0), AdamWConfig()),
        lambda: make_global_batch(SyntheticLM(dcfg), 0),
        lambda: Trainer(model, AdamWConfig(), dcfg, TrainerConfig()),
        lambda: launch_train.main(["--arch", "olmo-1b", "--smoke", "--steps", "1"]),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    state = init_train_state(model, torch.Generator().manual_seed(0), AdamWConfig(), device="cpu")
    assert state["opt"]["step"].device == torch.device("cpu")
    assert Trainer(model, AdamWConfig(), dcfg, TrainerConfig(), device="cpu").device.type == "cpu"
