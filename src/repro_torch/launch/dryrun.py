"""The dry run: what one device of a mesh holds and does, per (arch × shape × mesh) cell.

The JAX package lowers and compiles every cell ahead of time on
placeholder devices and reads XLA's memory and cost analyses.  PyTorch
has no such compiler; here a cell is an *abstract trace*: the real step
(``make_train_step`` with remat and the microbatch count, or the prefill
or decode step) runs once on the host under ``FakeTensorMode``, whose
tensors carry shapes, dtypes and a device and allocate nothing.  No card,
process group or device count is needed; the mesh is an
:class:`~repro_torch.models.params.AbstractMesh` of the JAX package's
production shapes (:data:`repro_torch.launch.mesh.PRODUCTION_SHAPES`), or
the 1x1 host mesh.

The program traced is *one device's*: the config with every dim its specs
shard over ``model`` divided by that axis's size (query heads, KV heads
where they divide, ``d_ff``, vocab and the SSM's inner width; an MoE's
experts are split by their width, which keeps the router's choice among
all of them and the same bytes and products), at the per-device batch.

Per cell the record (``<out>/<arch>__<shape>__<mesh>.json``) has the JAX
package's keys:

* ``memory.argument_bytes`` — exact: the per-device bytes of parameters,
  moments, batch and cache, from their specs over the mesh;
* ``memory.temp_bytes`` — what the trace holds at its peak beyond its
  inputs and outputs, read by a live-bytes tracker (a dispatch mode that
  follows every storage by a weak reference; on a CUDA device each is
  rounded to the caching allocator's 512 B).  A storage of a parameter's
  or moment's shape (or one layer group's slice of it) is charged at its
  sharded share, and under ``TRAIN_RULES_SP`` a ``[batch, seq, d_model]``
  activation at its sequence slice; the all-gather of FSDP weights is not
  modeled;
* ``memory.output_bytes`` / ``alias_bytes`` — the step's outputs, and those
  of them written in place over an input (the decode cache);
  ``peak_estimate_bytes`` = argument + output + temp - alias;
* ``fits_hbm`` — that peak against the card's memory
  (``torch.cuda.get_device_properties(0).total_memory`` on the card,
  ``hw.hbm_bytes`` off it);
* ``cost_analysis.flops`` — the traced step's matrix products by
  ``FlopCounterMode``'s formulas (recomputation included);
  ``cost_analysis["bytes accessed"]`` — every aten op's input and output
  bytes, views excepted: unfused, so an upper bound on the device-memory
  traffic;
* ``collectives`` — a model over the specs, not a reading: per step each
  weight sharded over ``data``/``pod`` is all-gathered in the forward, and
  again in the backward under remat, and its gradient reduce-scattered, per
  microbatch; each block's tensor-parallel activation all-reduces over
  ``model`` (a mixer's and an FFN's, per forward run and in the backward),
  priced with the JAX package's ring factors;
* ``roofline`` — ``roofline_from_costs`` over the 1- and 2-group unrolled
  configs' traces (one microbatch, no remat), its compute term over the
  card's dense bf16 rate; ``model_flops_global`` = 6 (train) or 2 times
  the active parameters times the tokens, and ``model_flops_ratio`` that
  over the extrapolated FLOPs of all devices;
* ``lower_s`` — seconds to build the abstract inputs; ``compile_s`` — the
  trace's seconds.

The microbatch count, sequence parallelism and the int8-moment threshold
follow the JAX package's rules, with its memory budgets expressed as
shares of ``hw.hbm_bytes``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.roofline import (
    H100_SXM,
    HardwareSpec,
    _wire_bytes,
    card_spec,
    roofline_from_costs,
)
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import PRODUCTION_SHAPES
from repro_torch.models import DECODE_RULES, TRAIN_RULES, TRAIN_RULES_SP, build_model, input_specs
from repro_torch.models.params import AbstractMesh, Rules, logical_spec, mesh_shape, mesh_size
from repro_torch.models.transformer import _pattern, _sqrt_factor
from repro_torch.optim.adamw import AdamWConfig, QTensor, init_opt_state, opt_state_specs

__all__ = [
    "MESHES",
    "default_microbatch",
    "needs_sp",
    "opt_config",
    "cell_applicable",
    "unrolled_cfg",
    "device_config",
    "LiveBytes",
    "dryrun_cell",
    "run_cell",
]

MESHES = {name: AbstractMesh(*shape) for name, shape in PRODUCTION_SHAPES.items()}
MESHES["host"] = AbstractMesh((1, 1), ("data", "model"))

# Budgets as shares of the device memory: a microbatch's transient working
# set is one token·dim per _BYTES_PER_TOKEN_DIM bytes, the stored remat
# boundaries a quarter, the f32 logits an eighth; sequence parallelism
# starts where one sequence's boundaries would take 3/8.
_BYTES_PER_TOKEN_DIM = 238.4185791015625
_BOUNDARY_SHARE = 0.25
_LOGITS_SHARE = 0.125
_SP_SHARE = 0.375
# int8 moments and a bf16 gradient accumulator above this many parameters
_INT8_PARAMS = 1e11


def _shards(mesh, *axes) -> int:
    sizes = mesh_shape(mesh)
    return math.prod(sizes.get(a, 1) for a in axes)


def default_microbatch(cfg: ModelConfig, shape: ShapeConfig, mesh, hw: HardwareSpec) -> int:
    """Gradient-accumulation microbatches of a train cell (1 otherwise)."""
    if shape.kind != "train":
        return 1
    data_shards = _shards(mesh, "data", "pod")
    tok_per_dev = shape.global_batch * shape.seq_len / data_shards
    d = max(cfg.d_model, cfg.ssm_expand * cfg.d_model if cfg.ssm_state else 0)
    if cfg.moe_experts:
        # MoE dispatch expands every token into top_k slots: the dominant
        # transient is the [B, S·K, D] permuted activation
        d = max(d, cfg.d_model * max(cfg.moe_top_k // 2, 1))
    layers = cfg.n_layers + cfg.encoder_layers
    # (1) the per-microbatch transient working set; (2) the stored remat
    # boundaries (two-level remat keeps ~2 sqrt(layers) of them); (3) the
    # f32 logits, sharded over "model" where the vocab divides
    stored_layers = 2 * math.isqrt(layers) + 2
    n1 = tok_per_dev * d / (hw.hbm_bytes / _BYTES_PER_TOKEN_DIM)
    n2 = tok_per_dev * cfg.d_model * 2 * stored_layers / (hw.hbm_bytes * _BOUNDARY_SHARE)
    model = _shards(mesh, "model")
    vocab_shards = model if cfg.padded_vocab % model == 0 else 1
    n3 = tok_per_dev * cfg.padded_vocab * 4 / vocab_shards / (hw.hbm_bytes * _LOGITS_SHARE)
    n = max(1, int(max(n1, n2, n3)))
    n = 1 << (n - 1).bit_length()  # next power of two (divides the batch)
    return min(n, max(1, shape.global_batch // data_shards))


def needs_sp(cfg: ModelConfig, shape: ShapeConfig, mesh, hw: HardwareSpec) -> bool:
    """Sequence parallelism when one sequence's remat boundaries per device
    would not fit their share."""
    if shape.kind != "train":
        return False
    boundaries = shape.seq_len * cfg.d_model * 2 * (cfg.n_layers + cfg.encoder_layers)
    return boundaries > hw.hbm_bytes * _SP_SHARE


def opt_config(cfg: ModelConfig) -> AdamWConfig:
    """int8 moments above 1e11 parameters, f32 below."""
    return AdamWConfig(state_dtype="int8" if cfg.param_count() > _INT8_PARAMS else "float32")


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    """None if runnable, else the documented skip reason."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return (
            "long_500k needs sub-quadratic decode state; "
            f"{cfg.name} is pure full-attention (skip per assignment sheet)"
        )
    return None


def unrolled_cfg(cfg: ModelConfig, k: int) -> ModelConfig:
    """k layer groups, unrolled (for per-group cost extrapolation)."""
    prologue = cfg.moe_first_dense if cfg.moe_experts else 0
    return dataclasses.replace(
        cfg,
        n_layers=prologue + k * cfg.layer_period,
        encoder_layers=k if cfg.is_encdec else 0,
        scan_layers=False,
    )


# ---------------------------------------------------------------------------
# One device's program
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _DeviceConfig(ModelConfig):
    """A config whose derived widths are one device's share."""

    local_heads: int = 0
    local_vocab: int = 0
    local_inner: int = 0

    @property
    def padded_heads(self) -> int:
        return self.local_heads

    @property
    def padded_vocab(self) -> int:
        return self.local_vocab

    @property
    def ssm_inner(self) -> int:
        return self.local_inner


def device_config(cfg: ModelConfig, rules: Rules, mesh) -> ModelConfig:
    """The config of one device's program: every dim the rules shard over
    ``model`` divided by that axis's size where it divides (``cfg`` itself
    on a mesh without a ``model`` axis wider than 1)."""
    m = _shards(mesh, "model")
    if m == 1:
        return cfg

    def split(n: int, logical: str) -> int:
        return n // m if rules.get(logical) == "model" and n % m == 0 else n

    H = split(cfg.padded_heads, "heads")
    kv = cfg.n_kv_heads
    if H and rules.get("kv_heads") == "model" and kv % m == 0:
        kv = kv // m
    elif H != cfg.padded_heads:
        kv = max(1, kv * H // cfg.padded_heads)  # the KV heads the local heads read
    while H and H % kv:
        kv -= 1
    inner = cfg.ssm_inner
    if cfg.ssm_state and split(inner, "ssm_inner") % cfg.ssm_head_dim == 0:
        inner = split(inner, "ssm_inner")
    vocab = split(cfg.padded_vocab, "vocab")
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)}
    fields.update(
        n_heads=H, n_kv_heads=kv, head_dim=cfg.resolved_head_dim,
        d_ff=split(cfg.d_ff, "mlp"), first_dense_ff=split(cfg.first_dense_ff, "mlp"),
        vocab=vocab,
    )
    return _DeviceConfig(**fields, local_heads=H, local_vocab=vocab, local_inner=inner)


def _entry_shards(entry, mesh) -> int:
    """The devices one spec entry (None, an axis or a tuple of axes) splits a dim over."""
    if entry is None:
        return 1
    return _shards(mesh, *((entry,) if isinstance(entry, str) else entry))


def _local_bytes(t: torch.Tensor, spec, mesh) -> int:
    """Per-device bytes of ``t`` under ``spec``."""
    return t.numel() * t.element_size() // math.prod(_entry_shards(e, mesh) for e in spec)


def _zip(a, b, c):
    """(a, b, c) leaves of three trees of one structure (dicts, QTensors)."""
    if isinstance(a, dict):
        for k in a:
            yield from _zip(a[k], b[k], c[k])
    elif isinstance(a, QTensor):
        for i in range(2):
            yield from _zip(a[i], b[i], c[i])
    else:
        yield a, b, c


def _tensors(x, out: Optional[list] = None) -> list:
    """The tensors of nested lists, tuples and dicts, in order."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


_DEVICE = torch.ops.prim.device.default


class LiveBytes(TorchDispatchMode):
    """Follows every storage an op creates (by a weak reference, so a
    storage's bytes leave the count when it is freed) and keeps the peak of
    the live bytes.  ``charge`` maps a tensor shape to the share of its
    bytes to count (default 1).  Also sums each op's input and output
    bytes (views excepted) into ``bytes_accessed``, and its FLOPs by
    ``FlopCounterMode``'s formulas (``torch.utils.flop_counter.flop_registry``:
    the matrix products and convolutions) into ``flops``."""

    def __init__(self, charge: Optional[Dict[tuple, float]] = None):
        from torch.utils.flop_counter import flop_registry

        super().__init__()
        self.charge = charge or {}
        self.live = 0.0
        self.peak = 0.0
        self.bytes_accessed = 0
        self.flops = 0
        self._flop_registry = flop_registry
        self._refs: Dict[int, Any] = {}

    def _cost(self, t: torch.Tensor) -> float:
        nb = t.untyped_storage().nbytes()
        if t.device.type == "cuda":
            nb = -(-nb // 512) * 512
        return nb * self.charge.get(tuple(t.shape), 1.0)

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage from now until it is freed (once)."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        cost = self._cost(t)

        def freed(_ref, key=key, cost=cost):
            self.live -= cost
            self._refs.pop(key, None)

        self._refs[key] = weakref.ref(st, freed)
        self.live += cost
        self.peak = max(self.peak, self.live)

    def cost_of(self, tensors) -> float:
        """The counted bytes of the distinct storages among ``tensors``."""
        seen, total = set(), 0.0
        for t in tensors:
            key = id(t.untyped_storage())
            if key not in seen:
                seen.add(key)
                total += self._cost(t)
        return total

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is _DEVICE:
            return out
        outs = _tensors(out)
        if not func.is_view:
            ins = _tensors(args, _tensors(kwargs))
            self.bytes_accessed += sum(t.numel() * t.element_size() for t in ins + outs)
            count = self._flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
        for t in outs:
            self.track(t)
        return out


def _rules(cfg: ModelConfig, shape: ShapeConfig, mesh, hw: HardwareSpec) -> Rules:
    if shape.kind != "train":
        return DECODE_RULES
    return TRAIN_RULES_SP if needs_sp(cfg, shape, mesh, hw) else TRAIN_RULES


def _build(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: Rules, hw: HardwareSpec,
           device, n_micro: Optional[int], ocfg: Optional[AdamWConfig]):
    """The cell's step on one device's program under a new FakeTensorMode:
    ``(fake_mode, step, args, info)``; ``info`` carries the exact
    per-device argument bytes, the storage charges and the record's train
    keys."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.serve import make_decode_step, make_prefill_step
    from repro_torch.train import make_train_step

    train = shape.kind == "train"
    full, local_cfg = build_model(cfg), device_config(cfg, rules, mesh)
    local = build_model(local_cfg)
    B = shape.global_batch
    tok_spec = logical_spec((B, shape.seq_len), ("batch", None), rules, mesh)
    B_dev = B // _entry_shards(tok_spec[0], mesh)
    dev_shape = dataclasses.replace(shape, global_batch=B_dev)

    # exact per-device bytes of the full model's inputs, from their specs
    pspecs = full.specs(rules, mesh)
    exact = [(full.abstract(), pspecs)]
    extra: Dict[str, Any] = {"rules": rules.name}
    if train:
        ocfg = ocfg or opt_config(cfg)
        micro = n_micro or default_microbatch(cfg, shape, mesh, hw)
        acc_dtype = torch.bfloat16 if cfg.param_count() > _INT8_PARAMS else torch.float32
        opt_abs = init_opt_state(exact[0][0], ocfg)
        exact.append((opt_abs, opt_state_specs(exact[0][0], pspecs, ocfg, mesh)))
        extra.update(n_microbatch=micro, opt_state=ocfg.state_dtype,
                     acc_dtype=str(acc_dtype).removeprefix("torch."))
    else:
        exact.append((full.abstract_cache(B, shape.seq_len),
                      full.cache_specs(rules, mesh, B, shape.seq_len)))
    batch_full = input_specs(cfg, shape)
    arg_bytes = sum(_local_bytes(t, s, mesh) for tree, specs in exact
                    for t, s, _ in _zip(tree, specs, tree))
    for k, t in batch_full.items():
        logical = ("batch",) + (None,) * (t.dim() - 1)
        arg_bytes += _local_bytes(t, logical_spec(tuple(t.shape), logical, rules, mesh), mesh)

    fake = FakeTensorMode()
    with fake:
        params = local.abstract(device=device)
        if train:
            state = {"params": params, "opt": init_opt_state(params, ocfg)}
            args = (state, input_specs(local_cfg, dev_shape, device=device))
            step = make_train_step(local, ocfg, n_microbatch=micro, remat=True,
                                   acc_dtype=acc_dtype)
            local_trees = [params, state["opt"]]
        else:
            cache = local.abstract_cache(B_dev, shape.seq_len, device=device)
            local_trees = [params, cache]
            if shape.kind == "prefill":
                args = (params, input_specs(local_cfg, dev_shape, device=device), cache)
                step = make_prefill_step(local)
            else:
                tokens = torch.empty((B_dev, 1), dtype=torch.int64, device=device)
                args = (params, cache, tokens, shape.seq_len - 1)
                step = make_decode_step(local)

    # storages of a parameter's, moment's or cache's shape (and one group's
    # slice of a stacked one) are charged at their sharded share
    charge: Dict[tuple, float] = {}
    if mesh_size(mesh) > 1:
        for (tree, specs), ltree in zip(exact, local_trees):
            for t, s, lt in _zip(tree, specs, ltree):
                share = _local_bytes(t, s, mesh) / (lt.numel() * lt.element_size())
                for key in (tuple(lt.shape), tuple(lt.shape[1:])):
                    charge[key] = max(charge.get(key, 0.0), share)
        if rules is TRAIN_RULES_SP and shape.seq_len % _shards(mesh, "model") == 0:
            charge[(B_dev // micro, shape.seq_len, cfg.d_model)] = 1 / _shards(mesh, "model")
    info = {"argument_bytes": arg_bytes, "charge": charge, "extra": extra,
            "micro": extra.get("n_microbatch", 1), "B_dev": B_dev}
    return fake, step, args, info


def _trace(fake, step, args, charge) -> Dict[str, float]:
    """Run ``step(*args)`` under ``fake`` with a :class:`LiveBytes` tracker."""
    tracker = LiveBytes(charge)
    inputs = _tensors(args)
    for t in inputs:
        tracker.track(t)
    arg_cost = tracker.live
    t0 = time.perf_counter()
    with fake, tracker:
        out = step(*args)
    seconds = time.perf_counter() - t0
    in_keys = {id(t.untyped_storage()) for t in inputs}
    outs = _tensors(out)
    out_cost = tracker.cost_of(outs)
    alias = tracker.cost_of([t for t in outs if id(t.untyped_storage()) in in_keys])
    return {"peak": tracker.peak, "args": arg_cost, "output": out_cost, "alias": alias,
            "flops": float(tracker.flops),
            "bytes accessed": float(tracker.bytes_accessed), "seconds": seconds}


def _collectives(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: Rules, micro: int,
                 B_dev: int) -> Dict[str, float]:
    """Per-device wire bytes of one step (the model in the module docstring)."""
    by_kind = {k: 0.0 for k in ("all-reduce", "all-gather", "reduce-scatter",
                                "all-to-all", "collective-permute")}
    full = build_model(cfg)
    train = shape.kind == "train"
    for t, spec, _ in _zip(full.abstract(), full.specs(rules, mesh), full.abstract()):
        fsdp = [a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else e) if a in ("data", "pod")]
        g = _shards(mesh, *fsdp)
        if g <= 1:
            continue
        shard = _local_bytes(t, spec, mesh)
        gathers = (2 if train else 1) * micro
        by_kind["all-gather"] += gathers * _wire_bytes("all-gather", shard * g, g)
        if train:
            by_kind["reduce-scatter"] += micro * _wire_bytes("reduce-scatter", shard, g)
    m = _shards(mesh, "model")
    if m > 1:
        tokens = B_dev // micro * (shape.seq_len if shape.kind != "decode" else 1)
        act = tokens * cfg.d_model * 2  # one bf16 [tokens, d_model] activation
        layers = [cfg.layer_kind(l) for l in range(cfg.n_layers)]
        layers += [("attn", "dense")] * cfg.encoder_layers
        per_pass = sum(1 + (ffn != "none") for _, ffn in layers)
        if train:
            _, _, n_groups = _pattern(cfg, cfg.n_layers)
            fwd_runs = 3 if _sqrt_factor(n_groups) > 1 else 2  # remat recomputes
            per_pass *= (fwd_runs + 1) * micro
        by_kind["all-reduce"] += per_pass * _wire_bytes("all-reduce", act, m)
    return {"wire_bytes_per_device": sum(by_kind.values()), "by_kind": by_kind}


def _capacity(hw: HardwareSpec, device) -> float:
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return float(hw.hbm_bytes)


def dryrun_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *, hw: HardwareSpec,
                device="cpu", roofline: bool = True, n_micro: Optional[int] = None,
                ocfg: Optional[AdamWConfig] = None) -> Dict[str, Any]:
    """The record of one cell (without its arch/shape/mesh names), traced
    with fake tensors on ``device``.  ``n_micro`` and ``ocfg`` override the
    microbatch count and the optimizer (default: the rules above).
    Raises where the step cannot be traced."""
    rec: Dict[str, Any] = {}
    skip = cell_applicable(cfg, shape)
    if skip:
        return {"status": "skipped", "reason": skip}
    t0 = time.perf_counter()
    rules = _rules(cfg, shape, mesh, hw)
    fake, step, args, info = _build(cfg, shape, mesh, rules, hw, device, n_micro, ocfg)
    lower_s = time.perf_counter() - t0
    tr = _trace(fake, step, args, info["charge"])
    arg_bytes = info["argument_bytes"]
    temp = tr["peak"] - tr["args"] - (tr["output"] - tr["alias"])
    peak = arg_bytes + tr["output"] + temp - tr["alias"]
    hbm = _capacity(hw, device)
    rec.update(info["extra"])
    rec["status"] = "ok"
    rec["lower_s"] = round(lower_s, 2)
    rec["compile_s"] = round(tr["seconds"], 2)
    rec["memory"] = {
        "argument_bytes": int(arg_bytes),
        "output_bytes": int(tr["output"]),
        "temp_bytes": int(temp),
        "alias_bytes": int(tr["alias"]),
        "peak_estimate_bytes": int(peak),
        "hbm_bytes": int(hbm),
    }
    rec["fits_hbm"] = peak <= hbm
    rec["cost_analysis"] = {"flops": tr["flops"], "bytes accessed": tr["bytes accessed"]}
    coll = _collectives(cfg, shape, mesh, rules, info["micro"], info["B_dev"])
    rec["collectives"] = coll
    if roofline:
        if not hw.bf16_flops:
            raise ValueError(f"{hw.name} has no bf16 rate for the LM roofline")
        prologue = cfg.moe_first_dense if cfg.moe_experts else 0
        n_groups = (cfg.n_layers - prologue) // cfg.layer_period
        costs = []
        for k in (1, 2):
            fk, sk, ak, ik = _build(unrolled_cfg(cfg, k), shape, mesh, rules, hw, device, 1,
                                    ocfg)
            tk = _trace(fk, sk, ak, ik["charge"])
            costs.append({"flops": tk["flops"], "bytes accessed": tk["bytes accessed"]})
            rec[f"unrolled_{k}_compile_s"] = round(tk["seconds"], 2)
        terms = roofline_from_costs(costs[0], costs[1], n_groups, coll["wire_bytes_per_device"],
                                    dataclasses.replace(hw, peak_flops=hw.bf16_flops))
        rec["roofline"] = terms.as_dict()
        rec["unrolled_costs"] = costs
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        mult = 6 if shape.kind == "train" else 2
        rec["model_flops_global"] = float(mult * cfg.active_param_count() * tokens)
        hlo_global = terms.flops * mesh_size(mesh)
        rec["model_flops_ratio"] = rec["model_flops_global"] / hlo_global if hlo_global else None
    return rec


def _default_hw() -> HardwareSpec:
    return card_spec() if torch.cuda.is_available() else H100_SXM


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: Path, *,
             hw: Optional[HardwareSpec] = None, roofline: bool = True, device=None):
    """Trace one cell and write its record; an error is recorded, not
    raised, so that a sweep goes on.  ``hw`` defaults to the card's spec
    (the H100 SXM's without a card), ``device`` of the fake tensors to the
    card's type (``"cpu"`` without one)."""
    hw = hw or _default_hw()
    device = device or ("cuda" if torch.cuda.is_available() else "cpu")
    out_path = Path(out_dir) / f"{arch}__{shape_name}__{mesh_name}.json"
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    tag = f"[dryrun] {arch} × {shape_name} × {mesh_name}"
    try:
        rec.update(dryrun_cell(get_config(arch), SHAPES[shape_name], MESHES[mesh_name], hw=hw,
                               device=device, roofline=roofline))
        if rec["status"] == "skipped":
            print(f"{tag}: SKIP ({rec['reason']})")
        else:
            print(f"{tag}: OK trace={rec['compile_s']:.1f}s "
                  f"peak={rec['memory']['peak_estimate_bytes'] / 2**30:.2f}GiB "
                  f"fits={rec['fits_hbm']}")
    except Exception as e:  # a sweep records the failure and goes on
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"{tag}: ERROR {type(e).__name__}: {e}")
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="architecture id (see configs/)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multipod", "both"])
    ap.add_argument("--all", action="store_true", help="run every (arch × shape)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--skip-done", action="store_true", help="skip cells with an ok JSON")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multipod"] if args.mesh == "both" else [args.mesh]
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                out_path = out_dir / f"{arch}__{shape}__{mesh_name}.json"
                if args.skip_done and out_path.exists():
                    try:
                        if json.loads(out_path.read_text()).get("status") in ("ok", "skipped"):
                            continue
                    except json.JSONDecodeError:
                        pass
                run_cell(arch, shape, mesh_name, out_dir,
                         roofline=(not args.no_roofline) and mesh_name == "single")


if __name__ == "__main__":
    main()
