"""Checkpointing with async write and restart, in the JAX package's layout.

Layout (one directory per step), as ``repro.checkpoint.checkpointer``
writes it:

    <dir>/step_00000123/
        manifest.json            step, and per leaf: file, shape, dtype
        leaf_00000.npy           one file per tree leaf (host values)

The manifest is keyed by the leaf's tree path in JAX's ``keystr`` form
(``['params']['dec']['stack']['l0']['w1']``; ``.q``/``.scale`` for the
fields of an int8 :class:`~repro_torch.optim.adamw.QTensor`; ``[i]`` for a
sequence entry), and leaves are numbered in the JAX package's flattening
order (dict keys sorted).  bfloat16, which numpy cannot store, is saved as
its uint16 bit pattern with ``"bfloat16"`` as the logical dtype.  So each
package restores a checkpoint the other wrote.

* **async save** — the host copy is taken synchronously (a device sync),
  the file writes run on a background thread, so the train loop is not
  blocked;
* **integrity** — writes go to ``step_xxx.tmp`` and are renamed
  atomically; a crash mid-save never corrupts the latest complete
  checkpoint;
* ``keep`` — only the newest ``keep`` step directories stay.

``restore`` places each leaf on its template leaf's device (or on
``device``, or where ``shardings`` says) in the template's dtype.
``shardings`` is a tree of :class:`~repro_torch.models.params.NamedSharding`
mirroring the template, as in the JAX package's elastic restore; its meshes
must hold one device (a larger mesh raises ``NotImplementedError``).
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.params import place, require_one_device

__all__ = ["Checkpointer"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[list]:
    """(key string, child) pairs of an inner node in JAX's order, or None
    for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        if tree is not None:
            yield prefix, tree
        return
    for key, child in kids:
        yield from _flatten(child, prefix + key)


def _rebuild(tree, fn, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(key string, leaf)``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), fn, f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, f"{prefix}[{i}]") for i, v in enumerate(tree))
    return None if tree is None else fn(prefix, tree)


def _treedef(tree) -> str:
    """The tree's structure, written as JAX prints a ``PyTreeDef``."""
    def node(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}" for k in sorted(t)) + "}"
        if _is_namedtuple(t):
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(node(v) for v in t) + "])")
        if isinstance(t, list):
            return "[" + ", ".join(node(v) for v in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(node(v) for v in t) + ("," if len(t) == 1 else "") + ")"
        return "None" if t is None else "*"

    return f"PyTreeDef({node(tree)})"


def _to_host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` as saved, and its logical dtype name."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16), "bfloat16"
    arr = t.to("cpu", copy=True).numpy()
    return arr, str(arr.dtype)


class Checkpointer:
    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, *, blocking: bool = False) -> None:
        """Snapshot ``tree`` at ``step``; file IO runs on a worker thread."""
        self.wait()  # one in-flight save at a time
        host = {key: _to_host(leaf) for key, leaf in _flatten(tree)}
        treedef = _treedef(tree)

        def write():
            tmp = self.dir / f"step_{step:08d}.tmp"
            final = self.dir / f"step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest: Dict[str, Any] = {"step": step, "leaves": {}}
            for i, (key, (arr, logical)) in enumerate(host.items()):
                fname = f"leaf_{i:05d}.npy"
                np.save(tmp / fname, arr)
                manifest["leaves"][key] = {
                    "file": fname,
                    "shape": list(arr.shape),
                    "dtype": logical,
                }
            manifest["treedef"] = treedef
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.dir.glob("step_*"))
        for old in steps[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = sorted(self.dir.glob("step_*"))
        steps = [s for s in steps if not s.name.endswith(".tmp")]
        if not steps:
            return None
        return int(steps[-1].name.split("_")[1])

    def restore(self, template, *, step: Optional[int] = None, shardings=None, device=None):
        """Restore into the structure of ``template`` (a tree of tensors):
        each leaf in its template leaf's dtype, on its sharding's device
        (``shardings``, a tree mirroring ``template``), else on ``device``,
        else on the template leaf's device.  Returns ``(tree, step)``."""
        by_key = None if shardings is None else dict(_flatten(shardings))
        for s in (by_key or {}).values():
            require_one_device(s.mesh, "Checkpointer.restore(shardings=)")
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        src = self.dir / f"step_{step:08d}"
        manifest = json.loads((src / "manifest.json").read_text())

        def load(key, tmpl):
            meta = manifest["leaves"][key]
            arr = np.load(src / meta["file"])
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if tuple(t.shape) != tuple(tmpl.shape):
                raise ValueError(f"shape mismatch for {key}: {tuple(t.shape)} vs "
                                 f"{tuple(tmpl.shape)}")
            if by_key is not None:
                return place(t.to(tmpl.dtype), by_key[key])
            return t.to(device=tmpl.device if device is None else device, dtype=tmpl.dtype)

        return _rebuild(template, load), step
