"""The port's checkpointer and top-k compressor against the JAX package's.

* ``Checkpointer``: a round trip gives the same bits (f32, bf16, int32,
  and int8 ``QTensor`` moments); saves are atomic (a ``.tmp`` directory
  left by a crash is never the latest step and is replaced by the next
  save of that step); an async save is complete after ``wait``; ``keep``
  holds the newest steps only; ``restore`` places leaves on the
  template's device and dtype, and refuses a shape mismatch.
* Checkpoints are interchangeable: the port restores what the JAX package
  wrote and the JAX package restores what the port wrote, bit for bit,
  and both write the same manifest (keys, files, shapes, dtypes, tree).
* ``TopKCompressor``: on inputs without ties in ``|g|`` (``torch.topk`` and
  ``jax.lax.top_k`` may order ties differently), ``compress`` keeps the
  same values and indices and leaves the same residual, ``round_trip``
  carries the same error feedback over steps, and ``wire_bytes`` agrees.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim.adamw as jadamw
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.optim.compression import TopKCompressor as JTopK
import repro_torch.optim.adamw as tadamw
from repro_torch.checkpoint import Checkpointer
from repro_torch.optim import TopKCompressor


def _state(seed=0):
    """A train state in numpy: f32 and bf16 parameters, int8 moments and
    an int32 step, as both packages hold them."""
    rng = np.random.default_rng(seed)
    params = {
        "dec": {"stack": {"l0": {"w1": rng.standard_normal((2, 4, 6)).astype(np.float32)}}},
        "embed": {"tok": rng.standard_normal((8, 4)).astype(np.float32)},
        "norm": rng.standard_normal(4).astype(np.float32),
    }
    q = {k: rng.integers(-127, 128, v.shape).astype(np.int8) for k, v in
         (("w1", params["dec"]["stack"]["l0"]["w1"]), ("tok", params["embed"]["tok"]),
          ("norm", params["norm"]))}
    scale = {k: rng.random(v.shape[:-1] + (1,)).astype(np.float32) for k, v in q.items()}
    return params, q, scale


def _jax_tree(seed=0):
    params, q, scale = _state(seed)
    jp = {"dec": {"stack": {"l0": {"w1": jnp.asarray(params["dec"]["stack"]["l0"]["w1"])}}},
          "embed": {"tok": jnp.asarray(params["embed"]["tok"], jnp.bfloat16)},
          "norm": jnp.asarray(params["norm"])}

    def mom(k):
        return jadamw.QTensor(jnp.asarray(q[k]), jnp.asarray(scale[k]))

    m = {"dec": {"stack": {"l0": {"w1": mom("w1")}}}, "embed": {"tok": mom("tok")},
         "norm": mom("norm")}
    return {"params": jp, "opt": {"m": m, "step": jnp.asarray(7, jnp.int32)}}


def _torch_tree(seed=0, device="cpu"):
    params, q, scale = _state(seed)
    tp = {"dec": {"stack": {"l0": {"w1": torch.from_numpy(params["dec"]["stack"]["l0"]["w1"])}}},
          "embed": {"tok": torch.from_numpy(params["embed"]["tok"]).to(torch.bfloat16)},
          "norm": torch.from_numpy(params["norm"])}

    def mom(k):
        return tadamw.QTensor(torch.from_numpy(q[k]), torch.from_numpy(scale[k]))

    m = {"dec": {"stack": {"l0": {"w1": mom("w1")}}}, "embed": {"tok": mom("tok")},
         "norm": mom("norm")}
    tree = {"params": tp, "opt": {"m": m, "step": torch.tensor(7, dtype=torch.int32)}}
    return jax.tree.map(lambda t: t.to(device), tree,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))


def _bits(x):
    """A leaf's bit pattern as numpy (bf16 through its uint16 view)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same(t_tree, j_tree):
    t = tadamw.tree_leaves(jax.tree.map(lambda x: x, t_tree, is_leaf=lambda x: isinstance(
        x, torch.Tensor)))
    t = [leaf for x in t for leaf in (x if isinstance(x, tadamw.QTensor) else [x])]
    j = jax.tree.leaves(j_tree)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert _bits(a).dtype == _bits(b).dtype and np.array_equal(_bits(a), _bits(b))


def test_round_trip_keeps_every_bit(tmp_path):
    tree = _torch_tree()
    ck = Checkpointer(tmp_path)
    ck.save(3, tree, blocking=True)
    template = _torch_tree(seed=1)
    restored, step = ck.restore(template)
    assert step == 3
    assert isinstance(restored["opt"]["m"]["norm"], tadamw.QTensor)
    _same(restored, _jax_tree())
    assert restored["params"]["embed"]["tok"].dtype == torch.bfloat16
    assert restored["opt"]["step"].dtype == torch.int32 and restored["opt"]["step"].shape == ()
    # into another template dtype: the template's dtype wins
    template["params"]["norm"] = template["params"]["norm"].double()
    again, _ = ck.restore(template, step=3)
    assert again["params"]["norm"].dtype == torch.float64
    assert torch.equal(again["params"]["norm"], tree["params"]["norm"].double())
    with pytest.raises(ValueError, match="shape mismatch"):
        bad = _torch_tree()
        bad["params"]["norm"] = torch.zeros(5)
        ck.restore(bad)
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(template)


def test_saves_are_atomic_and_async_and_keep_the_newest(tmp_path):
    tree = _torch_tree()
    ck = Checkpointer(tmp_path, keep=2)
    # a crash mid-save left a partial directory of a later step
    (tmp_path / "step_00000009.tmp").mkdir()
    (tmp_path / "step_00000009.tmp" / "leaf_00000.npy").write_bytes(b"partial")
    ck.save(1, tree, blocking=True)
    assert ck.latest_step() == 1
    ck.save(9, tree)  # async: the host copy is taken now, the files later
    tree["params"]["norm"].add_(1.0)  # changes after the call do not reach the file
    ck.wait()
    assert ck.latest_step() == 9 and not (tmp_path / "step_00000009.tmp").exists()
    restored, _ = ck.restore(_torch_tree(seed=1))
    _same(restored, _jax_tree())
    ck.save(12, tree, blocking=True)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000009", "step_00000012"]
    manifest = json.loads((tmp_path / "step_00000012" / "manifest.json").read_text())
    assert manifest["step"] == 12


def test_restore_places_leaves_on_the_templates_device(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(0, _torch_tree(), blocking=True)
    restored, _ = ck.restore(_torch_tree(seed=1), device="meta")
    assert restored["params"]["norm"].device.type == "meta"
    restored, _ = ck.restore(_torch_tree(seed=1))
    assert restored["opt"]["m"]["norm"].q.device.type == "cpu"


def test_checkpoints_are_interchangeable(tmp_path):
    # the JAX package writes, the port restores
    JCheckpointer(tmp_path / "j").save(5, _jax_tree(), blocking=True)
    restored, step = Checkpointer(tmp_path / "j").restore(_torch_tree(seed=1))
    assert step == 5
    _same(restored, _jax_tree())
    # the port writes, the JAX package restores
    Checkpointer(tmp_path / "t").save(5, _torch_tree(), blocking=True)
    j_restored, step = JCheckpointer(tmp_path / "t").restore(_jax_tree(seed=1))
    assert step == 5
    _same(_torch_tree(), j_restored)
    # the same manifest, key for key
    mj = json.loads((tmp_path / "j" / "step_00000005" / "manifest.json").read_text())
    mt = json.loads((tmp_path / "t" / "step_00000005" / "manifest.json").read_text())
    assert mt == mj
    assert "['opt']['m']['dec']['stack']['l0']['w1'].q" in mt["leaves"]
    assert mt["leaves"]["['params']['embed']['tok']"]["dtype"] == "bfloat16"
    for meta in mt["leaves"].values():
        a = np.load(tmp_path / "t" / "step_00000005" / meta["file"])
        b = np.load(tmp_path / "j" / "step_00000005" / meta["file"])
        assert a.dtype == b.dtype and np.array_equal(a, b)


# --- top-k compression -------------------------------------------------------


def _tie_free(shape, seed):
    """Normal draws: ties in |g| come with probability 0 (checked)."""
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _no_ties(grads, residual):
    for g, r in zip(jax.tree.leaves(grads), jax.tree.leaves(residual)):
        mags = np.abs(np.asarray(g) + np.asarray(r)).ravel()
        assert np.unique(mags).size == mags.size


@pytest.mark.parametrize("ratio,min_k", [(0.1, 4), (0.25, 1), (1.0, 16), (0.01, 16)])
def test_topk_matches_the_reference(ratio, min_k):
    shapes = {"a": (40, 30), "b": (7,), "c": {"d": (3, 5, 8)}}
    grads = [jax.tree.map(lambda s, i=i: _tie_free(s, i), shapes,
                          is_leaf=lambda x: isinstance(x, tuple)) for i in range(3)]
    jc, tc = JTopK(ratio=ratio, min_k=min_k), TopKCompressor(ratio=ratio, min_k=min_k)
    j_state = jc.init(jax.tree.map(jnp.asarray, grads[0]))
    t_state = tc.init(jax.tree.map(torch.from_numpy, grads[0]))
    # one leaf by hand: values, indices and the residual
    g = grads[0]["a"]
    jv, ji, jr = jc.compress(jnp.asarray(g), jnp.zeros(g.shape))
    tv, ti, tr = tc.compress(torch.from_numpy(g), torch.zeros(g.shape))
    assert ti.dtype == torch.int32
    for a, b in ((tv, jv), (ti, ji), (tr, jr)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(tc.decompress(tv, ti, g.shape).numpy(),
                          np.asarray(jc.decompress(jv, ji, g.shape)))
    # three steps of error feedback
    for step in range(3):
        _no_ties(grads[step], j_state)
        j_out, j_state = jc.round_trip(jax.tree.map(jnp.asarray, grads[step]), j_state)
        t_out, t_state = tc.round_trip(jax.tree.map(torch.from_numpy, grads[step]), t_state)
        for a, b in zip(tadamw.tree_leaves([t_out, t_state]), jax.tree.leaves([j_out, j_state])):
            assert np.array_equal(a.numpy(), np.asarray(b))
    assert tc.wire_bytes(jax.tree.map(torch.from_numpy, grads[0])) == jc.wire_bytes(
        jax.tree.map(jnp.asarray, grads[0]))
    with pytest.raises(ValueError):
        TopKCompressor(ratio=0.0)
