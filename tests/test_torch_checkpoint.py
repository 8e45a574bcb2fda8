"""The port's checkpoints (``repro_torch.checkpoint``): the port's
versions of the checkpoint tests of ``tests/test_substrates.py``, bf16
leaves bit for bit, parameter trees, snapshots taken before an
asynchronous save, and files that each package reads from the other
(the same manifest keys, dtypes and shapes).  Exact throughout."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import (load_pytree as jload_pytree,
                              save_pytree as jsave_pytree)

from repro_torch import tree as tree_util
from repro_torch.checkpoint import (CheckpointManager, load_pytree,
                                    save_pytree)
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import transformer as T

torch.set_num_threads(1)


def _tree():
    return {"layer": {"w": torch.arange(6.0).reshape(2, 3),
                      "b": torch.zeros(3)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _same(a, b):
    la, lb = tree_util.leaves(a), tree_util.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The port's versions of tests/test_substrates.py:145-183
# ---------------------------------------------------------------------------


def test_save_load_roundtrip(tmp_path):
    t = _tree()
    save_pytree(t, str(tmp_path / "ck"), metadata={"step": 7}, n_shards=2)
    loaded, meta = load_pytree(t, str(tmp_path / "ck"))
    assert meta["step"] == 7
    _same(t, loaded)


def test_structure_mismatch_rejected(tmp_path):
    save_pytree(_tree(), str(tmp_path / "ck"))
    bad = {"other": torch.zeros(3)}
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree(bad, str(tmp_path / "ck"))


def test_manager_async_keep_and_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for step in (1, 2, 3):
        t = tree_util.map_tree(
            lambda a: a + 1 if a.is_floating_point() else a, t)
        mgr.save(step, t, metadata={"step": step})
    mgr.wait()
    assert mgr.all_steps() == [2, 3]      # keep-last-2
    step, loaded, meta = mgr.restore(_tree())
    assert step == 3 and meta["step"] == 3
    _same(t, loaded)
    with open(tmp_path / "LATEST") as f:
        assert f.read() == "3"


def test_crash_safe_tmp_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(), blocking=True)
    os.makedirs(str(tmp_path / "step_0000000002.tmp"))  # simulated crash
    assert mgr.latest_step() == 1


# ---------------------------------------------------------------------------
# bf16, parameter trees, snapshots
# ---------------------------------------------------------------------------


def test_bf16_leaves_round_trip_bit_exact(tmp_path):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((17, 9), generator=g).to(torch.bfloat16)
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                            float("nan"), 1e-40, -3.5e38],
                           dtype=torch.bfloat16)
    t = {"m": x, "s": special, "f": torch.randn(4, generator=g)}
    save_pytree(t, str(tmp_path / "ck"), n_shards=2)
    with open(tmp_path / "ck" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["dtypes"] == ["float32", "bfloat16", "bfloat16"]
    loaded, _ = load_pytree(t, str(tmp_path / "ck"))
    _same(t, loaded)


def test_param_tree_and_opt_state_round_trip(tmp_path):
    """A reduced model's parameters and AdamW state (bf16 moments) come
    back as trees of the same layout and bits; the keys walk the blocks
    by index and each tree by sorted key."""
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = reduced(ARCHS["jamba-1.5-large-398b"])
    params = T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    opt = adamw_init(params, AdamWConfig(moment_dtype="bfloat16"))
    for m in tree_util.leaves(opt["m"]):
        m.copy_(torch.randn(m.shape).to(m.dtype))
    tree = {"params": params, "opt": opt}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, tree, metadata={"stream": {"step": 4, "seed": 0}},
             blocking=True)
    step, loaded, meta = mgr.restore(tree)
    assert step == 4 and meta == {"stream": {"step": 4, "seed": 0}}
    assert isinstance(loaded["params"], T.ParamTree)
    assert isinstance(loaded["opt"]["m"], T.ParamTree)
    _same(tree, loaded)
    keys = [k for k, _ in tree_util.flatten_with_paths(tree)]
    assert keys == sorted(keys, key=lambda k: [
        (0, int(p)) if p.isdigit() else (1, p) for p in k.split("/")])
    assert "params/blocks/0/attn7/wq" in keys


def test_snapshot_taken_before_the_async_save(tmp_path):
    """The save copies the tree before its thread starts: leaves
    updated in place right after ``save`` returns (as the next train step
    does) do not reach the file."""
    t = {"w": torch.ones(1 << 16), "step": torch.tensor(1)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, t)
    t["w"].mul_(3.0)
    t["step"].add_(1)
    mgr.wait()
    _, loaded, _ = mgr.restore(t)
    assert torch.equal(loaded["w"], torch.ones(1 << 16))
    assert int(loaded["step"]) == 1


# ---------------------------------------------------------------------------
# Files that each package reads from the other
# ---------------------------------------------------------------------------


def _np_tree(seed):
    rng = np.random.default_rng(seed)
    return {"enc": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                    "b": rng.standard_normal(5).astype(np.float32)},
            "layers": [{"k": rng.integers(-9, 9, (2, 2), dtype=np.int32)},
                       {"k": rng.integers(-9, 9, (4,), dtype=np.int32)}],
            "step": np.int32(12)}


@pytest.mark.parametrize("n_shards", [1, 3])
def test_reference_file_loads_in_the_port(tmp_path, n_shards):
    t = _np_tree(0)
    jsave_pytree(jax.tree.map(jnp.asarray, t), str(tmp_path / "ck"),
                 metadata={"step": 12}, n_shards=n_shards)
    template = tree_util.map_tree(torch.tensor, _np_tree(1))
    loaded, meta = load_pytree(template, str(tmp_path / "ck"))
    assert meta == {"step": 12}
    want = tree_util.map_tree(torch.tensor, t)
    _same(want, loaded)


@pytest.mark.parametrize("n_shards", [1, 3])
def test_port_file_loads_in_the_reference(tmp_path, n_shards):
    t = tree_util.map_tree(torch.tensor, _np_tree(2))
    save_pytree(t, str(tmp_path / "port"), metadata={"step": 5},
                n_shards=n_shards)
    jsave_pytree(jax.tree.map(jnp.asarray, _np_tree(2)),
                 str(tmp_path / "ref"), metadata={"step": 5},
                 n_shards=n_shards)
    manifests = []
    for d in ("port", "ref"):
        with open(tmp_path / d / "manifest.json") as f:
            m = json.load(f)
        m.pop("time")
        manifests.append(m)
    assert manifests[0] == manifests[1]
    loaded, meta = jload_pytree(jax.tree.map(jnp.asarray, _np_tree(3)),
                                str(tmp_path / "port"))
    assert meta == {"step": 5}
    for a, b in zip(jax.tree.leaves(_np_tree(2)), jax.tree.leaves(loaded)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_tree_order_matches_jax():
    """The port's walk gives ``jax.tree_util``'s leaf order and paths."""
    t = _np_tree(4)
    flat = jax.tree_util.tree_flatten_with_path(t)[0]
    jkeys = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path) for path, _ in flat]
    assert [k for k, _ in tree_util.flatten_with_paths(t)] == jkeys
    rebuilt = tree_util.unflatten(t, list(range(len(jkeys))))
    assert jax.tree.leaves(rebuilt) == list(range(len(jkeys)))
