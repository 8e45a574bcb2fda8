"""Checkpoint manager: atomic manifests, async saves, keep-last-k GC.

Counterpart of :mod:`repro.checkpoint.manager`, with its on-disk
layout per step::

    <dir>/step_<N>.tmp/        (written first)
        shard_<i>.npz          one npz per host shard (flat path -> array)
        manifest.json          pytree structure + dtypes + metadata
    <dir>/step_<N>/            (atomic rename once complete)
    <dir>/LATEST               text file naming the newest complete step

Restart safety: a crash mid-save leaves only ``*.tmp`` directories, which
restore ignores and the next save garbage-collects.  Restores validate
the manifest against the expected tree structure before loading bytes.

Trees are flattened by :mod:`repro_torch.tree` (mappings by sorted key
as ``jax.tree_util`` orders them, lists by index, a ``ParamTree`` as its
mapping), so a tree of plain mappings has the reference's keys and the
two packages read each other's files.  Leaves are tensors (or numpy
arrays, or numbers).  numpy has no bfloat16: a bf16 leaf is stored as
its 16-bit pattern (``uint16``) under the dtype ``"bfloat16"`` in the
manifest, and restored bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import tree as tree_util

__all__ = ["save_pytree", "load_pytree", "CheckpointManager"]


def _host(leaf) -> Any:
    """A snapshot of ``leaf`` off the device: a tensor is copied to the
    CPU (a CPU tensor too: the caller may update it in place while a
    save runs), anything else goes through numpy."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _to_numpy(v) -> Tuple[np.ndarray, str]:
    """``(array to store, manifest dtype)``."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = v.numpy()
        return a, str(a.dtype)
    a = np.asarray(v)
    return a, str(a.dtype)


def save_pytree(tree, directory: str, *, metadata: Optional[Dict] = None,
                n_shards: int = 1) -> None:
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    items = [(k, _to_numpy(_host(v)))
             for k, v in tree_util.flatten_with_paths(tree)]
    manifest = {
        "keys": [k for k, _ in items],
        "dtypes": [dt for _, (_, dt) in items],
        "shapes": [list(a.shape) for _, (a, _) in items],
        "n_shards": n_shards,
        "metadata": metadata or {},
        "time": time.time(),
    }
    for s in range(n_shards):
        blob = {k.replace("/", "__"): a
                for i, (k, (a, _)) in enumerate(items)
                if i % n_shards == s}
        np.savez(os.path.join(tmp, f"shard_{s}.npz"), **blob)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)          # atomic commit


def _from_numpy(a: np.ndarray, dtype: str, like) -> torch.Tensor:
    """The stored array as a tensor of the manifest's dtype, on
    ``like``'s device when ``like`` is a tensor."""
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if isinstance(like, torch.Tensor):
        t = t.to(like.device)
    return t


def load_pytree(template, directory: str) -> Tuple[Any, Dict]:
    """Load into the structure of ``template`` (validated); each leaf a
    tensor on the template leaf's device (the CPU for a non-tensor)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    items = tree_util.flatten_with_paths(template)
    want = [k for k, _ in items]
    if manifest["keys"] != want:
        missing = set(want) - set(manifest["keys"])
        extra = set(manifest["keys"]) - set(want)
        raise ValueError(f"checkpoint structure mismatch: missing="
                         f"{sorted(missing)[:5]} extra={sorted(extra)[:5]}")
    dtypes = dict(zip(manifest["keys"], manifest["dtypes"]))
    blobs: Dict[str, np.ndarray] = {}
    for s in range(manifest["n_shards"]):
        with np.load(os.path.join(directory, f"shard_{s}.npz")) as z:
            for k in z.files:
                blobs[k.replace("__", "/")] = z[k]
    leaves = [_from_numpy(blobs[k], dtypes[k], like) for k, like in items]
    return tree_util.unflatten(template, leaves), manifest["metadata"]


class CheckpointManager:
    """Step-indexed checkpoints with async save and keep-last-k."""

    def __init__(self, root: str, *, keep: int = 3,
                 n_shards: int = 1) -> None:
        self.root = root
        self.keep = keep
        self.n_shards = n_shards
        os.makedirs(root, exist_ok=True)
        self._pending: Optional[threading.Thread] = None

    # -- paths -----------------------------------------------------------------

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:010d}")

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp") \
                    and os.path.isdir(os.path.join(self.root, name)):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save / restore ----------------------------------------------------------

    def save(self, step: int, tree, *, metadata: Optional[Dict] = None,
             blocking: bool = False) -> None:
        self.wait()                        # one in flight at a time
        # snapshot off-device before the thread starts
        host_tree = tree_util.map_tree(_host, tree)

        def work():
            save_pytree(host_tree, self._dir(step), metadata=metadata,
                        n_shards=self.n_shards)
            with open(os.path.join(self.root, "LATEST"), "w") as f:
                f.write(str(step))
            self._gc()

        if blocking:
            work()
        else:
            self._pending = threading.Thread(target=work, daemon=True)
            self._pending.start()

    def restore(self, template, step: Optional[int] = None):
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None, None
        tree, meta = load_pytree(template, self._dir(step))
        return step, tree, meta

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._dir(s), ignore_errors=True)
        for name in os.listdir(self.root):        # crashed partial saves
            if name.endswith(".tmp"):
                full = os.path.join(self.root, name)
                if time.time() - os.path.getmtime(full) > 60:
                    shutil.rmtree(full, ignore_errors=True)
