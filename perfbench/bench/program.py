"""The system under test: the port's steps, built as its launchers build
them.  The only module of the benchmark that imports ``repro_torch``.

Training drives ``launch.steps.make_train_step`` on float32 masters (as
``launch/train.py``); prefill drives ``make_prefill_step`` on the served
tree, cast once per model to the compute dtype (as ``launch/serve.py``
casts), so the step's own cast returns that tree unchanged.  Both run
under the launchers' local ``(1, 1)`` ``("data", "model")`` mesh, which
sends MoE layers through ``models/moe_ep``.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable, Dict, Tuple

from .spec import ROOT

_SRC = str(ROOT / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

from repro_torch import tree as tree_util                  # noqa: E402
from repro_torch.configs import ARCHS, ShapeConfig           # noqa: E402
from repro_torch.launch import meshctx, steps                # noqa: E402
from repro_torch.launch.mesh import make_mesh                # noqa: E402
from repro_torch.models import transformer as T              # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init        # noqa: E402

# overrides of these keys replace fields of the nested groups
_NESTED = ("ssm", "moe", "mla")

# the configuration file's model keys and the port's fields they match
_MODEL_KEYS = {
    "d_model": lambda a: a.d_model, "n_layers": lambda a: a.n_layers,
    "vocab": lambda a: a.vocab, "tie_embeddings": lambda a: a.tie_embeddings,
    "n_heads": lambda a: a.n_heads, "n_kv_heads": lambda a: a.n_kv_heads,
    "head_dim": lambda a: (a.ssm.head_dim if a.ssm is not None else a.hd),
    "rope_theta": lambda a: a.rope_theta,
    "d_state": lambda a: a.ssm.d_state, "d_conv": lambda a: a.ssm.d_conv,
    "expand": lambda a: a.ssm.expand, "n_groups": lambda a: a.ssm.n_groups,
    "chunk": lambda a: a.ssm.chunk,
    "n_experts": lambda a: a.moe.n_experts,
    "experts_per_tok": lambda a: a.moe.experts_per_tok,
    "expert_d_ff": lambda a: a.moe.d_ff,
}


def arch(config: Dict[str, Any]):
    """The port's ``ArchConfig`` named by the configuration file, with
    its ``port.overrides`` applied (nested groups by their fields), held
    to the file's ``model`` sizes."""
    port = config["port"]
    a = ARCHS[port["arch"]]
    kw = {}
    for k, v in port.get("overrides", {}).items():
        if k in _NESTED and isinstance(v, dict):
            kw[k] = dataclasses.replace(getattr(a, k), **v)
        else:
            kw[k] = v
    a = dataclasses.replace(a, **kw)
    for k, v in config["model"].items():
        if k in _MODEL_KEYS and _MODEL_KEYS[k](a) != v:
            raise ValueError(f"{config['name']}: the port runs {k} = "
                             f"{_MODEL_KEYS[k](a)}, the file states {v}")
    return a


def mesh_context():
    """The launchers' local mesh as the current mesh context."""
    mesh = make_mesh((1, 1), ("data", "model"))
    return meshctx.use_mesh(mesh, data_axes=())


def train_tree(nested: Dict) -> T.ParamTree:
    """The masters as the port's parameter tree (the same storage)."""
    return T.ParamTree(nested)


def served_tree(a, nested: Dict) -> T.ParamTree:
    """The served tree: leaves already in the compute dtype, marked so
    that the step's cast keeps it as it is."""
    t = T.ParamTree(nested)
    t.compute_dtype = T._dt(a)[1]
    return t


def adamw(opt: Dict[str, Any]) -> AdamWConfig:
    return AdamWConfig(b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                       weight_decay=opt["weight_decay"],
                       clip_norm=opt["clip_norm"],
                       moment_dtype=opt["moment_dtype"])


def train_step(a, device, batch: int, seq: int, opt: Dict[str, Any]
               ) -> Tuple[Callable, Callable]:
    """``(step, init_opt)``: the port's train step and its AdamW state
    maker."""
    cfg = adamw(opt)
    step, _ = steps.make_train_step(
        a, device, ShapeConfig("bench", seq, batch, "train"), cfg,
        lr_peak=opt["lr_peak"], warmup=opt["warmup"],
        total_steps=opt["total_steps"])
    return step, lambda params: adamw_init(params, cfg)


def prefill_step(a, device, batch: int, seq: int) -> Callable:
    step, _ = steps.make_prefill_step(
        a, device, ShapeConfig("bench", seq, batch, "prefill"))
    return step


def leaves(tree) -> list:
    return tree_util.leaves(tree)


def counters() -> Dict[str, Any]:
    """The port's launch counters by route (host counts, no device
    work), read to record which routes a run took."""
    from repro_torch.kernels import (flash_attention, gated_norm,
                                     grouped_gemm, ssd_scan)
    out = {}
    for name, mod in (("ssd_scan", ssd_scan), ("gated_norm", gated_norm),
                      ("grouped_gemm", grouped_gemm),
                      ("flash_attention", flash_attention)):
        by = getattr(mod, "launches_by_route", None)
        if isinstance(by, dict):
            out[name] = dict(by)
    return out
