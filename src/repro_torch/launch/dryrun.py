"""Multi-pod dry run on a fake process group.

Counterpart of :mod:`repro.launch.dryrun` (``python -m
repro_torch.launch.dryrun``).  For every (architecture x input shape)
cell it builds the production mesh (16x16 single-pod / 2x16x16 two-pod)
over the single-process ``"fake"`` backend
(``torch.testing._internal.distributed.fake_pg.FakeStore``; set up only
when no process group is up, and torn down after), places the step's
inputs on it by the sharding rules, runs the step once on ``meta``
tensors as rank 0 (no data, no card, no communication: the fake group
completes every collective at once), and records per-chip costs and the
three-term roofline on the H100 preset (``--hw tpu-v5e`` restores the
reference's constants).

What replaces XLA's analyses (rank 0's numbers: with uneven shards rank
0 holds the largest):

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode``'s formulas
  (matrix-class ops only; XLA's ``cost_analysis`` counts elementwise
  FLOPs too, so the two are not compared) over every *local* operation
  of the run, DTensor-level calls skipped so nothing is counted twice.
  The blocks are a Python loop, so every block is counted: the
  reference's depth-1/-2 probe extrapolation (``probe_corrected``) is
  not needed.  Attention is counted on the path the step takes: the
  naive scores up to ``FLASH_THRESHOLD``, the blockwise loop above it.
  Without autograd (prefill, decode) a blockwise core that repeats an
  earlier call's shapes and mask adds that call's counts instead of
  walking its loop again (the layers' cores are identical).  MoE runs
  the ``balanced_moe`` probe path (a balanced batched matmul: the
  grouped GEMM's launch is invisible to the counter).
* **Bytes**: the input and output bytes of every local aten operation
  that is not a view: an unfused upper bound, unlike XLA's fused count.
  The blockwise loop is walked, so ``flash_addons`` is *not* added
  (its traffic would be counted twice); ``flash_extra`` records zeros.
* **Collectives**: every functional (``_c10d_functional``) and c10d
  collective of the run, DTensor's redistributions and ``moe_ep``'s
  explicit all-reduces alike, its result bytes by kind (all-reduce: its
  input; all-gather, reduce-scatter, all-to-all: their output);
  ``CommDebugMode``'s count is recorded beside.
* **Memory**: argument bytes exact, from rank 0's local shards of the
  parameters, moments, batch and decode state; temporaries as the peak
  of the bytes held by storages the run created (a sweep every
  ``SWEEP_OPS`` operations: an upper bound by at most that many ops'
  allocations); the fit against the preset's HBM (``fits_hbm``).

Every record keeps the reference's keys, with ``sources`` saying how
each value was obtained; ``fits_16g`` is ``fits_hbm`` here (the H100
has 80 GB).  A cell that fails records ``status: "error"`` with the
reason, and the CLI exits 1.

Usage::

    python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape prefill_32k
    python -m repro_torch.launch.dryrun --all [--multipod] [--out FILE]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from ..configs import ARCHS, STANDARD_SHAPES, cell_skip_reason
from ..configs.base import ArchConfig, ShapeConfig
from ..models import analysis_flags
from ..optim import AdamWConfig
from . import analysis, sharding, steps, tuning
from .mesh import is_distributed, make_production_mesh

__all__ = ["cost_cell", "run_cell", "fake_group", "CostTally", "Counted",
           "main",
           "HW_PRESETS", "DEFAULT_OUT", "SWEEP_OPS"]

DEFAULT_OUT = "results/dryrun_torch.json"
HW_PRESETS = {"h100": analysis.H100, "tpu-v5e": analysis.HW()}
SWEEP_OPS = 32

_COLL_KIND = {"all_reduce": "all-reduce", "allreduce": "all-reduce",
              "all_gather": "all-gather", "allgather": "all-gather",
              "reduce_scatter": "reduce-scatter",
              "all_to_all": "all-to-all", "alltoall": "all-to-all",
              "broadcast": "collective-permute", "send": "collective-permute",
              "recv": "collective-permute"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _coll_kind(func) -> Optional[str]:
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d_functional", "c10d"):
        return None
    name = func._overloadpacket.__name__
    for key, kind in _COLL_KIND.items():
        if name.startswith(key):
            return kind
    return None


class CostTally:
    """Counts of one run: FLOPs, bytes, collective bytes by kind, and the
    peak bytes held by storages the run created.  :meth:`mode` gives the
    ``TorchDispatchMode`` that counts."""

    def __init__(self) -> None:
        from torch.utils.flop_counter import FlopCounterMode
        self.registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.coll = {k: 0 for k in ("all-reduce", "all-gather",
                                    "reduce-scatter", "all-to-all",
                                    "collective-permute")}
        self.coll["count"] = 0
        self.live: Dict[int, tuple] = {}
        self.live_bytes = 0
        self.peak = 0
        self.paused = False

    # memory ------------------------------------------------------------
    def track(self, t: torch.Tensor) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef
        st = t.untyped_storage()
        key = st._cdata
        if key not in self.live:
            n = st.nbytes()
            self.live[key] = (StorageWeakRef(st), n)
            self.live_bytes += n

    def sweep(self) -> None:
        self.peak = max(self.peak, self.live_bytes)
        dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
        for k in dead:
            self.live_bytes -= self.live.pop(k)[1]

    # counts ------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes": self.bytes,
                "coll": dict(self.coll), "ops": self.ops}

    def add(self, delta: Dict[str, Any]) -> None:
        self.flops += delta["flops"]
        self.bytes += delta["bytes"]
        self.ops += delta["ops"]
        for k, v in delta["coll"].items():
            self.coll[k] += v

    @staticmethod
    def diff(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
        return {"flops": b["flops"] - a["flops"],
                "bytes": b["bytes"] - a["bytes"], "ops": b["ops"] - a["ops"],
                "coll": {k: b["coll"][k] - a["coll"][k] for k in b["coll"]}}

    def count(self, func, args, kwargs, out) -> None:
        self.ops += 1
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        kind = _coll_kind(func)
        if kind is not None:
            self.coll[kind] += (_nbytes(ins) if kind == "all-reduce"
                                else _nbytes(outs))
            self.coll["count"] += 1
        elif func._overloadpacket in self.registry:
            self.flops += self.registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        if kind is None and not func.is_view:
            self.bytes += _nbytes(ins) + _nbytes(outs)
        for t in outs:
            self.track(t)
        if self.ops % SWEEP_OPS == 0:
            self.sweep()

    def mode(self):
        """The mode that counts operations on plain tensors (factories,
        masks); operations on :class:`Counted` tensors count themselves,
        and DTensor-level calls are skipped (their local operations on
        the ``Counted`` shards are the ones counted)."""
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        tally = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                if not tally.paused and not any(
                        issubclass(t, (DTensor, Counted)) for t in types):
                    tally.count(func, args, kwargs, out)
                return out

        return _Mode()


class Counted(torch.Tensor):
    """A ``meta`` tensor that adds every operation run on it to
    ``Counted.tally``: the step's inputs are wrapped in it, so the local
    shards a DTensor computes on (whose operations no dispatch mode
    sees) are counted, and everything computed from them is ``Counted``
    too."""

    tally: Optional[CostTally] = None

    @staticmethod
    def __new__(cls, elem: torch.Tensor):
        r = torch.Tensor._make_wrapper_subclass(
            cls, elem.shape, strides=elem.stride(),
            storage_offset=elem.storage_offset(), dtype=elem.dtype,
            device=elem.device, requires_grad=elem.requires_grad)
        r.elem = elem
        return r

    __torch_function__ = torch._C._disabled_torch_function_impl

    def __repr__(self) -> str:
        return f"Counted({tuple(self.shape)}, {self.dtype})"

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        from torch.utils._pytree import tree_map
        un = tree_map(lambda t: t.elem if isinstance(t, Counted) else t,
                      (args, kwargs or {}))
        out = func(*un[0], **un[1])
        tally = Counted.tally
        if tally is not None and not tally.paused:
            tally.count(func, un[0], un[1], out)
        return tree_map(lambda t: Counted(t) if isinstance(
            t, torch.Tensor) and not isinstance(t, Counted) else t, out)


def _plain(t: torch.Tensor) -> torch.Tensor:
    """The meta tensor under a DTensor's local shard and a ``Counted``."""
    if hasattr(t, "to_local"):
        t = t.to_local()
    return t.elem if isinstance(t, Counted) else t


@contextlib.contextmanager
def _flash_memo(tally: CostTally):
    """Within: a blockwise attention call made without autograd whose
    inputs' shapes, dtypes, mask and first position repeat an earlier
    call's adds that call's counts (and its peak) instead of walking the
    loop again; its output is a new ``meta`` tensor of the same shape."""
    from ..models import layers as L
    real = L.flash_attention
    seen: Dict[tuple, tuple] = {}

    def memo(q, k, v, mask_fn, q_pos0=0, *a, **kw):
        if torch.is_grad_enabled() or not isinstance(q, Counted):
            return real(q, k, v, mask_fn, q_pos0, *a, **kw)
        cells = tuple(c.cell_contents for c in (mask_fn.__closure__ or ()))
        key = (tuple(q.shape), tuple(k.shape), tuple(v.shape), q.dtype,
               k.dtype, mask_fn.__code__, cells, q_pos0, a,
               tuple(sorted(kw.items())))
        if key in seen:
            delta, extra, shape, dtype = seen[key]
            tally.add(delta)
            tally.sweep()
            tally.peak = max(tally.peak, tally.live_bytes + extra)
            tally.paused = True
            try:
                out = torch.empty(shape, dtype=dtype, device="meta")
            finally:
                tally.paused = False
            tally.track(out)
            return Counted(out)
        tally.sweep()
        before, live0, peak0 = tally.snapshot(), tally.live_bytes, tally.peak
        tally.peak = live0
        out = real(q, k, v, mask_fn, q_pos0, *a, **kw)
        tally.sweep()
        extra = tally.peak - live0
        tally.peak = max(tally.peak, peak0)
        seen[key] = (CostTally.diff(before, tally.snapshot()), extra,
                     tuple(out.shape), out.dtype)
        return out

    L.flash_attention = memo
    try:
        yield
    finally:
        L.flash_attention = real


@contextlib.contextmanager
def fake_group(world: int):
    """A single-process ``"fake"`` process group of ``world`` ranks (this
    process rank 0) when none is up, destroyed after; an existing group
    is used as it is."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _build_step(cfg: ArchConfig, shape: ShapeConfig, mesh):
    if shape.kind == "train":
        return steps.make_train_step(cfg, "meta", shape, mesh=mesh)
    if shape.kind == "prefill":
        return steps.make_prefill_step(cfg, "meta", shape, mesh=mesh)
    return steps.make_decode_step(cfg, "meta", shape, mesh=mesh)


def _meta_batch(spec) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(s, dtype=dt, device="meta")
            for k, (s, dt) in spec.items() if k != "step"}


def _local_bytes(tree) -> int:
    from ..tree import leaves
    return sum(_plain(t).numel() * _plain(t).element_size()
               for t in leaves(tree) if isinstance(t, torch.Tensor))


def _counted(tree) -> Any:
    """``tree`` (meta tensors, mappings, lists, parameter trees) with
    every tensor a :class:`Counted`."""
    from ..models.transformer import ParamTree
    if isinstance(tree, ParamTree):
        out = tree.map(Counted)
        out.compute_dtype = tree.compute_dtype
        return out
    if isinstance(tree, dict):
        return {k: _counted(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_counted(v) for v in tree]
    return Counted(tree) if isinstance(tree, torch.Tensor) else tree


def _inputs(cfg: ArchConfig, shape: ShapeConfig, fn, spec, mesh):
    """The step's inputs on ``meta``, placed by ``fn.specs`` over a
    distributed mesh: ``(args, argument bytes of rank 0)``."""
    params = _counted(steps.abstract_params(cfg))
    place = (lambda tree, key: sharding.distribute(mesh, _counted(tree),
                                                   fn.specs[key])) \
        if is_distributed(mesh) else (lambda tree, key: _counted(tree))
    params = place(params, "params")
    if shape.kind == "train":
        opt = place(steps.abstract_opt_state(cfg, AdamWConfig()), "opt")
        batch = place(_meta_batch(spec), "batch")
        args = (params, opt, batch, 0)
        held = (params, opt, batch)
    elif shape.kind == "prefill":
        batch = place(_meta_batch(spec), "batch")
        args = (params, batch)
        held = (params, batch)
    else:
        state = place(steps.abstract_state(cfg, shape.global_batch,
                                           shape.seq_len), "state")
        (s, dt), = spec.values()
        token = Counted(torch.empty(s, dtype=dt, device="meta"))
        if is_distributed(mesh):
            token = sharding.distribute(mesh, {"t": token},
                                        {"t": fn.specs["token"]})["t"]
        args = (params, state, token)
        held = (params, state, token)
    return args, sum(_local_bytes(t) for t in held)


def _head_choice(cfg: ArchConfig, mesh) -> str:
    if tuning.FLAGS["attn_seq_parallel"]:
        return "sequence"
    return sharding.head_sharding_choice(cfg, mesh)


def cost_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
              hw: analysis.HW = analysis.H100) -> Dict:
    """One cell's per-chip costs on ``mesh`` (a ``DeviceMesh`` over a
    process group, the fake one included, or the one-device
    ``LocalMesh``): the step run once on ``meta`` tensors as this rank,
    counted (see the module's account), and its roofline on ``hw``.
    Returns the record without ``arch``/``shape``/``status``."""
    n_chips = mesh.size()
    rec: Dict = {"mesh": "x".join(str(s) for s in mesh.shape),
                 "n_chips": n_chips, "kind": shape.kind,
                 "head_sharding": _head_choice(cfg, mesh)}
    t0 = time.time()
    tally = CostTally()
    prev = dict(analysis_flags.FLAGS)
    analysis_flags.FLAGS.update(balanced_moe=True)
    try:
        fn, spec = _build_step(cfg, shape, mesh)
        args, arg_bytes = _inputs(cfg, shape, fn, spec, mesh)
        rec["lower_s"] = round(time.time() - t0, 1)
        from torch.distributed.tensor.debug import CommDebugMode
        t1 = time.time()
        Counted.tally = tally
        with CommDebugMode() as comm, tally.mode(), _flash_memo(tally):
            out = fn(*args)
            tally.sweep()
        rec["compile_s"] = round(time.time() - t1, 1)
    finally:
        Counted.tally = None
        analysis_flags.FLAGS.clear()
        analysis_flags.FLAGS.update(prev)
    out_bytes = _local_bytes(out)
    # outputs that are inputs updated in place (parameters, moments, a
    # decode state's caches)
    from ..tree import leaves
    in_ptrs = {_plain(t).untyped_storage()._cdata
               for a in args for t in leaves(a)
               if isinstance(t, torch.Tensor)}
    alias = sum(_plain(t).numel() * _plain(t).element_size()
                for t in leaves(out) if isinstance(t, torch.Tensor)
                and _plain(t).untyped_storage()._cdata in in_ptrs)
    gib = 2.0 ** 30
    live = arg_bytes + tally.peak
    rec["memory"] = {
        "argument_gib": arg_bytes / gib, "output_gib": out_bytes / gib,
        "temp_gib": tally.peak / gib, "alias_gib": alias / gib,
        "live_gib": live / gib, "hbm_gib": hw.hbm_bytes / gib,
        "fits_hbm": bool(live <= hw.hbm_bytes)}
    rec["cost"] = {"flops": float(tally.flops),
                   "bytes accessed": float(tally.bytes)}
    rec["cost_raw"] = dict(rec["cost"])
    rec["collectives"] = dict(tally.coll)
    rec["collectives_raw"] = dict(tally.coll)
    rec["comm_debug_count"] = int(comm.get_total_counts())
    rec["ops_counted"] = tally.ops
    rec["probe_s"] = 0.0
    rec["flash_extra"] = {"hbm": 0.0, "link": 0.0}
    terms = analysis.roofline_terms(rec["cost"], rec["collectives"], hw)
    rec["roofline"] = terms.as_dict()
    mf = analysis.model_flops(cfg, shape, n_chips)
    rec["model_flops"] = mf
    rec["useful_flops_frac"] = (mf / terms.flops) if terms.flops else None
    name = "h100" if hw == analysis.H100 else (
        "tpu-v5e" if hw == analysis.HW() else "custom")
    rec["hw"] = dict(name=name, **{k: getattr(hw, k) for k in (
        "peak_flops", "hbm_bw", "ici_bw", "ici_links", "hbm_bytes")})
    rec["sources"] = {
        "memory.argument_gib": "exact: rank 0's local shards of the "
                               "step's inputs",
        "memory.temp_gib": f"counted: peak bytes of the storages the meta "
                           f"run created (swept every {SWEEP_OPS} ops: an "
                           f"upper bound)",
        "memory.output_gib": "exact: rank 0's local shards of the outputs",
        "memory.alias_gib": "exact: outputs sharing an input's storage",
        "cost.flops": "counted: FlopCounterMode's formulas over rank 0's "
                      "local ops (matrix-class ops only)",
        "cost.bytes accessed": "counted: input + output bytes of every "
                               "local non-view aten op (unfused upper "
                               "bound)",
        "collectives": "counted: result bytes of the functional and c10d "
                       "collectives of the run",
        "comm_debug_count": "counted: CommDebugMode",
        "flash_extra": "not added: the count walks the blockwise loop",
        "roofline": f"analytic: launch.analysis.roofline_terms on the "
                    f"{name} preset",
        "model_flops": "analytic: launch.analysis.model_flops",
    }
    rec["status"] = "ok"
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             hw: analysis.HW = analysis.H100) -> Dict:
    """One cell on the production mesh over a fake group."""
    cfg = ARCHS[arch]
    shape = STANDARD_SHAPES[shape_name]
    skip = cell_skip_reason(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name,
                "mesh": "2x16x16" if multi_pod else "16x16",
                "status": "skipped", "reason": skip}
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        rec = {"arch": arch, "shape": shape_name}
        rec.update(cost_cell(cfg, shape, mesh, hw))
    return rec


def _load(path: str) -> Dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def _save(path: str, data: Dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true",
                    help="2x16x16 two-pod mesh (default single-pod 16x16)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true",
                    help="recompute cached cells")
    ap.add_argument("--hw", choices=sorted(HW_PRESETS), default="h100",
                    help="roofline constants (default: one H100 SXM)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(STANDARD_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multipod]
    if not (args.all or args.arch or args.shape):
        ap.error("pass --all or --arch/--shape")
    hw = HW_PRESETS[args.hw]

    results = _load(args.out)
    failures = 0
    for multi in meshes:
        for a in archs:
            for s in shapes:
                key = f"{a}|{s}|{'2pod' if multi else '1pod'}"
                if key in results and not args.force \
                        and results[key].get("status") in ("ok", "skipped"):
                    print(f"[cached] {key}")
                    continue
                print(f"[run] {key} ...", flush=True)
                try:
                    rec = run_cell(a, s, multi, hw)
                except Exception as e:           # noqa: BLE001
                    rec = {"arch": a, "shape": s, "status": "error",
                           "mesh": "2x16x16" if multi else "16x16",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    failures += 1
                results[key] = rec
                _save(args.out, results)
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" dominant={r['dominant']} "
                             f"compute={r['compute_s']:.3g}s "
                             f"mem={r['memory_s']:.3g}s "
                             f"coll={r['collective_s']:.3g}s "
                             f"live={rec['memory']['live_gib']:.1f}GiB "
                             f"(place {rec['lower_s']}s, "
                             f"count {rec['compile_s']}s)")
                elif status == "error":
                    extra = f" {rec['error']}"
                print(f"  -> {status}{extra}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
