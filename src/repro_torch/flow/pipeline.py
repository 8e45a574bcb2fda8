"""The :mod:`repro_torch.flow` pipeline: ``compile(workload, chip, options)``.

Counterpart of :mod:`repro.flow.pipeline`::

    art = repro_torch.flow.compile("resnet18", chip,
                                   CompileOptions(strategy="dp",
                                                  workload_kw={"res": 224}))
    art.evaluate("analytic")          # the mapping cost model
    art.evaluate("trace")             # StagePlan replay
    art.evaluate("simulate")          # cycle-accurate ISS on the ISA
    art.evaluate("func:torch")        # the INT8 oracle on the CUDA kernel

The pipeline is a chain of registered passes (condense ->
``partition:<strategy>`` -> codegen-on-demand), each instrumented with
wall time and a one-line IR summary (``Artifact.describe()``), and the
first two memoized in an LRU cache keyed by ``(workload, chip,
options-prefix)`` — only the option fields a pass declares in
``depends`` enter its key.  Below the LRU, an optional disk tier
(:class:`~repro_torch.flow.diskcache.PassDiskCache`) shares pass outputs
across processes.  Codegen runs eagerly for the simulator fidelities
(``"simulate"``/``"func"``) and on demand otherwise
(:meth:`Artifact.ensure_model`).  ``options.system`` (a
:class:`~repro_torch.system.SystemConfig`) routes the compile through the
``system:<mode>`` partition pass and returns a
:class:`~repro_torch.system.SystemArtifact`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.arch import ChipConfig
from ..core.codegen import CompiledModel
from ..core.graph import CondensedGraph, Graph
from ..core.partition import PartitionResult
from .backends import Backend, EvalReport, resolve_backend
from .diskcache import ENV_VAR as _CACHE_ENV
from .diskcache import PassDiskCache
from .options import CompileOptions
from .passes import (Pass, PassRecord, PipelineContext, get_pass,
                     partition_pass_name)

__all__ = ["Artifact", "Pipeline", "compile", "compile_many",
           "default_pipeline", "workload_fingerprint"]


def workload_fingerprint(workload: Any) -> str:
    """Structural identity of a workload for pass-cache keying: named
    workloads key by name, graph objects by a digest of their op (or
    group) structure."""
    if isinstance(workload, str):
        return f"name:{workload}"

    def op_desc(g: Graph) -> list:
        return [(op.idx, op.name, op.kind, tuple(op.inputs),
                 tuple(op.out_shape), sorted(op.attrs.items()),
                 op.gemm_m, op.gemm_k, op.gemm_n, op.groups)
                for op in g.ops]

    if isinstance(workload, Graph):
        desc: Any = op_desc(workload)
        kind = "graph"
    elif isinstance(workload, CondensedGraph):
        desc = (op_desc(workload.source)
                if workload.source is not None else None,
                [(g.idx, g.name, tuple(g.preds), g.gemm_m, g.gemm_k,
                  g.gemm_n, g.groups, g.macs, g.weight_bytes,
                  g.in_bytes, g.out_bytes,
                  sorted(g.vector_work.items()))
                 for g in workload])
        kind = "cg"
    else:
        raise TypeError(f"workload must be a name, Graph or "
                        f"CondensedGraph, got {type(workload).__name__}")
    blob = repr((workload.name, desc)).encode()
    return f"{kind}:{hashlib.sha256(blob).hexdigest()}"


def _chip_fingerprint(chip: ChipConfig) -> str:
    d = chip.to_dict()
    d.pop("name", None)          # labels are cosmetic
    blob = json.dumps(d, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


@dataclass
class Artifact:
    """The result of :func:`compile`: the partitioned (and, on demand,
    code-generated) model plus the instrumented pass trace."""

    workload: Any
    chip: ChipConfig
    options: CompileOptions
    cg: CondensedGraph
    partition: PartitionResult
    trace: List[PassRecord] = field(default_factory=list)
    _pipeline: Optional["Pipeline"] = None
    _chain_key: str = ""         # cache-key prefix up to the partition
    _model: Optional[CompiledModel] = None

    @property
    def model(self) -> Optional[CompiledModel]:
        """The compiled ISA streams, or ``None`` before codegen ran."""
        return self._model

    def ensure_model(self) -> CompiledModel:
        """Run the codegen pass once for this artifact."""
        if self._model is None:
            ctx = PipelineContext(workload=self.workload, chip=self.chip,
                                  options=self.options, cg=self.cg,
                                  partition=self.partition)
            pipe = self._pipeline or default_pipeline()
            out, rec, _ = pipe._run_pass(get_pass("codegen"), ctx,
                                         self._chain_key)
            self._model = out
            self.trace.append(rec)
        return self._model

    def build_gmem_image(self, weights: Any, biases: Any,
                         inputs: Any) -> np.ndarray:
        """The functional ISS's global-memory image (numpy int8)."""
        return self.ensure_model().build_gmem_image(weights, biases,
                                                    inputs)

    def output_addr(self, gid: int, sample: int) -> Tuple[int, int]:
        return self.ensure_model().output_addr(gid, sample)

    @property
    def total_instrs(self) -> int:
        return self.ensure_model().total_instrs

    def evaluate(self, backend: Union[str, Backend, None] = None,
                 **kw: Any) -> EvalReport:
        """Score this artifact on a backend (default: the one matching
        ``options.fidelity``)."""
        return resolve_backend(backend, self.options.fidelity).evaluate(
            self, **kw)

    def replace_options(self, **kw: Any) -> "Artifact":
        """This artifact under tweaked *evaluation* options — the
        compiled partition is shared, nothing re-runs.  Fields that
        feed codegen (``batch``, ``quant``, ``strict_lmem``) drop the
        cached model so ``ensure_model`` re-lowers on demand; fields
        that determine the partition itself (``strategy``, ``params``,
        ``workload_kw``) cannot be swapped under a finished compile —
        re-run :func:`compile` for those."""
        stale = {"strategy", "params", "workload_kw"} & set(kw)
        if stale:
            raise ValueError(
                f"{sorted(stale)} change the partition; recompile via "
                f"flow.compile(...) instead of replace_options")
        opts = self.options.replace(**kw)
        keep_model = self._model if not (
            {"batch", "quant", "strict_lmem"} & set(kw)) else None
        return dataclasses.replace(self, options=opts,
                                   trace=list(self.trace),
                                   _model=keep_model)

    def pass_record(self, name: str) -> Optional[PassRecord]:
        """Latest trace record for a pass (``"partition"`` matches the
        strategy-qualified partition pass)."""
        for rec in reversed(self.trace):
            if rec.name == name or (name == "partition"
                                    and rec.name.startswith("partition:")):
                return rec
        return None

    def describe(self) -> str:
        head = (f"flow artifact: '{self.cg.name}' on "
                f"'{self.chip.name}' — {self.options.describe()}")
        return "\n".join([head] + [r.describe() for r in self.trace])


class Pipeline:
    """Pass runner with a two-tier (LRU + optional disk) output cache.

    One pipeline's cache is shared across all its ``compile()`` calls;
    :func:`default_pipeline` gives every caller in a process
    cross-fidelity partition reuse.  ``cache_size=0`` disables caching.

    ``disk_cache`` (a directory path or :class:`PassDiskCache`) adds a
    persistent tier below the LRU, shared *across processes*: explore's
    pool workers — and a re-run of the same sweep — skip re-partitioning
    anything any process already partitioned.
    """

    def __init__(self, cache_size: int = 8192,
                 disk_cache: Union[str, PassDiskCache, None] = None
                 ) -> None:
        self.cache_size = int(cache_size)
        self._cache: "OrderedDict[str, Any]" = OrderedDict()
        if isinstance(disk_cache, str):
            disk_cache = PassDiskCache(disk_cache)
        self.disk = disk_cache
        self.hits = 0
        self.misses = 0

    def _cache_get(self, key: str) -> Tuple[bool, Any]:
        if key in self._cache:
            self._cache.move_to_end(key)
            self.hits += 1
            return True, self._cache[key]
        if self.disk is not None:
            ok, out = self.disk.get(key)
            if ok:
                self.hits += 1
                self._mem_put(key, out)     # promote to the hot tier
                return True, out
        self.misses += 1
        return False, None

    def _mem_put(self, key: str, value: Any) -> None:
        if self.cache_size <= 0:
            return
        self._cache[key] = value
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)

    def _cache_put(self, key: str, value: Any) -> None:
        self._mem_put(key, value)
        if self.disk is not None:
            self.disk.put(key, value)

    def cache_info(self) -> Dict[str, int]:
        info = {"entries": len(self._cache), "hits": self.hits,
                "misses": self.misses}
        if self.disk is not None:
            info["disk_hits"] = self.disk.hits
            info["disk_misses"] = self.disk.misses
        return info

    def clear_cache(self) -> None:
        self._cache.clear()

    def _run_pass(self, p: Pass, ctx: PipelineContext,
                  prev_key: str) -> Tuple[Any, PassRecord, str]:
        subset = ctx.options.subset_key(p.depends)
        key = hashlib.sha256(
            f"{prev_key}|{p.name}|{subset}".encode()).hexdigest()
        t0 = time.perf_counter()
        cached, out = (self._cache_get(key) if p.cacheable
                       else (False, None))
        if not cached:
            out = p.run(ctx)
            if p.cacheable:
                self._cache_put(key, out)
        dump_path = None
        if ctx.options.dump_dir:
            dump_path = p.write_dump(out, ctx.options.dump_dir, key)
        p.apply(ctx, out)
        rec = PassRecord(name=p.name, wall_s=time.perf_counter() - t0,
                         cached=cached, summary=p.summarize(out),
                         key=key[:16], dump_path=dump_path)
        return out, rec, key

    def compile(self, workload: Any, chip: ChipConfig,
                options: Optional[CompileOptions] = None,
                **kw: Any) -> Artifact:
        """Compile ``workload`` for ``chip`` under ``options`` (extra
        keyword arguments are folded into the options)."""
        return self.compile_many(workload, [chip], options, **kw)[0]

    def compile_many(self, workload: Any, chips: Sequence[ChipConfig],
                     options: Optional[CompileOptions] = None,
                     **kw: Any) -> List[Artifact]:
        """Compile one workload against N chips: the condense pass runs
        (or cache-hits) once, the partition pass once per chip."""
        if options is None:
            options = CompileOptions(**kw)
        elif kw:
            options = options.replace(**kw)
        if options.system is not None:
            return [self._compile_system(workload, chip, options)
                    for chip in chips]
        try:
            part_pass = get_pass(partition_pass_name(options.strategy))
        except KeyError:
            raise KeyError(
                f"unknown strategy {options.strategy!r}: no "
                f"{partition_pass_name(options.strategy)!r} pass "
                f"registered") from None

        # condense is chip-independent: one cache entry serves every
        # chip; the chip fingerprint enters the chain before partition
        base = hashlib.sha256(
            workload_fingerprint(workload).encode()).hexdigest()
        ctx0 = PipelineContext(workload=workload,
                               chip=chips[0] if chips else None,
                               options=options)
        _, cond_rec, cond_key = self._run_pass(get_pass("condense"),
                                               ctx0, base)
        arts: List[Artifact] = []
        for chip in chips:
            ctx = PipelineContext(workload=workload, chip=chip,
                                  options=options, cg=ctx0.cg)
            key = hashlib.sha256(
                f"{cond_key}|chip:{_chip_fingerprint(chip)}"
                .encode()).hexdigest()
            _, rec, key = self._run_pass(part_pass, ctx, key)
            art = Artifact(workload=workload, chip=chip, options=options,
                           cg=ctx.cg, partition=ctx.partition,
                           trace=[cond_rec, rec], _pipeline=self,
                           _chain_key=key)
            # only the simulator fidelities need ISA streams; analytic
            # and trace evaluate straight off the partition
            if options.fidelity in ("simulate", "func"):
                art.ensure_model()
            arts.append(art)
        return arts

    def _compile_system(self, workload: Any, chip: ChipConfig,
                        options: CompileOptions) -> Any:
        """The ``options.system`` path: condense once, run the
        ``system:<mode>`` partition pass, then compile each chip slice
        through the ordinary single-chip pipeline (``system=None``) —
        a 1x1 mesh therefore produces an inner artifact bit-identical
        to the classic path.  Returns a
        :class:`repro_torch.system.SystemArtifact`.
        """
        # imported lazily: repro_torch.system imports repro_torch.flow at
        # module level, so flow -> system must stay function-local
        from ..system import SystemArtifact
        from ..system.passes import system_pass_name

        sysc = options.system
        if sysc.parallel == "tensor" and sysc.n_chips > 1 \
                and options.fidelity in ("simulate", "func"):
            raise ValueError(
                "tensor-parallel plans support analytic/trace fidelity "
                "only (shards are group-level scaled condensed graphs "
                "with no per-shard ISA streams); use "
                "parallel='pipeline' for simulator fidelities")

        base = hashlib.sha256(
            workload_fingerprint(workload).encode()).hexdigest()
        ctx0 = PipelineContext(workload=workload, chip=chip,
                               options=options)
        _, cond_rec, cond_key = self._run_pass(get_pass("condense"),
                                               ctx0, base)
        ctx = PipelineContext(workload=workload, chip=chip,
                              options=options, cg=ctx0.cg)
        key = hashlib.sha256(
            f"{cond_key}|chip:{_chip_fingerprint(chip)}"
            .encode()).hexdigest()
        plan, rec, key = self._run_pass(
            get_pass(system_pass_name(sysc.parallel)), ctx, key)

        inner = options.replace(system=None)
        arts = [self.compile(sl.workload if sl.workload is not None
                             else workload, chip, inner)
                for sl in plan.slices]
        return SystemArtifact(workload=workload, chip=chip,
                              options=options, cg=ctx.cg, plan=plan,
                              chips=arts, trace=[cond_rec, rec])


_DEFAULT_PIPELINE: Optional[Pipeline] = None


def default_pipeline() -> Pipeline:
    """The process-wide pipeline (shared pass-output cache).

    When the ``REPRO_TORCH_FLOW_CACHE`` environment variable names a
    directory, the pipeline also persists pass outputs there —
    processes pointed at the same directory (e.g. explore pool workers)
    share partitions.  Set before first use; the pipeline is created
    once per process.
    """
    global _DEFAULT_PIPELINE
    if _DEFAULT_PIPELINE is None:
        _DEFAULT_PIPELINE = Pipeline(
            disk_cache=os.environ.get(_CACHE_ENV) or None)
    return _DEFAULT_PIPELINE


def compile(workload: Any, chip: ChipConfig,
            options: Optional[CompileOptions] = None, *,
            pipeline: Optional[Pipeline] = None,
            **kw: Any) -> Artifact:
    """The stable compile entry point (see :meth:`Pipeline.compile`)."""
    return (pipeline or default_pipeline()).compile(workload, chip,
                                                    options, **kw)


def compile_many(workload: Any, chips: Sequence[ChipConfig],
                 options: Optional[CompileOptions] = None, *,
                 pipeline: Optional[Pipeline] = None,
                 **kw: Any) -> List[Artifact]:
    """Batched compile: one workload, N candidate chips, one condense."""
    return (pipeline or default_pipeline()).compile_many(
        workload, chips, options, **kw)
