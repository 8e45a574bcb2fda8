"""The :mod:`repro_torch.flow` pipeline: ``compile(workload, chip, options)``.

Counterpart of :mod:`repro.flow.pipeline`::

    art = repro_torch.flow.compile("resnet18", chip,
                                   CompileOptions(strategy="dp",
                                                  workload_kw={"res": 224}))
    art.evaluate("analytic")          # the mapping cost model
    art.evaluate("func:torch")        # the INT8 oracle on the CUDA kernel

The pipeline is a chain of registered passes (condense ->
``partition:<strategy>``), each instrumented with wall time and a
one-line IR summary (``Artifact.describe()``), and each memoized in an
LRU cache keyed by ``(workload, chip, options-prefix)`` — only the
option fields a pass declares in ``depends`` enter its key.

Not ported yet, and raising :class:`NotImplementedError` where reached:
code generation (``fidelity`` ``"simulate"``/``"func"``,
:meth:`Artifact.ensure_model`), the persistent disk cache and the
multi-chip ``system`` path.
"""

from __future__ import annotations

import hashlib
import json
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ..core.arch import ChipConfig
from ..core.graph import CondensedGraph, Graph
from ..core.partition import PartitionResult
from .backends import Backend, EvalReport, resolve_backend
from .options import CompileOptions
from .passes import (Pass, PassRecord, PipelineContext, get_pass,
                     partition_pass_name)

__all__ = ["Artifact", "Pipeline", "compile", "compile_many",
           "default_pipeline", "workload_fingerprint"]

def _missing(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (the {slice_} slice)")


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
    """The result of :func:`compile`: the partitioned model plus the
    instrumented pass trace."""

    workload: Any
    chip: ChipConfig
    options: CompileOptions
    cg: CondensedGraph
    partition: PartitionResult
    trace: List[PassRecord] = field(default_factory=list)

    def ensure_model(self) -> Any:
        raise _missing("code generation (CodegenPass)", "codegen")

    def evaluate(self, backend: Union[str, Backend, None] = None,
                 **kw: Any) -> EvalReport:
        """Score this artifact on a backend (default: the one matching
        ``options.fidelity``)."""
        return resolve_backend(backend, self.options.fidelity).evaluate(
            self, **kw)

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
    """Pass runner with an in-memory LRU output cache.

    One pipeline's cache is shared across all its ``compile()`` calls;
    :func:`default_pipeline` gives every caller in a process
    cross-fidelity partition reuse.  ``cache_size=0`` disables caching.
    """

    def __init__(self, cache_size: int = 8192,
                 disk_cache: Optional[str] = None) -> None:
        if disk_cache is not None:
            raise _missing("the persistent pass disk cache", "disk cache")
        self.cache_size = int(cache_size)
        self._cache: "OrderedDict[str, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def _cache_get(self, key: str) -> Tuple[bool, Any]:
        if key in self._cache:
            self._cache.move_to_end(key)
            self.hits += 1
            return True, self._cache[key]
        self.misses += 1
        return False, None

    def _cache_put(self, key: str, value: Any) -> None:
        if self.cache_size <= 0:
            return
        self._cache[key] = value
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)

    def cache_info(self) -> Dict[str, int]:
        return {"entries": len(self._cache), "hits": self.hits,
                "misses": self.misses}

    def clear_cache(self) -> None:
        self._cache.clear()

    def _run_pass(self, p: Pass, ctx: PipelineContext,
                  prev_key: str) -> Tuple[Any, PassRecord, str]:
        subset = ctx.options.subset_key(p.depends)
        key = hashlib.sha256(
            f"{prev_key}|{p.name}|{subset}".encode()).hexdigest()
        t0 = time.perf_counter()
        cached, out = self._cache_get(key)
        if not cached:
            out = p.run(ctx)
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
            raise _missing("multi-chip compilation (options.system)",
                           "system")
        if options.fidelity in ("simulate", "func"):
            raise _missing(f"fidelity {options.fidelity!r} (it needs "
                           f"code generation)", "codegen")
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
            _, rec, _ = self._run_pass(part_pass, ctx, key)
            arts.append(Artifact(workload=workload, chip=chip,
                                 options=options, cg=ctx.cg,
                                 partition=ctx.partition,
                                 trace=[cond_rec, rec]))
        return arts


_DEFAULT_PIPELINE: Optional[Pipeline] = None


def default_pipeline() -> Pipeline:
    """The process-wide pipeline (shared pass-output cache)."""
    global _DEFAULT_PIPELINE
    if _DEFAULT_PIPELINE is None:
        _DEFAULT_PIPELINE = Pipeline()
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
