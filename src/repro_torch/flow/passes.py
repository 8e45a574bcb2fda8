"""The pass layer of the :mod:`repro_torch.flow` pipeline.

Counterpart of :mod:`repro.flow.passes`.  A :class:`Pass` is one named,
instrumented compilation step.  Passes declare which
:class:`~repro_torch.flow.options.CompileOptions` fields they depend on
(``depends``) — the pipeline caches each pass's output keyed by
``(workload, chip, options-prefix)`` where the prefix is the union of
``depends`` along the pass chain, so changing an option a pass never
reads (e.g. ``fidelity``) reuses its cached output.

Every partition strategy is registered as ``partition:<name>``; the
code-generation pass (``codegen``) lowers a partition to per-core ISA
streams on demand and is never cached.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from ..core import workloads
from ..core.codegen import CompiledModel, _compile_model
from ..core.graph import CondensedGraph, Graph
from ..core.partition import STRATEGIES, PartitionResult, _partition
from .options import CompileOptions

__all__ = [
    "Pass", "PassRecord", "PipelineContext", "PASS_REGISTRY",
    "register_pass", "get_pass", "partition_pass_name",
    "CondensePass", "PartitionPass", "CodegenPass",
]


@dataclass
class PassRecord:
    """Instrumentation for one pass execution (or cache hit)."""

    name: str
    wall_s: float
    cached: bool
    summary: str
    key: str = ""                    # pipeline cache key (digest)
    dump_path: Optional[str] = None  # where the JSON IR dump landed

    def describe(self) -> str:
        src = "cache" if self.cached else f"{self.wall_s * 1e3:8.1f} ms"
        line = f"  {self.name:<18s} [{src:>10s}]  {self.summary}"
        if self.dump_path:
            line += f"  -> {self.dump_path}"
        return line


@dataclass
class PipelineContext:
    """Mutable state threaded through the pass chain."""

    workload: Any                    # str | Graph | CondensedGraph
    chip: Any                        # ChipConfig
    options: CompileOptions
    cg: Optional[CondensedGraph] = None
    partition: Optional[PartitionResult] = None
    model: Optional[CompiledModel] = None
    # other passes' outputs (``system:<mode>`` stores its plan here)
    extras: Dict[str, Any] = field(default_factory=dict)


class Pass:
    """Base class for pipeline passes.

    Subclasses set ``name`` (registry key), ``depends`` (the
    ``CompileOptions`` fields feeding this pass's cache key) and
    implement :meth:`run`.  ``summarize`` yields the one-line IR summary
    recorded in the pass trace; ``dump`` optionally returns a
    JSON-serializable IR snapshot written when ``options.dump_dir`` is
    set.
    """

    name: str = "pass"
    depends: Tuple[str, ...] = ()
    # False keeps this pass's output out of the pipeline LRU (codegen:
    # full ISA streams are large, and the Artifact holds its own model)
    cacheable: bool = True

    def run(self, ctx: PipelineContext) -> Any:
        raise NotImplementedError

    def apply(self, ctx: PipelineContext, out: Any) -> None:
        """Store the (possibly cached) output back into the context."""

    def summarize(self, out: Any) -> str:
        return type(out).__name__

    def dump(self, out: Any) -> Optional[Dict[str, Any]]:
        return None

    def write_dump(self, out: Any, dump_dir: str, key: str) -> \
            Optional[str]:
        doc = self.dump(out)
        if doc is None:
            return None
        os.makedirs(dump_dir, exist_ok=True)
        safe = self.name.replace(":", "_")
        path = os.path.join(dump_dir, f"{safe}-{key[:12]}.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True, default=str)
        return path


PASS_REGISTRY: Dict[str, Pass] = {}


def register_pass(p: Pass, replace: bool = False) -> Pass:
    """Register a pass instance under its ``name``."""
    if p.name in PASS_REGISTRY and not replace:
        raise ValueError(f"pass {p.name!r} already registered "
                         f"(pass replace=True to override)")
    PASS_REGISTRY[p.name] = p
    return p


def get_pass(name: str) -> Pass:
    try:
        return PASS_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown pass {name!r}; registered: "
            f"{sorted(PASS_REGISTRY)}") from None


def partition_pass_name(strategy: str) -> str:
    return f"partition:{strategy}"


class CondensePass(Pass):
    """workload (name | Graph | CondensedGraph) -> CondensedGraph."""

    name = "condense"
    depends = ("workload_kw",)

    def run(self, ctx: PipelineContext) -> CondensedGraph:
        w = ctx.workload
        if isinstance(w, str):
            w = workloads.build(w, **ctx.options.workload_kw_dict())
        if isinstance(w, Graph):
            return w.condense()
        if isinstance(w, CondensedGraph):
            return w
        raise TypeError(
            f"workload must be a name, Graph or CondensedGraph, "
            f"got {type(w).__name__}")

    def apply(self, ctx: PipelineContext, out: CondensedGraph) -> None:
        ctx.cg = out

    def summarize(self, out: CondensedGraph) -> str:
        return out.summary()

    def dump(self, out: CondensedGraph) -> Dict[str, Any]:
        return {
            "name": out.name,
            "groups": [{
                "idx": g.idx, "name": g.name, "preds": list(g.preds),
                "gemm": [g.gemm_m, g.gemm_k, g.gemm_n],
                "weight_bytes": g.weight_bytes, "macs": g.macs,
                "in_bytes": g.in_bytes, "out_bytes": g.out_bytes,
            } for g in out],
        }


class PartitionPass(Pass):
    """CondensedGraph -> PartitionResult for one strategy, registered
    as ``partition:<strategy>``."""

    depends = ("strategy", "params")

    def __init__(self, strategy: str) -> None:
        self.strategy = strategy
        self.name = partition_pass_name(strategy)

    def run(self, ctx: PipelineContext) -> PartitionResult:
        return _partition(ctx.cg, ctx.chip, self.strategy,
                          ctx.options.params)

    def apply(self, ctx: PipelineContext, out: PartitionResult) -> None:
        ctx.partition = out

    def summarize(self, out: PartitionResult) -> str:
        return (f"{out.n_stages} stages, "
                f"{out.latency_cycles():.0f} analytic cycles")

    def dump(self, out: PartitionResult) -> Dict[str, Any]:
        return {
            "strategy": out.strategy,
            "n_stages": out.n_stages,
            "latency_cycles": out.latency_cycles(),
            "stages": [{
                "gids": list(s.gids),
                "latency_cycles": s.latency_cycles(),
            } for s in out.stages],
        }


class CodegenPass(Pass):
    """PartitionResult -> CompiledModel (per-core ISA streams)."""

    name = "codegen"
    depends = ("batch", "quant", "strict_lmem")
    cacheable = False

    def run(self, ctx: PipelineContext) -> CompiledModel:
        o = ctx.options
        return _compile_model(ctx.partition, batch=o.resolved_batch(),
                              quant=o.quant_dict() or None,
                              strict_lmem=o.strict_lmem)

    def apply(self, ctx: PipelineContext, out: CompiledModel) -> None:
        ctx.model = out

    def summarize(self, out: CompiledModel) -> str:
        return (f"{out.total_instrs} instrs across "
                f"{len(out.stages)} stage programs (batch={out.batch})")

    def dump(self, out: CompiledModel) -> Dict[str, Any]:
        histo: Dict[str, int] = {}
        for st in out.stages:
            for prog in st.programs.values():
                for ins in prog:
                    histo[ins.op] = histo.get(ins.op, 0) + 1
        return {
            "batch": out.batch,
            "total_instrs": out.total_instrs,
            "gmem_bytes": out.layout.size,
            "instr_histogram": dict(sorted(histo.items())),
            "stage_instrs": [s.total_instrs for s in out.stages],
        }


register_pass(CondensePass())
register_pass(CodegenPass())
for _s in STRATEGIES:
    register_pass(PartitionPass(_s))
