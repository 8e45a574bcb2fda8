"""The multi-chip compile artifact: per-chip artifacts + the plan.

``flow.compile(workload, chip, system=SystemConfig(...))`` returns a
:class:`SystemArtifact` instead of a plain
:class:`~repro_torch.flow.pipeline.Artifact` — same ``evaluate`` /
``replace_options`` / ``describe`` surface, so serve and explore
consume it with no caller change.  Each chip slice is a *real*
single-chip artifact (full pass cache, full fidelity ladder); this
module only stitches.

Func mode is the one fidelity that cannot be a per-chip black box —
chips exchange activations — so it lives here as
:meth:`SystemArtifact.run_func`: chips execute **sequentially** on the
functional ISS, each cut-crossing output harvested from the producer
chip's gmem and concatenated into the consumer chip's input region.
The result is bit-exact with the single-chip oracle
(``repro_torch.core.ref.run_reference`` on the unsplit graph, whose
MVMs run on the bit-serial CUDA kernel on the card) because every
slice is a verbatim op-copy sub-graph and the wire carries the exact
int8 blob codegen spilled (``force_boundary`` guarantees the spill).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..core.arch import ChipConfig
from ..core.codegen import GMEM_BASE, QuantParams, _compile_model
from ..core.graph import CondensedGraph
from ..core.simulator import SimReport, Simulator
from ..flow.backends import Backend, resolve_backend
from ..flow.options import CompileOptions
from ..flow.passes import PassRecord
from ..flow.pipeline import Artifact
from .config import SystemConfig
from .evaluate import SystemReport, evaluate_plan
from .partition import SystemPlan

__all__ = ["SystemArtifact", "FuncRunResult"]


def _host(a: Any) -> np.ndarray:
    """A numpy array, or a tensor on any device, as a host array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclass
class FuncRunResult:
    """One functional multi-chip run: harvested boundary blobs.

    ``outputs[gid]`` is the int8 ``(batch, nbytes)`` gmem blob of a
    harvested global group (every cut-transfer producer plus the
    final group); compare ``final`` against the single-chip oracle.
    """

    outputs: Dict[int, np.ndarray]
    final_gid: int
    reports: List[SimReport] = field(default_factory=list)

    @property
    def final(self) -> np.ndarray:
        return self.outputs[self.final_gid]


@dataclass
class SystemArtifact:
    """A compiled multi-chip plan (drop-in for :class:`Artifact`)."""

    workload: Any
    chip: ChipConfig                 # the per-mesh-slot chip (identical)
    options: CompileOptions          # carries .system (the mesh)
    cg: CondensedGraph               # full, unsplit condensed graph
    plan: SystemPlan
    chips: List[Artifact]            # index = logical chip slot
    trace: List[PassRecord] = field(default_factory=list)

    # -- derived --------------------------------------------------------------

    @property
    def system(self) -> SystemConfig:
        return self.plan.system

    @property
    def n_chips(self) -> int:
        return self.plan.n_chips

    @property
    def mode(self) -> str:
        return self.plan.mode

    # -- evaluation -----------------------------------------------------------

    def evaluate(self, backend: Union[str, Backend, None] = None,
                 **kw: Any) -> SystemReport:
        """Evaluate every chip slice and stitch over the links.

        Pipeline mode supports the analytic, trace and perf-simulator
        backends; tensor mode the analytic and trace backends (shards
        are group-level scaled condensed graphs — there is no per-shard
        ISA stream to step).  Functional execution needs the
        cross-chip data plane: use :meth:`run_func`.  Keyword
        arguments (``engine=``, ``device=``) pass through to every
        chip's :meth:`Artifact.evaluate`, so a simulate evaluation
        decodes each slice on the same device, one after another.
        """
        b = resolve_backend(backend, self.options.fidelity)
        if b.name == "func":
            raise ValueError(
                "func fidelity on a multi-chip plan needs the "
                "cross-chip data plane; call SystemArtifact.run_func")
        if self.mode == "tensor" and getattr(b, "requires_model", False):
            raise ValueError(
                f"tensor-parallel plans evaluate at analytic/trace "
                f"fidelity only (backend {b.name!r} needs ISA "
                f"streams); use parallel='pipeline' for simulation")
        reports = [a.evaluate(b, **kw) for a in self.chips]
        return evaluate_plan(self.plan, self.chip, reports,
                             batch=self.options.resolved_batch(),
                             calibration=self.options.calibration,
                             backend_name=b.name)

    # -- functional execution -------------------------------------------------

    def run_func(self, weights: Mapping[int, np.ndarray],
                 biases: Optional[Mapping[int, np.ndarray]],
                 inputs: Any,
                 quant: Optional[Mapping[int, QuantParams]] = None
                 ) -> FuncRunResult:
        """Run the plan on the functional ISS, chip by chip.

        ``weights`` / ``biases`` / ``quant`` are keyed by **global**
        group id exactly as for the single-chip harness
        (``ref.make_weights`` / ``ref.auto_quant`` on the full graph);
        ``inputs`` is the full graph's input batch — one
        ``(batch, ...)`` array for single-input graphs, or a mapping
        ``{input_op_idx: (batch, ...)}`` for multi-input graphs.  The
        arrays may be numpy or tensors on any device (the ISS runs on
        the host, so tensors are copied there once).
        """
        if self.mode != "pipeline":
            raise ValueError("run_func supports pipeline-parallel "
                             "plans only (tensor shards have no "
                             "per-chip ISA streams)")
        src = self.cg.source
        if src is None:
            raise ValueError("run_func needs a source graph")
        input_ops = [op.idx for op in src.ops if op.kind == "input"]
        weights = {g: _host(w) for g, w in weights.items()}
        biases = {g: _host(b) for g, b in (biases or {}).items()}
        if isinstance(inputs, Mapping):
            inp = {int(k): _host(v) for k, v in inputs.items()}
        else:
            if len(input_ops) != 1:
                raise ValueError(
                    f"'{self.cg.name}' has {len(input_ops)} graph "
                    f"inputs; pass a {{input_op_idx: array}} mapping")
            inp = {input_ops[0]: _host(inputs)}
        batch = next(iter(inp.values())).shape[0]

        needed = {t.gid for t in self.plan.transfers}
        final_gid = len(self.cg) - 1
        needed.add(final_gid)

        quant = quant or {}
        values: Dict[int, List[np.ndarray]] = {}
        reports: List[SimReport] = []
        for sl, art in zip(self.plan.slices, self.chips):
            local_of = {gid: k for k, gid in enumerate(sl.gids)}
            w_l = {local_of[g]: weights[g] for g in sl.gids
                   if g in weights}
            b_l = {local_of[g]: biases[g] for g in sl.gids
                   if g in biases}
            q_l = {local_of[g]: quant[g] for g in sl.gids
                   if g in quant}
            force = {local_of[g] for g in needed if g in local_of}
            model = _compile_model(
                art.partition, batch=batch, quant=q_l or None,
                strict_lmem=art.options.strict_lmem,
                force_boundary=force)

            srcs = sl.input_srcs or tuple(
                ("input", i) for i in input_ops)
            rows: List[np.ndarray] = []
            for s in range(batch):
                parts = [
                    np.ascontiguousarray(
                        inp[ref][s], dtype=np.int8).reshape(-1)
                    if kind == "input" else values[ref][s]
                    for kind, ref in srcs]
                rows.append(np.concatenate(parts) if parts
                            else np.zeros(0, dtype=np.int8))
            img = model.build_gmem_image(w_l, b_l, np.stack(rows))

            sim = Simulator(self.chip, model.isa, mode="func")
            rep = sim.run_model(model, gmem_image=img)
            reports.append(rep)
            for g in needed:
                if g not in local_of:
                    continue
                vals = []
                for s in range(batch):
                    addr, nb = model.output_addr(local_of[g], s)
                    off = addr - GMEM_BASE
                    vals.append(rep.gmem[off:off + nb].copy())
                values[g] = vals
        outputs = {g: np.stack(v) for g, v in values.items()}
        return FuncRunResult(outputs=outputs, final_gid=final_gid,
                             reports=reports)

    # -- conveniences ---------------------------------------------------------

    def replace_options(self, **kw: Any) -> "SystemArtifact":
        """This plan under tweaked *evaluation* options (fidelity,
        calibration, batch, ...).  Anything that would change the plan
        or the per-chip partitions — ``strategy``, ``params``,
        ``workload_kw``, ``system`` — needs a fresh ``flow.compile``.

        Note: ``batch`` here rescales stitching and per-chip
        evaluation, but the system plan's capacity check was made at
        compile-time batch.
        """
        import dataclasses as _dc
        stale = {"strategy", "params", "workload_kw", "system"} & set(kw)
        if stale:
            raise ValueError(
                f"{sorted(stale)} change the system plan; recompile "
                f"via flow.compile(...) instead of replace_options")
        return _dc.replace(
            self, options=self.options.replace(**kw),
            chips=[a.replace_options(**kw) for a in self.chips],
            trace=list(self.trace))

    def pass_record(self, name: str) -> Optional[PassRecord]:
        for rec in reversed(self.trace):
            if rec.name == name or (
                    name == "system"
                    and rec.name.startswith("system:")):
                return rec
        return None

    def describe(self) -> str:
        head = (f"system artifact: '{self.cg.name}' on "
                f"{self.system.chips_x}x{self.system.chips_y} x "
                f"'{self.chip.name}' — {self.options.describe()}")
        lines = [head] + [r.describe() for r in self.trace]
        lines.append(self.plan.describe())
        return "\n".join(lines)
