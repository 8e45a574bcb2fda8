"""System-level partition passes on the :mod:`repro_torch.flow` registry.

``system:pipeline`` / ``system:tensor`` sit between the shared
``condense`` pass and the per-chip single-chip pipelines: they turn one
condensed graph plus a :class:`~repro_torch.system.config.SystemConfig` into
a :class:`~repro_torch.system.partition.SystemPlan`.  Like every other pass
the output is memoized by ``(workload, chip, options-prefix)`` through
the flow pass cache (including the ``REPRO_TORCH_FLOW_CACHE`` disk tier), so
repeated multi-chip sweeps re-plan nothing.
"""

from __future__ import annotations

from typing import Any, Dict

from ..flow.passes import Pass, PipelineContext, register_pass
from .config import PARALLEL_MODES
from .partition import SystemPlan, shard_tensor, split_pipeline

__all__ = ["SystemPartitionPass", "system_pass_name"]

_SPLITTERS = {"pipeline": split_pipeline, "tensor": shard_tensor}


def system_pass_name(mode: str) -> str:
    return f"system:{mode}"


class SystemPartitionPass(Pass):
    """CondensedGraph + SystemConfig -> SystemPlan (one mesh layout)."""

    depends = ("system",)

    def __init__(self, mode: str) -> None:
        if mode not in PARALLEL_MODES:
            raise ValueError(f"mode must be one of {PARALLEL_MODES}, "
                             f"got {mode!r}")
        self.mode = mode
        self.name = system_pass_name(mode)

    def run(self, ctx: PipelineContext) -> SystemPlan:
        return _SPLITTERS[self.mode](ctx.cg, ctx.chip,
                                     ctx.options.system)

    def apply(self, ctx: PipelineContext, out: SystemPlan) -> None:
        ctx.extras["system_plan"] = out

    def summarize(self, out: SystemPlan) -> str:
        extra = (f"{len(out.transfers)} transfers"
                 if out.mode == "pipeline"
                 else f"{len(out.collectives)} collectives")
        return (f"{out.n_chips} chips "
                f"({out.system.chips_x}x{out.system.chips_y} "
                f"'{out.system.link.name}'), {extra}")

    def dump(self, out: SystemPlan) -> Dict[str, Any]:
        return {
            "mode": out.mode,
            "system": out.system.to_dict(),
            "slices": [{
                "chip": s.chip_id, "gids": list(s.gids),
                "macs": s.macs, "weight_bytes": s.weight_bytes,
                "out_bytes": s.out_bytes,
            } for s in out.slices],
            "transfers": [{
                "gid": t.gid, "src": t.src_chip, "dst": t.dst_chip,
                "nbytes": t.nbytes, "hops": t.hops,
            } for t in out.transfers],
            "collectives": [{
                "gid": c.gid, "kind": c.kind, "nbytes": c.nbytes,
            } for c in out.collectives],
        }


for _m in PARALLEL_MODES:
    register_pass(SystemPartitionPass(_m))
