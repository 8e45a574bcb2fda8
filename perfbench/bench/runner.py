"""One run of one cell: the driver, the end-to-end metrics, the per-layer
readers, the check against the limits, and the result line."""

from __future__ import annotations

import json
import math
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from .. import reference
from . import drivers, spec
from .spec import Cell

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name (before the first dot),
    compared whole, is one of :data:`FORBIDDEN`."""
    mods = sys.modules if modules is None else modules
    return sorted(n for n in mods if n.split(".")[0] in FORBIDDEN)


@dataclass
class RunView:
    """What a per-layer reader gets: the cell, its model sizes, the
    traffic kind, what the run measured and the reduced trace."""

    cell: Cell
    model: Dict[str, Any]
    kind: str
    outcome: drivers.Outcome
    ref: Any

    @property
    def reduced(self):
        return self.outcome.reduced


def end_to_end(cell: Cell, out: drivers.Outcome) -> Dict[str, float]:
    """Every end-to-end metric this run's kind measures."""
    vals = {"setup_s": out.setup_s}
    rate = out.tokens / out.window_s if out.window_s > 0 else 0.0
    if cell.traffic["kind"] == "train":
        vals["train_tokens_per_s"] = rate
    else:
        vals["prefill_tokens_per_s"] = rate
        if out.latencies_s:
            vals["prefill_ms_p95"] = 1e3 * float(
                np.percentile(out.latencies_s, 95))
    return vals


def checks(cell: Cell, readings: Dict[str, float]) -> Dict[str, Dict]:
    """Each number the cell's limits name, beside its limit (one the run
    did not read counts as infinite, so it fails)."""
    return {name: {"value": readings.get(name, math.inf),
                   "limit": lim["limit"]}
            for name, lim in cell.limits.items()}


def passed(c: Dict[str, Dict]) -> bool:
    return bool(c) and all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                           for v in c.values())


def run(cell: Cell, seed: int, seconds: float, tracing: bool, device,
        t0: Optional[float] = None, fault: Optional[str] = None,
        control: bool = False, detail: bool = False) -> Dict[str, Any]:
    """The result of one run (the dict printed as the last line);
    ``detail`` adds each checked request's own readings to its notes."""
    import torch
    t0 = time.perf_counter() if t0 is None else t0
    kind = cell.traffic["kind"]
    out = drivers.DRIVERS[kind](cell, seed, seconds, tracing, device, t0,
                                fault=fault, control=control)
    e2e = end_to_end(cell, out)
    metrics: Dict[str, Dict[str, Any]] = {}
    if tracing:
        view = RunView(cell, cell.config["model"], kind, out,
                       reference.module(cell.config["reference"]))
        for m in cell.per_layer:
            v = spec.reader(m["name"]).read(view)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    c = checks(cell, out.readings)
    dev = torch.device(device)
    device_info: Dict[str, Any] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": cell.chips,
        "memory_peak_bytes": out.memory_peak,
    }
    result: Dict[str, Any] = {
        "correct": passed(c) and out.failed == 0 and out.attempted > 0,
        "attempted": out.attempted, "failed": out.failed,
        "metrics": metrics, "device": device_info,
    }
    if tracing and out.reduced is not None:
        device_info["busy_s"] = out.reduced.busy_s
        device_info["window_s"] = out.reduced.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in out.reduced.device_ops],
            "idle_gaps": [[n, s] for n, s in out.reduced.idle_gaps]}
    result["notes"] = {"seed": seed, "window_s": out.window_s,
                       "readings": out.readings,
                       "calls": len(out.calls), **out.notes,
                       **({"end_to_end": e2e} if tracing else {}),
                       **({"device_events": out.reduced.device_events}
                          if out.reduced is not None else {}),
                       **({"per_request": out.per_request} if detail else {})}
    result["checks"] = c
    return result


def check_lines(result: Dict[str, Any]) -> List[str]:
    """The compared numbers beside their limits, one a line."""
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in result["checks"].items()]


def dumps(result: Dict[str, Any]) -> str:
    return json.dumps(result, separators=(",", ":"))
