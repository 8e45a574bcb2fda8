"""Energy model (paper §III-D / §IV-A).

Host code: a copy of :mod:`repro.core.energy` (the JAX package), kept
identical so the port's compile results equal the reference's; the
port imports nothing of ``repro``.

The paper takes per-component energy from post-layout analysis of its
reference macro [11], memory compilers, and synthesized RTL.  We have none of
those, so this table is calibrated to *published* figures instead:

* CIM macro: [11] reports 27.38 TOPS/W signed-INT8.  One full bit-serial
  macro pass performs ``rows x n_out = 512 x 8 = 4096`` MACs = 8192 ops →
  ``8192 / 27.38e12 ≈ 0.30 nJ`` per pass.
* On-chip SRAM: ~1 pJ/B (local 512 KB) to ~8 pJ/B (16 MB global) — memory-
  compiler-typical values at 28 nm.
* NoC: ~1 pJ per byte-hop (router + link at 28 nm, Noxim-calibrated order).
* Static: per-core leakage + clock tree ≈ 50 mW at 1 GHz → 0.05 nJ/cycle.
  Static energy is why latency wins translate into energy wins (idle cores
  still burn power while a slow schedule drags on).

Absolute joules are therefore *estimates*; the reproduction targets the
paper's **relative** results (speedup ratios, energy-reduction percentages,
breakdown shapes), as recorded in DESIGN.md §2.

Event ledger keys (produced by both the analytic cost model and the
cycle-accurate simulator):

    cim_macro_passes, cim_weight_load_bytes, vector_elems,
    noc_byte_hops, gmem_bytes, lmem_bytes, static_core_cycles
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Mapping

__all__ = ["EnergyTable", "DEFAULT_TABLE", "energy_breakdown", "total_energy"]


@dataclass(frozen=True)
class EnergyTable:
    """nJ per event."""

    cim_macro_pass: float = 0.30        # one bit-serial pass of one macro
    cim_weight_load_byte: float = 0.0012  # SRAM array write
    vector_elem: float = 0.002          # 32-bit vector lane op
    noc_byte_hop: float = 0.0010        # router+link traversal
    gmem_byte: float = 0.008            # 16 MB global SRAM access
    lmem_byte: float = 0.0015           # 512 KB local SRAM access
    static_core_cycle: float = 0.05     # leakage + clock per core-cycle

    def scaled(self, **kw: float) -> "EnergyTable":
        return replace(self, **kw)


DEFAULT_TABLE = EnergyTable()

_EVENT_TO_FIELD = {
    "cim_macro_passes": ("compute", "cim_macro_pass"),
    "cim_weight_load_bytes": ("weight_load", "cim_weight_load_byte"),
    "vector_elems": ("compute", "vector_elem"),
    "noc_byte_hops": ("noc", "noc_byte_hop"),
    "gmem_bytes": ("gmem", "gmem_byte"),
    "lmem_bytes": ("lmem", "lmem_byte"),
    "static_core_cycles": ("static", "static_core_cycle"),
}


def energy_breakdown(events: Mapping[str, float],
                     table: EnergyTable = DEFAULT_TABLE) -> Dict[str, float]:
    """Ledger -> {category: nJ} breakdown (+ 'total')."""
    out: Dict[str, float] = {"compute": 0.0, "weight_load": 0.0, "noc": 0.0,
                             "gmem": 0.0, "lmem": 0.0, "static": 0.0}
    for ev, count in events.items():
        if ev not in _EVENT_TO_FIELD:
            raise KeyError(f"unknown energy event {ev!r}")
        cat, fld = _EVENT_TO_FIELD[ev]
        out[cat] += count * getattr(table, fld)
    out["total"] = sum(out.values())
    return out


def total_energy(events: Mapping[str, float],
                 table: EnergyTable = DEFAULT_TABLE) -> float:
    return energy_breakdown(events, table)["total"]
