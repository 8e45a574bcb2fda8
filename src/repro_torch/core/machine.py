"""One machine-timing/energy model shared by every fidelity.

Host code: a copy of :mod:`repro.core.machine` (the JAX package), kept
identical so the port's compile results equal the reference's; the
port imports nothing of ``repro``.

Historically the analytic cost model (:mod:`repro.core.mapping`) and the
cycle-accurate simulator (:mod:`repro.core.simulator`) each read raw
``ChipConfig`` fields and re-derived latencies — bit-serial MVM beats,
NoC link occupancy, global-memory stream rates, scalar/vector issue
latencies — independently.  Any constant that drifted between the two
silently invalidated the workflow's central premise: that decisions
made against the cheap model hold on the expensive one.

:class:`MachineModel` is now the *only* place a timing, bandwidth or
energy rule is written down.  It is derived from a ``ChipConfig`` (the
structural description stays in :mod:`repro.core.arch`) and consumed by

* the analytic cost model (``core.mapping`` — stage intervals, load
  cycles, energy-event pricing),
* the cycle-accurate simulator (``core.simulator`` — per-instruction
  unit latencies, wormhole link occupancy, gmem port streams),
* the ``trace`` fidelity (``core.trace`` — StagePlan replay at
  unit/transfer granularity),
* benchmarks and reports (roofline anchors).

A :class:`Calibration` attached to the model carries per-unit
multiplicative correction factors fitted from a handful of simulator
runs (:func:`repro.flow.calibrate`): the raw model stays analytic and
chip-derived, while calibrated evaluations tighten the analytic and
trace fidelities toward simulator truth — which is what makes
cheap-fidelity *rankings* trustworthy in design-space exploration.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import lru_cache
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from .arch import ChipConfig
from .energy import DEFAULT_TABLE, EnergyTable, energy_breakdown

__all__ = [
    "Calibration", "IDENTITY_CALIBRATION", "MachineModel", "machine_for",
    "VECTOR_SPECIAL_FNS", "VECTOR_MUL_FNS",
    "InterChipLink", "LINK_TIERS", "link_tier",
]


# Vector-unit latency classes, shared by the simulator's dispatch, the
# trace replay and the analytic vector estimate.  ``special`` ops run
# through the LUT pipeline (one issue per lanes-wide beat); ``mul`` ops
# pay the multiplier latency; everything else is ALU-class.
VECTOR_SPECIAL_FNS = frozenset(
    {"sigmoid", "silu", "gelu", "tanh", "exp", "recip", "rsqrt",
     "softmax", "layernorm"})
VECTOR_MUL_FNS = frozenset({"mul", "mac", "muli", "quant", "dequant"})


@dataclass(frozen=True)
class Calibration:
    """Per-unit multiplicative correction factors (1.0 = uncalibrated).

    ``cim`` / ``vector`` / ``noc`` / ``gmem`` / ``load`` scale the
    matching cycle components of the analytic and trace fidelities;
    ``makespan`` is the residual serialization factor applied to a
    stage's total latency after the per-unit terms — it absorbs
    whole-sample handoff chains and in-order-issue stalls that no
    per-unit busy model can see.
    """

    cim: float = 1.0
    vector: float = 1.0
    noc: float = 1.0
    gmem: float = 1.0
    load: float = 1.0
    makespan: float = 1.0

    def __post_init__(self) -> None:
        for f in ("cim", "vector", "noc", "gmem", "load", "makespan"):
            v = getattr(self, f)
            if not (v > 0 and math.isfinite(v)):
                raise ValueError(f"calibration factor {f} must be a "
                                 f"positive finite number, got {v!r}")

    @property
    def is_identity(self) -> bool:
        return self == IDENTITY_CALIBRATION

    def scaled(self, **kw: float) -> "Calibration":
        return replace(self, **kw)

    def to_dict(self) -> Dict[str, float]:
        return {"cim": self.cim, "vector": self.vector, "noc": self.noc,
                "gmem": self.gmem, "load": self.load,
                "makespan": self.makespan}

    @classmethod
    def from_dict(cls, d: Mapping[str, float]) -> "Calibration":
        return cls(**{k: float(v) for k, v in d.items()})

    @classmethod
    def combine(cls, calibs: "list[Calibration]") -> "Calibration":
        """Geometric mean of several fits (e.g. one per candidate chip
        of a sweep) — factors are ratios, so the geomean is the
        bias-free aggregate."""
        if not calibs:
            return cls()
        out = {}
        for f in ("cim", "vector", "noc", "gmem", "load", "makespan"):
            vals = [getattr(c, f) for c in calibs]
            out[f] = math.exp(sum(math.log(v) for v in vals)
                              / len(vals))
        return cls(**out)

    def describe(self) -> str:
        return ("calibration(" +
                ", ".join(f"{k}={v:.3g}"
                          for k, v in self.to_dict().items()) + ")")


IDENTITY_CALIBRATION = Calibration()


# ---------------------------------------------------------------------------
# Inter-chip interconnect (mesh-of-chips tier above the NoC)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InterChipLink:
    """One inter-chip link technology tier.

    Chips of a :class:`repro.system.SystemConfig` mesh talk over these
    links; a transfer drains through the sending chip's reserved global
    memory ports, so the effective bandwidth is the min of the serdes
    payload rate and the boundary-port stream rate — exactly the
    "gmem-port-contended" pricing the system partitioner assumes.
    """

    name: str = "pcb"
    bytes_per_cycle: float = 16.0     # serdes payload per core clock
    hop_cycles: int = 500             # per-chip-hop latency (serdes+fifo)
    sync_cycles: int = 200            # fixed handshake per transfer
    energy_pj_per_byte: float = 10.0  # link traversal energy

    def __post_init__(self) -> None:
        if not (self.bytes_per_cycle > 0
                and math.isfinite(self.bytes_per_cycle)):
            raise ValueError(f"link bytes_per_cycle must be positive, "
                             f"got {self.bytes_per_cycle!r}")
        if self.hop_cycles < 0 or self.sync_cycles < 0:
            raise ValueError("link latencies must be non-negative")

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name,
                "bytes_per_cycle": self.bytes_per_cycle,
                "hop_cycles": self.hop_cycles,
                "sync_cycles": self.sync_cycles,
                "energy_pj_per_byte": self.energy_pj_per_byte}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "InterChipLink":
        return cls(name=str(d["name"]),
                   bytes_per_cycle=float(d["bytes_per_cycle"]),
                   hop_cycles=int(d["hop_cycles"]),
                   sync_cycles=int(d["sync_cycles"]),
                   energy_pj_per_byte=float(d["energy_pj_per_byte"]))


# Named technology tiers, best to worst: silicon interposer (chiplets on
# one substrate), PCB traces (chips on one board), cabled boards (a pod).
# These are THE inter-chip timing/energy constants — nothing outside
# this module may invent its own.
LINK_TIERS: Dict[str, InterChipLink] = {
    "interposer": InterChipLink("interposer", bytes_per_cycle=64.0,
                                hop_cycles=100, sync_cycles=50,
                                energy_pj_per_byte=1.0),
    "pcb": InterChipLink("pcb", bytes_per_cycle=16.0,
                         hop_cycles=500, sync_cycles=200,
                         energy_pj_per_byte=10.0),
    "cable": InterChipLink("cable", bytes_per_cycle=4.0,
                           hop_cycles=2000, sync_cycles=500,
                           energy_pj_per_byte=30.0),
}


def link_tier(name: str) -> InterChipLink:
    """Resolve a named inter-chip link tier."""
    try:
        return LINK_TIERS[name]
    except KeyError:
        raise KeyError(f"unknown inter-chip link tier {name!r} "
                       f"(have: {', '.join(sorted(LINK_TIERS))})") from None


@dataclass(frozen=True)
class MachineModel:
    """Every timing/bandwidth/energy rule of one chip, in one object.

    Frozen and hashable — safe to share across threads and cheap enough
    to construct per candidate chip in an arch sweep (all accessors are
    O(1) arithmetic over ``ChipConfig`` fields).  Use
    :func:`machine_for` to get the memoized instance.
    """

    chip: ChipConfig
    calib: Calibration = IDENTITY_CALIBRATION
    energy_table: EnergyTable = DEFAULT_TABLE

    # ------------------------------------------------------------------
    # CIM unit
    # ------------------------------------------------------------------

    @property
    def mvm_interval_beats(self) -> int:
        """Pipelined pass interval: one beat per activation bit."""
        return self.chip.core.cim.macro.act_bits

    @property
    def mvm_fill_beats(self) -> int:
        """Adder-tree fill latency paid once per MVM burst.

        Protection hardware adds pipeline stages to the output path:
        one ECC decode stage and one TMR voter stage (zero when off).
        """
        p = self.protection
        return (self.chip.core.cim.macro.adder_tree_depth
                + int(p.ecc) + int(p.tmr))

    @property
    def mvm_pass_beats(self) -> int:
        """One full bit-serial pass: interval + tree fill."""
        return self.mvm_interval_beats + self.mvm_fill_beats

    def mvm_cycles(self, rep: int) -> float:
        """A CIM_MVM burst of ``rep`` input vectors."""
        return rep * self.mvm_interval_beats + self.mvm_fill_beats

    def weight_load_cycles(self, rows: int) -> float:
        """CIM_LOAD of ``rows`` macro rows from local memory."""
        return rows / self.effective_weight_load_rows_per_cycle

    def group_load_cycles(self) -> float:
        """(Re)load of one full macro group."""
        return self.weight_load_cycles(self.chip.core.cim.macro.rows)

    @property
    def macros_per_group(self) -> int:
        return self.chip.core.cim.macros_per_group

    # ------------------------------------------------------------------
    # Fault-mitigation hardware (ECC / row sparing / TMR) overheads
    # ------------------------------------------------------------------

    @property
    def protection(self):
        """The chip's :class:`~repro.core.arch.ProtectionConfig`."""
        return self.chip.core.cim.protection

    @property
    def weight_storage_overhead(self) -> float:
        """Stored-bit inflation of the weight arrays: SECDED check
        bits (+12.5%) and spare rows (+``spare/rows``).  1.0 when
        protection is off."""
        p = self.protection
        macro = self.chip.core.cim.macro
        f = 1.0
        if p.ecc:
            f *= 1.125
        if p.spare_rows:
            f *= 1.0 + p.spare_rows / macro.rows
        return f

    @property
    def cim_compute_redundancy(self) -> float:
        """Physical MVM passes per logical pass (3.0 under TMR)."""
        return 3.0 if self.protection.tmr else 1.0

    @property
    def weight_load_factor(self) -> float:
        """CIM_LOAD time/bytes inflation: every stored copy and check
        bit must be written (storage overhead x TMR redundancy)."""
        return self.weight_storage_overhead * self.cim_compute_redundancy

    @property
    def protection_area_factor(self) -> float:
        """First-order CIM-unit area inflation from protection
        hardware — the area axis of a protection DSE sweep."""
        return self.weight_storage_overhead * self.cim_compute_redundancy

    @property
    def effective_weight_load_rows_per_cycle(self) -> float:
        """Row-write throughput after protection overhead.  Written as
        one shared divisor so the scalar, array-batched and JAX-fleet
        paths stay bit-identical."""
        return (self.chip.core.cim.weight_load_rows_per_cycle
                / self.weight_load_factor)

    # ------------------------------------------------------------------
    # Vector unit
    # ------------------------------------------------------------------

    @property
    def vector_lanes(self) -> int:
        return self.chip.core.vector.lanes

    def vector_cycles(self, fn: str, n: int) -> float:
        """One vector instruction over ``n`` elements (fn = op name
        without the ``V_`` prefix, lower-case)."""
        v = self.chip.core.vector
        beats = math.ceil(max(n, 1) / v.lanes)
        if fn in VECTOR_SPECIAL_FNS:
            return beats * v.special_latency
        if fn in VECTOR_MUL_FNS:
            return beats + v.mul_latency
        return beats + v.alu_latency

    def vector_class(self, fn: str) -> int:
        """Latency class id for :meth:`vector_cycles_array`:
        0 = ALU, 1 = multiplier, 2 = LUT/special."""
        if fn in VECTOR_SPECIAL_FNS:
            return 2
        if fn in VECTOR_MUL_FNS:
            return 1
        return 0

    def vector_cycles_array(self, vclass: "Any", n: "Any") -> "Any":
        """Batched :meth:`vector_cycles`: ``vclass`` int array (see
        :meth:`vector_class`) and ``n`` element-count array -> float64
        latencies.  One numpy pass for the pre-decoded simulator; the
        arithmetic is kept element-identical to the scalar accessor."""
        v = self.chip.core.vector
        n = np.maximum(np.asarray(n, dtype=np.int64), 1)
        beats = -(-n // v.lanes)          # ceil-div, exact in int64
        lat = beats + np.where(vclass == 1, v.mul_latency, v.alu_latency)
        return np.where(vclass == 2, beats * v.special_latency,
                        lat).astype(np.float64)

    def mvm_cycles_array(self, rep: "Any") -> "Any":
        """Batched :meth:`mvm_cycles` over a ``rep`` array."""
        rep = np.asarray(rep, dtype=np.int64)
        return (rep * self.mvm_interval_beats
                + self.mvm_fill_beats).astype(np.float64)

    def weight_load_cycles_array(self, rows: "Any") -> "Any":
        """Batched :meth:`weight_load_cycles` over a ``rows`` array."""
        rows = np.asarray(rows, dtype=np.float64)
        return rows / self.effective_weight_load_rows_per_cycle

    def send_issue_cycles_array(self, nbytes: "Any") -> "Any":
        """Batched :meth:`send_issue_cycles` over a byte-count array."""
        nbytes = np.asarray(nbytes, dtype=np.float64)
        return np.maximum(1.0, nbytes / self.link_bytes_per_cycle)

    # ------------------------------------------------------------------
    # Scalar unit
    # ------------------------------------------------------------------

    @property
    def scalar_alu_cycles(self) -> int:
        return self.chip.core.scalar.alu_latency

    @property
    def scalar_mul_cycles(self) -> int:
        return self.chip.core.scalar.mul_latency

    @property
    def scalar_ldst_cycles(self) -> int:
        return self.chip.core.scalar.ldst_latency

    def branch_cycles(self, taken: bool) -> int:
        s = self.chip.core.scalar
        return 1 + (s.branch_penalty if taken else 0)

    # ------------------------------------------------------------------
    # NoC
    # ------------------------------------------------------------------

    @property
    def link_bytes_per_cycle(self) -> int:
        return self.chip.noc.link_bytes_per_cycle

    @property
    def router_hop_cycles(self) -> int:
        return self.chip.noc.router_latency

    @property
    def inject_cycles(self) -> int:
        return self.chip.noc.inject_latency

    def link_occupancy_cycles(self, nbytes: int) -> float:
        """Cycles a wormhole flit stream occupies one directed link."""
        noc = self.chip.noc
        flits = max(1, math.ceil(nbytes / noc.flit_bytes))
        return flits / noc.flits_per_cycle

    def send_issue_cycles(self, nbytes: int) -> float:
        """Sender-side NoC-unit occupancy to inject a message."""
        return max(1.0, nbytes / self.link_bytes_per_cycle)

    @property
    def avg_hops(self) -> float:
        """Expected Manhattan distance between two uniform-random mesh
        cores: (rows + cols) / 3."""
        return (self.chip.mesh_rows + self.chip.mesh_cols) / 3.0

    def hops(self, src: int, dst: int) -> int:
        return self.chip.hops(src, dst)

    def route(self, src: int, dst: int) -> List[Tuple[int, int]]:
        return self.chip.route(src, dst)

    def noc_transfer_cycles(self, nbytes: int,
                            hops: Optional[float] = None) -> float:
        """Uncontended end-to-end transfer estimate."""
        h = self.avg_hops if hops is None else hops
        return (self.inject_cycles + h * self.router_hop_cycles
                + self.link_occupancy_cycles(nbytes))

    # ------------------------------------------------------------------
    # Global memory
    # ------------------------------------------------------------------

    @property
    def gmem_ports(self) -> int:
        return self.chip.global_mem_ports

    @property
    def gmem_port_bytes_per_cycle(self) -> int:
        return self.chip.global_mem_bytes_per_cycle

    @property
    def gmem_total_bytes_per_cycle(self) -> int:
        return self.gmem_ports * self.gmem_port_bytes_per_cycle

    def gmem_stream_cycles(self, nbytes: float,
                           ports: Optional[int] = None) -> float:
        """Stream ``nbytes`` over ``ports`` concurrent gmem ports."""
        n = self.gmem_ports if ports is None else max(1, min(
            ports, self.gmem_ports))
        return nbytes / (n * self.gmem_port_bytes_per_cycle)

    # ------------------------------------------------------------------
    # Inter-chip links (system tier above the NoC)
    # ------------------------------------------------------------------

    def interchip_bandwidth(self, link: InterChipLink,
                            ports: int = 1) -> float:
        """Effective B/cyc of one link transfer: the serdes payload
        rate, throttled by the sending chip's reserved boundary gmem
        ports (activations drain gmem -> serdes)."""
        n = max(1, min(int(ports), self.gmem_ports))
        return min(link.bytes_per_cycle,
                   float(n * self.gmem_port_bytes_per_cycle))

    def interchip_transfer_cycles(self, nbytes: float,
                                  link: InterChipLink,
                                  hops: int = 1,
                                  ports: int = 1) -> float:
        """End-to-end inter-chip transfer: handshake + per-chip-hop
        latency + port-contended streaming.  Scaled by the ``noc``
        calibration factor (the communication hierarchy shares one
        correction)."""
        if nbytes <= 0:
            return 0.0
        cyc = (link.sync_cycles + max(1, int(hops)) * link.hop_cycles
               + nbytes / self.interchip_bandwidth(link, ports))
        return cyc * self.calib.noc

    def interchip_collective_cycles(self, nbytes: float,
                                    link: InterChipLink,
                                    n_chips: int,
                                    kind: str = "allgather",
                                    ports: int = 1) -> float:
        """Ring collective over ``n_chips`` on ``nbytes`` of payload
        (the full un-sharded tensor).  ``allgather``/``reduce`` both
        move ``(C-1)/C`` of the payload through each chip's link in
        ``C-1`` latency-bearing steps; ``allreduce`` is reduce-scatter
        + all-gather (twice the traffic)."""
        c = int(n_chips)
        if c <= 1 or nbytes <= 0:
            return 0.0
        if kind not in ("allgather", "reduce", "allreduce"):
            raise ValueError(f"unknown collective kind {kind!r}")
        steps = (c - 1) * (2 if kind == "allreduce" else 1)
        bw = self.interchip_bandwidth(link, ports)
        cyc = (steps * (link.sync_cycles + link.hop_cycles)
               + steps * (nbytes / c) / bw)
        return cyc * self.calib.noc

    def interchip_energy_nj(self, nbytes: float,
                            link: InterChipLink) -> float:
        """Link-traversal energy of ``nbytes`` on one tier, in nJ."""
        return nbytes * link.energy_pj_per_byte * 1e-3

    # ------------------------------------------------------------------
    # Batched-decode constants (JAX engine / fleet evaluation)
    # ------------------------------------------------------------------

    def timing_constants(self) -> Dict[str, float]:
        """The scalar timing constants of the batchable decode subset.

        These are the *only* machine numbers the static stage-decode
        latency pass reads (:mod:`repro.core.jaxsim`); stacking them
        across machines yields the vmappable table pytree one XLA
        program evaluates for a whole fleet of chip variants ("same
        program, different chip constants").  Integer-valued entries
        stay exact ints so the batched arithmetic is bit-identical to
        the per-machine accessors above.
        """
        v = self.chip.core.vector
        return {
            "vector_lanes": int(v.lanes),
            "vector_alu_latency": int(v.alu_latency),
            "vector_mul_latency": int(v.mul_latency),
            "vector_special_latency": int(v.special_latency),
            "mvm_interval_beats": int(self.mvm_interval_beats),
            "mvm_fill_beats": int(self.mvm_fill_beats),
            "scalar_alu_cycles": float(self.scalar_alu_cycles),
            "scalar_ldst_cycles": float(self.scalar_ldst_cycles),
            "weight_load_rows_per_cycle": float(
                self.effective_weight_load_rows_per_cycle),
            "link_bytes_per_cycle": float(self.link_bytes_per_cycle),
        }

    # ------------------------------------------------------------------
    # Energy event pricing
    # ------------------------------------------------------------------

    def price_events(self, events: Mapping[str, float]) -> Dict[str, float]:
        """Event ledger -> {category: nJ} breakdown (+ ``total``).

        Protection hardware prices in here: TMR triples the physical
        macro passes behind each logical one, and every stored copy /
        check bit inflates the weight-load traffic.  With protection
        off the ledger passes through untouched.
        """
        if self.protection.enabled:
            events = dict(events)
            if "cim_macro_passes" in events:
                events["cim_macro_passes"] *= self.cim_compute_redundancy
            if "cim_weight_load_bytes" in events:
                events["cim_weight_load_bytes"] *= self.weight_load_factor
        return energy_breakdown(events, self.energy_table)

    # ------------------------------------------------------------------
    # Derived peaks (roofline anchors)
    # ------------------------------------------------------------------

    def peak_macs_per_cycle_per_core(self) -> float:
        return self.chip.peak_macs_per_cycle_per_core()

    # ------------------------------------------------------------------
    # Calibration plumbing
    # ------------------------------------------------------------------

    def with_calibration(self, calib: Optional[Calibration]
                         ) -> "MachineModel":
        return machine_for(self.chip, calib)

    def describe(self) -> str:
        lines = [
            f"machine '{self.chip.name}': mvm {self.mvm_interval_beats}"
            f"+{self.mvm_fill_beats} beats, MG load "
            f"{self.group_load_cycles():.0f} cyc, vector "
            f"{self.vector_lanes} lanes, link "
            f"{self.link_bytes_per_cycle} B/cyc "
            f"({self.router_hop_cycles} cyc/hop), gmem "
            f"{self.gmem_ports}x{self.gmem_port_bytes_per_cycle} B/cyc",
        ]
        if not self.calib.is_identity:
            lines.append(f"  {self.calib.describe()}")
        return "\n".join(lines)


@lru_cache(maxsize=512)
def _machine_for(chip: ChipConfig, calib: Calibration) -> MachineModel:
    return MachineModel(chip=chip, calib=calib)


def machine_for(chip: ChipConfig,
                calib: Optional[Calibration] = None) -> MachineModel:
    """The memoized machine model of a chip (+ optional calibration).

    ``ChipConfig`` and ``Calibration`` are frozen, so identical
    descriptions share one instance — arch sweeps construct thousands
    of models for free.
    """
    return _machine_for(chip, calib or IDENTITY_CALIBRATION)
