"""Hierarchical hardware abstraction for digital CIM architectures.

Host code: a copy of :mod:`repro.core.arch` (the JAX package), kept
identical so the port's compile results equal the reference's; the
port imports nothing of ``repro``.

Implements the three-level abstraction of the CIMFlow ISA (paper §III-B):

* **Chip level** — multiple cores on a 2-D mesh NoC with synchronous
  inter-core communication and a global memory.
* **Core level** — instruction memory, a CIM compute unit (macro groups),
  a vector unit, a scalar unit, register files (G_Reg / S_Reg) and a
  segmented local memory in a unified address space.
* **Unit level** — CIM macro geometry (rows x bit-columns, element tiles)
  and per-unit pipeline parameters.

Default parameters follow Tab. I of the paper:

    Chip:  64 cores, NoC flit 8 B, global mem 16 MB
    Core:  CIM unit = 16 macro groups, MG = 8 macros, local mem 512 KB
    Unit:  macro = 512 x 64 (bit columns), element = 32 x 8

Semantics adopted for the macro (documented because the paper leaves the
micro-architecture to its reference design [11]):

* ``rows`` is the input (reduction, K) dimension of the in-memory MVM.
* ``cols`` counts *bit* columns; an INT-``weight_bits`` weight occupies
  ``weight_bits`` adjacent columns, so a macro stores
  ``cols // weight_bits`` output channels of ``rows`` weights each.
* macros inside a macro group (MG) extend the output-channel dimension
  (weights organized along output channels; the input vector is broadcast
  across macros of the group — paper §III-B "unit level").
* distinct MGs may be mapped to different (k-tile, n-tile) coordinates of a
  layer; partial sums across k-tiles are combined on the vector unit.
* activations are processed bit-serially: an ``act_bits``-bit activation
  takes ``act_bits`` compute beats, plus an adder-tree latency of
  ``log2(rows / element_rows)`` beats (element = 32x8 adder-tree segment).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "MacroConfig",
    "ProtectionConfig",
    "CimUnitConfig",
    "VectorUnitConfig",
    "ScalarUnitConfig",
    "LocalMemConfig",
    "RegFileConfig",
    "CoreConfig",
    "NocConfig",
    "ChipConfig",
    "default_chip",
    "chip_from_dict",
    "chip_from_json",
]


class ArchError(ValueError):
    """Raised when an architecture description is inconsistent."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ArchError(msg)


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


# ---------------------------------------------------------------------------
# Unit level
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MacroConfig:
    """Geometry and timing of one digital CIM macro."""

    rows: int = 512            # input (K) dimension
    cols: int = 64             # bit columns
    element_rows: int = 32     # adder-tree segment rows
    element_cols: int = 8      # adder-tree segment bit-columns
    weight_bits: int = 8       # bits per stored weight
    act_bits: int = 8          # bits per input activation (bit-serial)

    def __post_init__(self) -> None:
        _require(self.rows > 0 and self.cols > 0, "macro dims must be positive")
        _require(self.cols % self.weight_bits == 0,
                 f"cols ({self.cols}) must be a multiple of weight_bits "
                 f"({self.weight_bits})")
        _require(self.rows % self.element_rows == 0,
                 "rows must be a multiple of element_rows")
        _require(self.cols % self.element_cols == 0,
                 "cols must be a multiple of element_cols")
        _require(_is_pow2(self.rows // self.element_rows),
                 "rows/element_rows must be a power of two (adder tree)")

    @property
    def n_out(self) -> int:
        """Output channels held by one macro."""
        return self.cols // self.weight_bits

    @property
    def weight_bytes(self) -> int:
        """Weight storage of one macro in bytes."""
        return self.rows * self.cols // 8

    @property
    def adder_tree_depth(self) -> int:
        return int(math.log2(self.rows // self.element_rows))

    def mvm_beats(self) -> int:
        """Compute beats for one full-array bit-serial MVM pass.

        Bit-serial activations: one beat per activation bit; the adder tree
        and shift-accumulate are pipelined, so the tree depth appears once
        as fill latency.
        """
        return self.act_bits + self.adder_tree_depth


@dataclass(frozen=True)
class ProtectionConfig:
    """CIM-array fault-mitigation hardware.

    Three orthogonal mechanisms, each a classic CIM reliability knob:

    * ``ecc`` — SECDED across the weight storage (8 check bits per 64
      data bits): +12.5% stored weights and one extra decode stage in
      the MVM output path.
    * ``spare_rows`` — redundant macro rows with remap logic: storage
      and load time grow by ``spare_rows / macro.rows``.
    * ``tmr`` — triple modular redundancy on arrays + datapath: 3x
      storage, load time, compute energy and area, plus one voter
      stage of MVM latency.

    The cycle/energy/area overheads are priced centrally by
    :class:`repro.core.machine.MachineModel`; the *effectiveness*
    (residual fault rate) is modeled by
    :func:`repro.faults.residual_rate`.  All defaults off — a default
    chip is bit-identical to one predating this config.
    """

    ecc: bool = False
    spare_rows: int = 0
    tmr: bool = False

    def __post_init__(self) -> None:
        _require(self.spare_rows >= 0, "spare_rows must be >= 0")

    @property
    def enabled(self) -> bool:
        return self.ecc or self.spare_rows > 0 or self.tmr


@dataclass(frozen=True)
class CimUnitConfig:
    """Core-level CIM compute unit: a set of macro groups."""

    n_macro_groups: int = 16
    macros_per_group: int = 8
    macro: MacroConfig = field(default_factory=MacroConfig)
    # Cycles to load one macro row of weights from local memory
    # (row-parallel write ports are expensive; one row per cycle is typical).
    weight_load_rows_per_cycle: int = 1
    # Fault-mitigation hardware (defaults: all off = zero overhead).
    protection: ProtectionConfig = field(default_factory=ProtectionConfig)

    def __post_init__(self) -> None:
        _require(self.n_macro_groups > 0, "need at least one macro group")
        _require(self.macros_per_group > 0, "need at least one macro per MG")
        _require(self.protection.spare_rows < self.macro.rows,
                 "spare_rows must be smaller than macro rows")

    @property
    def group_n_out(self) -> int:
        """Output channels produced by one MG in one pass."""
        return self.macros_per_group * self.macro.n_out

    @property
    def group_k(self) -> int:
        """Input (reduction) capacity of one MG."""
        return self.macro.rows

    @property
    def group_weight_bytes(self) -> int:
        return self.macros_per_group * self.macro.weight_bytes

    @property
    def weight_capacity_bytes(self) -> int:
        """Total in-array weight storage of the unit."""
        return self.n_macro_groups * self.group_weight_bytes

    def macs_per_pass(self) -> int:
        """MACs performed by one MG in one bit-serial pass."""
        return self.group_k * self.group_n_out


@dataclass(frozen=True)
class VectorUnitConfig:
    """SIMD vector unit for activation/pooling/quantization ops."""

    lanes: int = 32            # elements per cycle
    width_bits: int = 32       # accumulator width
    # Latency classes in cycles (pipelined; these are issue latencies).
    alu_latency: int = 1
    mul_latency: int = 2
    special_latency: int = 4   # LUT-based activations (sigmoid/silu/gelu/exp)

    def __post_init__(self) -> None:
        _require(self.lanes > 0, "vector lanes must be positive")


@dataclass(frozen=True)
class ScalarUnitConfig:
    alu_latency: int = 1
    mul_latency: int = 3
    branch_penalty: int = 2
    ldst_latency: int = 2      # local-memory scalar load/store


@dataclass(frozen=True)
class LocalMemConfig:
    """Segmented core-local memory (activations in/out + spill)."""

    size_bytes: int = 512 * 1024
    n_segments: int = 4
    read_bytes_per_cycle: int = 64
    write_bytes_per_cycle: int = 64
    banks: int = 8

    def __post_init__(self) -> None:
        _require(self.size_bytes > 0, "local mem must be positive")
        _require(self.size_bytes % self.n_segments == 0,
                 "local mem must divide into equal segments")

    @property
    def segment_bytes(self) -> int:
        return self.size_bytes // self.n_segments


@dataclass(frozen=True)
class RegFileConfig:
    n_gregs: int = 32          # general-purpose (5-bit operand fields)
    n_sregs: int = 32          # special-purpose (CIM config, quant params...)

    def __post_init__(self) -> None:
        _require(self.n_gregs <= 32, "G_Reg addressable by 5-bit fields only")
        _require(self.n_sregs <= 64, "S_Reg space limited to 64")


# ---------------------------------------------------------------------------
# Core level
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CoreConfig:
    cim: CimUnitConfig = field(default_factory=CimUnitConfig)
    vector: VectorUnitConfig = field(default_factory=VectorUnitConfig)
    scalar: ScalarUnitConfig = field(default_factory=ScalarUnitConfig)
    local_mem: LocalMemConfig = field(default_factory=LocalMemConfig)
    regs: RegFileConfig = field(default_factory=RegFileConfig)
    imem_slots: int = 64 * 1024     # instruction memory (instructions)

    @property
    def weight_capacity_bytes(self) -> int:
        return self.cim.weight_capacity_bytes


# ---------------------------------------------------------------------------
# Chip level
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NocConfig:
    """2-D mesh NoC, XY routing, credit-based flow control."""

    flit_bytes: int = 8
    flits_per_cycle: int = 1      # link bandwidth in flits/cycle
    router_latency: int = 2       # cycles per hop
    inject_latency: int = 1

    def __post_init__(self) -> None:
        _require(self.flit_bytes > 0, "flit size must be positive")
        _require(self.flits_per_cycle > 0, "link bandwidth must be positive")

    @property
    def link_bytes_per_cycle(self) -> int:
        return self.flit_bytes * self.flits_per_cycle


@dataclass(frozen=True)
class ChipConfig:
    n_cores: int = 64
    mesh_cols: int = 8                     # NoC mesh X dimension
    core: CoreConfig = field(default_factory=CoreConfig)
    noc: NocConfig = field(default_factory=NocConfig)
    global_mem_bytes: int = 16 * 1024 * 1024
    global_mem_ports: int = 4              # concurrent core<->gmem streams
    global_mem_bytes_per_cycle: int = 64   # per port
    clock_ghz: float = 1.0
    name: str = "cimflow-default"

    def __post_init__(self) -> None:
        _require(self.n_cores > 0, "need at least one core")
        _require(self.mesh_cols > 0 and self.n_cores % self.mesh_cols == 0,
                 "cores must form a full 2-D mesh")

    # -- mesh geometry ------------------------------------------------------

    @property
    def mesh_rows(self) -> int:
        return self.n_cores // self.mesh_cols

    def core_xy(self, core_id: int) -> Tuple[int, int]:
        _require(0 <= core_id < self.n_cores, f"bad core id {core_id}")
        return core_id % self.mesh_cols, core_id // self.mesh_cols

    def hops(self, src: int, dst: int) -> int:
        """Manhattan distance under XY routing."""
        sx, sy = self.core_xy(src)
        dx, dy = self.core_xy(dst)
        return abs(sx - dx) + abs(sy - dy)

    def route(self, src: int, dst: int) -> List[Tuple[int, int]]:
        """XY route as a list of directed links ((x,y) -> next)."""
        sx, sy = self.core_xy(src)
        dx, dy = self.core_xy(dst)
        links: List[Tuple[int, int]] = []
        x, y = sx, sy
        while x != dx:
            nx = x + (1 if dx > x else -1)
            links.append((y * self.mesh_cols + x, y * self.mesh_cols + nx))
            x = nx
        while y != dy:
            ny = y + (1 if dy > y else -1)
            links.append((y * self.mesh_cols + x, ny * self.mesh_cols + x))
            y = ny
        return links

    # -- capacity -----------------------------------------------------------

    @property
    def total_weight_capacity_bytes(self) -> int:
        return self.n_cores * self.core.weight_capacity_bytes

    # -- peak rates (roofline-style anchors for the cost model) -------------

    def peak_macs_per_cycle_per_core(self) -> float:
        """All MGs firing, amortized over a bit-serial pass."""
        cim = self.core.cim
        per_pass = cim.n_macro_groups * cim.macs_per_pass()
        return per_pass / cim.macro.mvm_beats()

    def peak_tops(self) -> float:
        """Chip peak INT8 TOPS (2 ops per MAC)."""
        return (2 * self.peak_macs_per_cycle_per_core() * self.n_cores
                * self.clock_ghz * 1e9 / 1e12)

    # -- timing/energy rules -------------------------------------------------

    def machine(self, calibration: Any = None):
        """The chip's :class:`repro.core.machine.MachineModel` — the one
        object every fidelity reads timing/bandwidth/energy rules from."""
        from .machine import machine_for      # circular-import guard
        return machine_for(self, calibration)

    # -- (de)serialization ---------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), indent=2, **kw)

    def describe(self) -> str:
        cim = self.core.cim
        lines = [
            f"chip '{self.name}': {self.n_cores} cores "
            f"({self.mesh_rows}x{self.mesh_cols} mesh), "
            f"global mem {self.global_mem_bytes // (1024 * 1024)} MB, "
            f"flit {self.noc.flit_bytes} B",
            f"  core: {cim.n_macro_groups} MGs x {cim.macros_per_group} "
            f"macros ({cim.macro.rows}x{cim.macro.cols}), "
            f"local mem {self.core.local_mem.size_bytes // 1024} KB, "
            f"weight cap {self.core.weight_capacity_bytes // 1024} KB",
            f"  peak {self.peak_tops():.1f} INT8 TOPS @ {self.clock_ghz} GHz",
        ]
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Construction helpers
# ---------------------------------------------------------------------------


def default_chip(**overrides: Any) -> ChipConfig:
    """Tab. I default architecture, with keyword overrides.

    Convenience overrides understood beyond plain ChipConfig fields:
    ``macros_per_group``, ``n_macro_groups``, ``flit_bytes``,
    ``local_mem_kb``, ``protection``.
    """
    macro = MacroConfig()
    mg = overrides.pop("macros_per_group", 8)
    n_mg = overrides.pop("n_macro_groups", 16)
    flit = overrides.pop("flit_bytes", 8)
    lmem_kb = overrides.pop("local_mem_kb", 512)
    prot = overrides.pop("protection", ProtectionConfig())
    core = CoreConfig(
        cim=CimUnitConfig(n_macro_groups=n_mg, macros_per_group=mg,
                          macro=macro, protection=prot),
        local_mem=LocalMemConfig(size_bytes=lmem_kb * 1024),
    )
    noc = NocConfig(flit_bytes=flit)
    return ChipConfig(core=core, noc=noc, **overrides)


def _build(cls, data: Dict[str, Any]):
    """Recursively build nested frozen dataclasses from a dict."""
    kwargs: Dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.type) and isinstance(v, dict):
            kwargs[f.name] = _build(f.type, v)
        elif isinstance(v, dict) and f.name in _NESTED:
            kwargs[f.name] = _build(_NESTED[f.name], v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


_NESTED = {
    "macro": MacroConfig,
    "protection": ProtectionConfig,
    "cim": CimUnitConfig,
    "vector": VectorUnitConfig,
    "scalar": ScalarUnitConfig,
    "local_mem": LocalMemConfig,
    "regs": RegFileConfig,
    "core": CoreConfig,
    "noc": NocConfig,
}


def chip_from_dict(data: Dict[str, Any]) -> ChipConfig:
    return _build(ChipConfig, data)


def chip_from_json(text: str) -> ChipConfig:
    return chip_from_dict(json.loads(text))
