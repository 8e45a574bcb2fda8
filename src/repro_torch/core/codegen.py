"""Code generation: mapped stages -> CIMFlow ISA instruction streams.

Host code: a copy of :mod:`repro.core.codegen` (the JAX package), kept
identical so the port's results equal the reference's; the
port imports nothing of ``repro``.

Final compilation phase (paper §III-C): consumes the CG-level partition
(:class:`PartitionResult`), the OP-level schedules (:mod:`.oplevel`) and
emits one :class:`~repro_torch.core.isa.Program` per core per stage, plus the
global-memory image layout (weight blobs, activation buffers).

Execution contract (shared with the simulator):

* Stages execute sequentially; each stage's programs start with a weight
  prologue (GLD weight blobs -> CIM_LOAD into macro groups) and then an
  **unrolled** sample loop: acquire inputs (GLD for stage-boundary groups,
  RECV for intra-stage), im2col-gather, CIM_MVM chunks, fused vector ops,
  deliver outputs (SEND to consumers / GST to global memory).
* Data layout is HWC int8 for activations, ``(ky, kx, c)`` patch ordering
  (``(g, ky, kx)`` for depth-wise); INT32 partial sums; per-group
  fixed-point requantization (``Q_SCALE``/``Q_SHIFT``/``ACC_DIV``).
* Multi-core replicas: every core computes its own n-tile columns; cores
  send quantized slices to the replica's core 0 (*assembly core*), which
  interleaves them into the HWC output buffer and handles fused pooling /
  GAP / residual adds and outbound routing.
* Weight duplication: replicas own row-aligned slices of the output map;
  consumers receive exactly the rows they need (halo included); fused
  pooling recomputes its window halo locally.
* "Rows" generalize: a conv group's row is one feature-map line
  (``W*C`` bytes); a linear group's row is one gemm position (``K`` bytes
  in, ``N`` out).  Producer/consumer row units always agree.

Functional fidelity holds at any size, but local-memory segment bounds are
only *enforced* under ``strict_lmem`` (functional-simulation mode) — large
perf-mode models may logically exceed a segment, which leaves timing
unaffected (the simulator prices transfer sizes and repetition counts; a
production backend would ring-buffer rows with identical traffic).

Weight sources (see :mod:`repro_torch.core.graph`): ``static`` tiles GLD a
gmem blob and CIM_LOAD it in the stage prologue; ``streamed`` tiles
repeat that inside the sample loop, cycling the group's own slot range
(above any co-residents on a time-shared core); ``dynamic`` tiles have
no gmem blob at all — the weight operand is a predecessor group's
activations, RECV'd (or GLD'd across a stage boundary) into a ``wsrc``
buffer and gather-transposed into the CIM write layout
(:func:`repro_torch.core.vecsem.dynamic_weight_matrix`) by strided ``V_MOV``
before every per-sample ``CIM_LOAD``.  Fused ``softmax`` / ``layernorm``
/ ``gelu`` tails lower to the row-segment vector ops whose integer
semantics live in :mod:`repro_torch.core.vecsem`.

Limitations (documented): ``avgpool`` as a fused op is not generated
(none of the paper's benchmarks use it outside GAP); *static*
multi-round weight streaming requires single-chunk groups (true for the
oversized FC layers that trigger it; the dynamic path re-loads per
chunk instead); other non-affine activations (silu/sigmoid/...)
execute on the vector unit's LUT path — timing is modeled, functional
simulation rejects them.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .arch import ChipConfig
from .graph import CondensedGraph, Group
from .isa import FLAGS, Instr, Isa, Program, SREG, VFUNCT, default_isa
from .mapping import StagePlan
from .oplevel import (Im2colSpec, MgAssign, OpSchedule, PoolSpec,
                      ReplicaPlan, incremental_ops, plan_stage)
from .partition import PartitionResult

__all__ = ["QuantParams", "GmemLayout", "StageProgram", "CompiledModel",
           "compile_model", "CodegenError"]

GMEM_BASE = 0x1000_0000


class CodegenError(ValueError):
    pass


@dataclass(frozen=True)
class QuantParams:
    """Fixed-point requant: out = clip(rnd(acc*scale / (div*2^shift)), i8)."""

    scale: int = 1
    shift: int = 8

    def __post_init__(self):
        if not 0 < self.scale < (1 << 15):
            raise CodegenError(f"q-scale {self.scale} out of imm16 range")
        if not 0 <= self.shift < 31:
            raise CodegenError(f"q-shift {self.shift} out of range")


@dataclass
class GmemLayout:
    """Global-memory address map (addresses carry GMEM_BASE)."""

    weights: Dict[Tuple[int, int, int, int], Tuple[int, int]] = \
        field(default_factory=dict)      # (gid,k_off,n_off,ch_off)->(addr,nb)
    biases: Dict[int, Tuple[int, int]] = field(default_factory=dict)
    acts: Dict[Tuple[int, int], Tuple[int, int]] = \
        field(default_factory=dict)      # (gid, sample) -> (addr, nbytes)
    inputs: Dict[int, Tuple[int, int]] = field(default_factory=dict)
    # graph-input op id -> byte offset within each per-sample input
    # region (multi-input graphs, e.g. decode's token + KV caches)
    input_offsets: Dict[int, int] = field(default_factory=dict)
    size: int = 0                        # bytes used (above GMEM_BASE)

    def alloc(self, nbytes: int) -> int:
        addr = GMEM_BASE + self.size
        self.size += (nbytes + 63) & ~63      # 64B aligned
        return addr


@dataclass
class StageProgram:
    stage: StagePlan
    schedules: List[OpSchedule]
    programs: Dict[int, Program]

    @property
    def total_instrs(self) -> int:
        return sum(len(p) for p in self.programs.values())


@dataclass
class CompiledModel:
    cg: CondensedGraph
    chip: ChipConfig
    result: PartitionResult
    stages: List[StageProgram]
    layout: GmemLayout
    batch: int
    isa: Isa
    quant: Dict[int, QuantParams]

    @property
    def total_instrs(self) -> int:
        return sum(s.total_instrs for s in self.stages)

    # -- functional-mode gmem image -------------------------------------------

    def build_gmem_image(self, weights: Dict[int, np.ndarray],
                         biases: Optional[Dict[int, np.ndarray]],
                         inputs: np.ndarray) -> np.ndarray:
        """Materialize weight/bias/input blobs into a gmem byte image.

        ``weights[gid]``: int8 ``(K_total, N_total)`` matrix in the group's
        im2col layout (for depth-wise groups this is the block-diagonal
        expansion; tile blobs are dense slices of it).
        ``inputs``: int8 ``(batch, H, W, C)`` (or ``(batch, K)``).
        """
        biases = biases or {}
        img = np.zeros(self.layout.size, dtype=np.int8)

        def put(addr: int, flat: np.ndarray) -> None:
            off = addr - GMEM_BASE
            img[off:off + flat.size] = flat

        for (gid, k_off, n_off, ch_off), (addr, nb) in \
                self.layout.weights.items():
            w = weights[gid]
            a = self._assign(gid, k_off, n_off, ch_off)
            blob = np.ascontiguousarray(
                w[k_off:k_off + a.k_len, n_off:n_off + a.n_len],
                dtype=np.int8).reshape(-1)
            assert blob.size == nb, (gid, blob.size, nb)
            put(addr, blob)
        for gid, (addr, nb) in self.layout.biases.items():
            b = np.ascontiguousarray(biases[gid], dtype=np.int32)
            assert b.nbytes == nb
            put(addr, b.view(np.int8).reshape(-1))
        for s, (addr, nb) in self.layout.inputs.items():
            put(addr, np.ascontiguousarray(
                inputs[s], dtype=np.int8).reshape(-1))
        return img

    def _assign(self, gid, k_off, n_off, ch_off) -> MgAssign:
        for st in self.stages:
            for sc in st.schedules:
                if sc.gid != gid:
                    continue
                for a in sc.replicas[0].assigns:
                    if (a.k_off, a.n_off, a.ch_off) == (k_off, n_off,
                                                        ch_off):
                        return a
        raise KeyError((gid, k_off, n_off, ch_off))

    def output_addr(self, gid: int, sample: int) -> Tuple[int, int]:
        """gmem (addr, nbytes) of a boundary group's output."""
        return self.layout.acts[(gid, sample)]


# ---------------------------------------------------------------------------
# Emission helper
# ---------------------------------------------------------------------------


class _Emitter:
    """Per-core instruction emitter with S_Reg/G_Reg write coalescing
    (constant propagation + dead-write elimination at emission time)."""

    def __init__(self, isa: Isa, core: int) -> None:
        self.isa = isa
        self.prog = Program(core_id=core)
        self._sregs: Dict[int, int] = {}
        self._gregs: Dict[int, int] = {}
        self.channel_log: List[Tuple[str, int, int, int, str]] = []

    def raw(self, op: str, **args) -> None:
        self.prog.append(self.isa.instr(op, **args))

    def greg(self, reg: int, value: int) -> None:
        if self._gregs.get(reg) == value:
            return
        lo, hi = value & 0xFFFF, (value >> 16) & 0xFFFF
        if lo >= 0x8000:                 # ADDI sign-extends; compensate
            hi = (hi + 1) & 0xFFFF
        s16 = lambda v: v - 0x10000 if v >= 0x8000 else v  # noqa: E731
        if hi:
            self.raw("S_LUI", dst=reg, imm=s16(hi))
            if lo:
                self.raw("S_ADDI", dst=reg, a=reg, imm=s16(lo))
        else:
            self.raw("S_ADDI", dst=reg, a=0, imm=s16(lo))
        self._gregs[reg] = value

    def sreg(self, name: str, value: int) -> None:
        idx = SREG[name]
        if self._sregs.get(idx) == value:
            return
        if -(1 << 15) <= value < (1 << 15):
            self.raw("CIM_CFG", sreg=idx, imm=value)
        else:
            self.greg(9, value)
            self.raw("CIM_CFGR", sreg=idx, src=9)
        self._sregs[idx] = value

    # -- idioms ---------------------------------------------------------------

    def gld(self, dst_lmem: int, gaddr: int, size: int) -> None:
        if size <= 0:
            return
        self.greg(1, dst_lmem)
        self.greg(2, gaddr)
        self.greg(3, size)
        self.raw("GLD", dst=1, gaddr=2, size=3)

    def gst(self, src_lmem: int, gaddr: int, size: int) -> None:
        if size <= 0:
            return
        self.greg(1, src_lmem)
        self.greg(2, gaddr)
        self.greg(3, size)
        self.raw("GST", src=1, gaddr=2, size=3)

    # channel log for the compile-time validation pass: (kind, peer,
    # stream, size, tag) in program order.  ``stream`` is the virtual
    # channel id (S_Reg[CHANNEL]) so multiple logical flows between one
    # core pair rendezvous independently.
    def send(self, dst_core: int, src_lmem: int, size: int,
             tag: str = "", stream: int = 0) -> None:
        if size <= 0:
            return
        self.sreg("CHANNEL", stream)
        self.greg(1, dst_core)
        self.greg(2, src_lmem)
        self.greg(3, size)
        self.raw("SEND", core=1, src=2, size=3)
        self.channel_log.append(("send", dst_core, stream, size, tag))

    def recv(self, dst_lmem: int, src_core: int, size: int,
             tag: str = "", stream: int = 0) -> None:
        if size <= 0:
            return
        self.sreg("CHANNEL", stream)
        self.greg(1, dst_lmem)
        self.greg(2, src_core)
        self.greg(3, size)
        self.raw("RECV", dst=1, core=2, size=3)
        self.channel_log.append(("recv", src_core, stream, size, tag))

    def vec(self, funct_name: str, dst: int, a: int, b: int = 0, *,
            vlen: int, rep: int = 1, seg_d: int = 0, seg_a: int = 0,
            seg_b: int = 0, stride_d: int = 1, stride_a: int = 1,
            stride_b: int = 1, flags: int = 0) -> None:
        if vlen <= 0 or rep <= 0:
            return
        self.sreg("VLEN", vlen)
        self.sreg("V_REP", rep)
        self.sreg("VSEG_D", seg_d)
        self.sreg("VSEG_A", seg_a)
        self.sreg("VSEG_B", seg_b)
        self.sreg("VSTRIDE_D", stride_d)
        self.sreg("VSTRIDE_A", stride_a)
        self.sreg("VSTRIDE_B", stride_b)
        self.greg(4, dst)
        self.greg(5, a)
        self.greg(6, b)
        self.raw(f"V_{funct_name.upper()}", dst=4, a=5, b=6, flags=flags)

    def mvm(self, dst: int, src: int, rep: int, acc: bool, mask: int,
            seg_in: int, seg_out: int) -> None:
        if rep <= 0:
            return
        self.sreg("MG_MASK_LO", mask & 0xFFFF)
        self.sreg("MG_MASK_HI", (mask >> 16) & 0xFFFF)
        self.sreg("MVM_SEG_IN", seg_in)
        self.sreg("MVM_SEG_OUT", seg_out)
        self.greg(7, dst)
        self.greg(8, src)
        self.raw("CIM_MVM", dst=7, src=8, rep=rep, acc=1 if acc else 0)

    def halt(self) -> None:
        self.raw("HALT")


def _ensure_vec_flag_operand(isa: Isa) -> None:
    """R-format V_* instructions carry FLAGS in their 5-bit field."""
    for d in isa.descriptors:
        if d.name.startswith("V_") and d.fmt == "R" and \
                "flags" not in d.operands:
            d.operands["flags"] = "flags"


# ---------------------------------------------------------------------------
# Local memory planning
# ---------------------------------------------------------------------------


class _Lmem:
    def __init__(self, chip: ChipConfig, strict: bool) -> None:
        self.seg = chip.core.local_mem.segment_bytes
        self.n_seg = chip.core.local_mem.n_segments
        self.strict = strict
        self.cursor = [0] * self.n_seg
        # perf-mode out-of-bounds segments, surfaced as one warning per
        # stage by _compile_stage (the silent-overflow footgun fix)
        self.overflows: List[Tuple[int, str]] = []

    def alloc(self, seg: int, nbytes: int, what: str) -> int:
        addr = seg * self.seg + self.cursor[seg]
        self.cursor[seg] += (max(nbytes, 0) + 63) & ~63
        if self.cursor[seg] > self.seg:
            if self.strict:
                raise CodegenError(
                    f"lmem segment {seg} overflow allocating {what} "
                    f"({self.cursor[seg]} > {self.seg})")
            self.overflows.append((seg, what))
        return addr


# ---------------------------------------------------------------------------
# Routing geometry
# ---------------------------------------------------------------------------


def _out_geometry(cg: CondensedGraph, sched: OpSchedule) \
        -> Tuple[int, int, int]:
    """(rows, row_bytes, total_bytes) of the group's *final* output."""
    if sched.gap:
        g = cg[sched.gid]
        return 1, g.out_bytes, g.out_bytes
    if sched.pool is not None:
        p = sched.pool
        return p.ho, p.wo * sched.n_total, p.ho * p.wo * sched.n_total
    if sched.im2col is not None:
        s = sched.im2col
        return s.ho, s.wo * sched.n_total, s.ho * s.wo * sched.n_total
    return (max(sched.m_total, 1), sched.n_total,
            max(sched.m_total, 1) * sched.n_total)


def _pooled_rows(cg: CondensedGraph, sched: OpSchedule,
                 rep: ReplicaPlan) -> Tuple[int, int]:
    """Pooled-output row range a replica owns (pre-GAP)."""
    wo = sched.im2col.wo
    if rep.m_hi <= rep.m_lo:
        return 0, 0
    y0, y1 = rep.m_lo // wo, math.ceil(rep.m_hi / wo)
    p = sched.pool
    # pooled row p owned iff its window start s*p - pad falls in [y0, y1)
    def owner_lo(y): return max(0, math.ceil((y + p.pad) / p.stride))
    p0 = 0 if y0 == 0 else owner_lo(y0)
    p1 = owner_lo(y1) if y1 < sched.im2col.ho else p.ho
    return min(p0, p.ho), min(p1, p.ho)


def _owned_out_rows(cg: CondensedGraph, sched: OpSchedule,
                    rep: ReplicaPlan) -> Tuple[int, int]:
    """Final-output row range produced (and delivered) by a replica."""
    if sched.gap:
        return (0, 1) if rep.replica == 0 else (0, 0)
    if sched.im2col is None:
        return rep.m_lo, rep.m_hi
    if rep.m_hi <= rep.m_lo:
        return 0, 0
    if sched.pool is None:
        wo = sched.im2col.wo
        return rep.m_lo // wo, math.ceil(rep.m_hi / wo)
    return _pooled_rows(cg, sched, rep)


def _conv_rows_to_compute(cg: CondensedGraph, sched: OpSchedule,
                          rep: ReplicaPlan) -> Tuple[int, int]:
    """Anchor output rows a replica computes (incl. pool halo recompute)."""
    if sched.im2col is None:
        return rep.m_lo, rep.m_hi
    if rep.m_hi <= rep.m_lo:
        return 0, 0
    s = sched.im2col
    y0, y1 = rep.m_lo // s.wo, math.ceil(rep.m_hi / s.wo)
    if sched.pool is not None:
        p = sched.pool
        p0, p1 = _pooled_rows(cg, sched, rep)
        if p1 > p0:
            y0 = min(y0, max(0, p0 * p.stride - p.pad))
            y1 = max(y1, min(s.ho, (p1 - 1) * p.stride - p.pad + p.k))
    return y0, y1


def _needed_in_rows(cg: CondensedGraph, sched: OpSchedule,
                    rep: ReplicaPlan, in_rows: int) -> Tuple[int, int]:
    """Input row range a replica needs (conv: feature rows; else m rows)."""
    if sched.im2col is None:
        return rep.m_lo, rep.m_hi
    s = sched.im2col
    y0, y1 = _conv_rows_to_compute(cg, sched, rep)
    if y1 <= y0:
        return 0, 0
    r0 = max(0, y0 * s.stride - s.pad)
    r1 = min(in_rows, (y1 - 1) * s.stride - s.pad + s.kh)
    return r0, max(r0, r1)


def _in_row_bytes(sched: OpSchedule) -> int:
    if sched.im2col is not None:
        return sched.im2col.w * sched.im2col.cin
    return sched.k_total


def _side_pre_reduce(sched: OpSchedule) -> bool:
    """True when the fused residual add/scale precedes pool/GAP in graph
    order (e.g. ResNet head: conv -> add -> relu -> GAP)."""
    vo = list(sched.vector_ops)
    si = min((vo.index(o) for o in ("add", "mul") if o in vo),
             default=None)
    ri = min((vo.index(o) for o in ("maxpool", "avgpool", "globalpool")
              if o in vo), default=None)
    return si is not None and ri is not None and si < ri


# fused ops applied as int8 row-segment tails after the residual side
# op (integer semantics shared with the oracle via repro_torch.core.vecsem)
SPECIAL_TAIL_OPS = ("softmax", "layernorm", "gelu")


def _validate_special_tail(sched: OpSchedule) -> None:
    """Codegen applies softmax/layernorm/gelu last, on the assembled
    int8 output rows — reject fusion orders that contract can't honor."""
    vo = sched.vector_ops
    sp = [i for i, v in enumerate(vo) if v in SPECIAL_TAIL_OPS]
    if not sp:
        return
    if sched.pool is not None or sched.gap:
        raise CodegenError(
            f"{sched.name}: fused {vo[sp[0]]} cannot combine with "
            f"pooling/GAP")
    side = [i for i, v in enumerate(vo) if v in ("add", "mul")]
    if side and min(sp) < max(side):
        raise CodegenError(
            f"{sched.name}: fused {vo[min(sp)]} precedes a residual "
            f"add/mul — unsupported fusion order")
    # everything after the first special must itself be a special tail
    # (codegen emits nothing else back there — e.g. a trailing relu
    # would be silently dropped and diverge from the oracle)
    trailing = [v for v in vo[min(sp):] if v not in SPECIAL_TAIL_OPS]
    if trailing:
        raise CodegenError(
            f"{sched.name}: fused {trailing[0]!r} follows "
            f"{vo[min(sp)]} — unsupported fusion order")


def _relu_after_side(sched: OpSchedule) -> bool:
    vo = list(sched.vector_ops)
    if "relu" not in vo:
        return False
    si = min((vo.index(o) for o in ("add", "mul") if o in vo),
             default=None)
    return si is not None and vo.index("relu") > si


def _side_rows(cg: CondensedGraph, sched: OpSchedule,
               rep: ReplicaPlan) -> Tuple[int, int, int]:
    """(row_lo, row_hi, row_bytes) at which the side operand is applied."""
    if _side_pre_reduce(sched):
        y0, y1 = _conv_rows_to_compute(cg, sched, rep)
        row_nb = (sched.im2col.wo * sched.n_total
                  if sched.im2col is not None else sched.n_total)
        return y0, y1, row_nb
    o0, o1 = _owned_out_rows(cg, sched, rep)
    _, row_nb, _ = _out_geometry(cg, sched)
    return o0, o1, row_nb


def _weight_pred(cg: CondensedGraph, g: Group,
                 op_owner: Dict[int, int]) -> Optional[int]:
    """Weight-producer group of a dynamic-weight anchor (None for static
    groups and for dynamic weights sourced from the graph input)."""
    if not g.dynamic_weights or g.anchor is None or cg.source is None:
        return None
    anchor = cg.source.ops[g.anchor]
    if len(anchor.inputs) < 2:
        return None
    return op_owner.get(anchor.inputs[1])


def _main_and_skip_preds(cg: CondensedGraph, g: Group,
                         op_owner: Dict[int, int]) -> Tuple[Optional[int],
                                                            List[int]]:
    """Main (im2col source) pred group vs side (residual) pred groups.

    A dynamic-weight anchor's second input is its *weight* operand, not
    a residual — it is excluded here and routed by the weight path."""
    main: Optional[int] = None
    if g.anchor is not None and cg.source is not None:
        src_op = cg.source.ops[g.anchor].inputs[0]
        main = op_owner.get(src_op)      # None => graph input
    elif g.preds:
        main = g.preds[0]
    wp = _weight_pred(cg, g, op_owner)
    side = [p for p in g.preds if p != main
            and not (g.dynamic_weights and p == wp)]
    return main, side


def _side_input_ops(cg: CondensedGraph, g: Group) -> List[int]:
    """Graph-input op ids feeding this group's side (residual/scale)
    operands.  Impossible in a freshly condensed model graph (inputs
    are always main operands there), but a system-level pipeline cut
    can turn a residual producer on another chip into a slice input —
    the skip path then loads from the gmem input region instead of a
    producer group's activations."""
    if cg.source is None:
        return []
    main_in = _main_input_op(cg, g)
    wop: Optional[int] = None
    if g.dynamic_weights and g.anchor is not None:
        ins = cg.source.ops[g.anchor].inputs
        wop = ins[1] if len(ins) > 1 else None
    member = set(g.op_ids)
    out: List[int] = []
    for i in g.op_ids:
        for s in cg.source.ops[i].inputs:
            if s in member or cg.source.ops[s].kind != "input":
                continue
            if s == wop or s in out:
                continue
            if s == main_in and (g.anchor is None or i == g.anchor):
                continue
            out.append(s)
    return out


def _main_input_op(cg: CondensedGraph, g: Group) -> Optional[int]:
    """Graph-input op id the group's main operand reads (or None)."""
    if cg.source is None:
        return None
    if g.anchor is not None:
        ins = cg.source.ops[g.anchor].inputs
        return ins[0] if ins else None
    return next((s for i in g.op_ids for s in cg.source.ops[i].inputs
                 if cg.source.ops[s].kind == "input"), None)


# ---------------------------------------------------------------------------
# Model compiler
# ---------------------------------------------------------------------------


def compile_model(result: PartitionResult, batch: Optional[int] = None,
                  quant: Optional[Dict[int, QuantParams]] = None,
                  isa: Optional[Isa] = None,
                  strict_lmem: bool = False) -> CompiledModel:
    """Deprecated free-function entry point.

    Use ``repro_torch.flow.compile(...)`` and ``Artifact.model`` — the
    pass-based pipeline instruments codegen and caches its output.
    This shim stays for existing callers and the golden tests.
    """
    warnings.warn(
        "repro_torch.core.codegen.compile_model() is deprecated; use "
        "repro_torch.flow.compile(workload, chip, options) and the returned "
        "Artifact (its .model / .evaluate(backend=...))",
        DeprecationWarning, stacklevel=2)
    return _compile_model(result, batch, quant, isa, strict_lmem)


def _compile_model(result: PartitionResult, batch: Optional[int] = None,
                   quant: Optional[Dict[int, QuantParams]] = None,
                   isa: Optional[Isa] = None,
                   strict_lmem: bool = False,
                   force_boundary: Optional[Set[int]] = None
                   ) -> CompiledModel:
    """Internal codegen body (the :mod:`repro_torch.flow` codegen pass).

    ``force_boundary`` names group ids whose outputs must be written to
    their gmem activation buffer even when every consumer shares the
    stage — the multi-chip system path reads cut-crossing activations
    out of gmem to feed the next chip.
    """
    cg = result.cg
    chip = result.chip
    isa = isa or default_isa()
    _ensure_vec_flag_operand(isa)
    batch = batch if batch is not None else result.params.batch
    quant = quant or {}
    qp = {g.idx: quant.get(g.idx, QuantParams()) for g in cg}

    layout = GmemLayout()
    in_bytes = _graph_input_bytes(cg)
    if cg.source is not None:
        off = 0
        for op in cg.source.ops:
            if op.kind == "input":
                layout.input_offsets[op.idx] = off
                off += int(np.prod(op.out_shape))
    for s in range(batch):
        layout.inputs[s] = (layout.alloc(in_bytes), in_bytes)

    op_owner: Dict[int, int] = {}
    for g in cg:
        for i in g.op_ids:
            op_owner[i] = g.idx

    stages: List[StageProgram] = []
    for sp in result.stages:
        schedules = plan_stage(cg, sp, chip)
        stages.append(_compile_stage(cg, sp, schedules, chip, isa, layout,
                                     qp, batch, op_owner, strict_lmem,
                                     force_boundary or set()))
    return CompiledModel(cg=cg, chip=chip, result=result, stages=stages,
                         layout=layout, batch=batch, isa=isa, quant=qp)


def _graph_input_bytes(cg: CondensedGraph) -> int:
    if cg.source is None:
        return max((g.in_bytes for g in cg if not g.preds), default=0)
    return sum(int(np.prod(op.out_shape)) for op in cg.source.ops
               if op.kind == "input")


# ---------------------------------------------------------------------------
# Stage compilation
# ---------------------------------------------------------------------------


def _compile_stage(cg: CondensedGraph, sp: StagePlan,
                   schedules: List[OpSchedule], chip: ChipConfig, isa: Isa,
                   layout: GmemLayout, qp: Dict[int, QuantParams],
                   batch: int, op_owner: Dict[int, int],
                   strict_lmem: bool,
                   force_boundary: Optional[Set[int]] = None
                   ) -> StageProgram:
    force_boundary = force_boundary or set()
    by_gid = {s.gid: s for s in schedules}
    member = set(sp.gids)

    # gmem allocation: weight blobs (static sources only — dynamic
    # weights are activations, they never materialize in gmem) +
    # boundary activation buffers
    for sched in schedules:
        if sched.weight_source != "dynamic":
            for a in sched.replicas[0].assigns:
                key = (sched.gid, a.k_off, a.n_off, a.ch_off)
                if key not in layout.weights:
                    nb = a.k_len * a.n_len
                    layout.weights[key] = (layout.alloc(nb), nb)
        if "bias" in sched.vector_ops and sched.gid not in layout.biases:
            nb = sched.n_total * 4
            layout.biases[sched.gid] = (layout.alloc(nb), nb)
        if sched.n_rounds > 1 and sched.n_chunks > 1 \
                and sched.weight_source != "dynamic":
            # the dynamic path re-loads weights per (chunk, round) from
            # local memory instead; gmem-streamed groups would re-fetch
            # the whole blob per chunk, which we refuse to emit
            raise CodegenError(
                f"{sched.name}: multi-round weight streaming requires a "
                f"single m-chunk (got {sched.n_chunks})")
        _validate_special_tail(sched)
    for sched in schedules:
        g = cg[sched.gid]
        consumers = [h for h in cg if g.idx in h.preds]
        boundary_out = (not consumers) or any(h.idx not in member
                                              for h in consumers) \
            or g.idx in force_boundary
        if boundary_out:
            _, _, total = _out_geometry(cg, sched)
            for s in range(batch):
                if (g.idx, s) not in layout.acts:
                    layout.acts[(g.idx, s)] = (layout.alloc(total), total)

    emitters: Dict[int, _Emitter] = {}
    lmems: Dict[int, _Lmem] = {}

    def em(core: int) -> _Emitter:
        if core not in emitters:
            emitters[core] = _Emitter(isa, core)
            lmems[core] = _Lmem(chip, strict_lmem)
        return emitters[core]

    bufs: Dict[Tuple[int, int], Dict] = {}
    for sched in schedules:
        for rep in sched.replicas:
            bufs[(sched.gid, rep.replica)] = _plan_buffers(
                cg, sched, rep, chip, lmems, em, op_owner)

    ctx = _Ctx(cg=cg, sp=sp, chip=chip, layout=layout, bufs=bufs, qp=qp,
               member=member, by_gid=by_gid, op_owner=op_owner, em=em,
               batch=batch, force_boundary=force_boundary)

    # 1. weight prologue (round 0; later rounds stream inside the loop).
    # Dynamic groups have no prologue — their weights are per-sample
    # activations — but any static bias blob still loads here.
    for sched in schedules:
        for rep in sched.replicas:
            if sched.weight_source == "dynamic":
                if "bias" in sched.vector_ops \
                        and sched.gid in layout.biases:
                    addr, nb = layout.biases[sched.gid]
                    bb = bufs[(sched.gid, rep.replica)]
                    for c in rep.cores:
                        em(c).gld(bb["bias"][c], addr, nb)
                continue
            _emit_weight_load(ctx, sched, rep, rnd=0)

    # 2. unrolled sample loop, groups in topological order
    for s in range(batch):
        for sched in schedules:
            for rep in sched.replicas:
                _emit_sample(ctx, sched, rep, s)

    for e in emitters.values():
        e.halt()
        # ship the program with its pre-decoded SoA table: the
        # vectorized simulator replays these columns directly, so the
        # decode pass rides codegen (which is already lazy — analytic /
        # trace evaluations never build programs at all)
        e.prog.pack(isa)
    _validate_channels(emitters)
    over = [(c, seg, what) for c, lm in sorted(lmems.items())
            for seg, what in lm.overflows]
    if over:
        c0, seg0, what0 = over[0]
        more = f" (+{len(over) - 1} more)" if len(over) > 1 else ""
        warnings.warn(
            f"perf-mode lmem overflow: segment {seg0} allocating {what0} "
            f"on core {c0}{more}; timing is unaffected, but functional "
            f"runs require strict_lmem=True", RuntimeWarning,
            stacklevel=3)
    return StageProgram(stage=sp, schedules=schedules,
                        programs={c: e.prog for c, e in emitters.items()})


def _validate_channels(emitters: Dict[int, _Emitter]) -> None:
    """Compiler-side validation (paper §III-A): every SEND must pair with
    a RECV of identical size, in FIFO order per (src, dst, stream)
    virtual channel."""
    sends: Dict[Tuple[int, int, int], List[Tuple[int, str]]] = {}
    recvs: Dict[Tuple[int, int, int], List[Tuple[int, str]]] = {}
    for core, e in emitters.items():
        for kind, peer, stream, size, tag in e.channel_log:
            if kind == "send":
                sends.setdefault((core, peer, stream), []).append(
                    (size, tag))
            else:
                recvs.setdefault((peer, core, stream), []).append(
                    (size, tag))
    for chan in sorted(set(sends) | set(recvs)):
        s = sends.get(chan, [])
        r = recvs.get(chan, [])
        if [x[0] for x in s] != [x[0] for x in r]:
            for i, (a, b) in enumerate(zip(s + [(None, "?")] * len(r),
                                           r + [(None, "?")] * len(s))):
                if a[0] != b[0]:
                    raise CodegenError(
                        f"channel {chan[0]}->{chan[1]}#{chan[2]} "
                        f"message {i}: send {a[0]} ({a[1]}) vs "
                        f"recv {b[0]} ({b[1]})")


def _stream_id(producer_gid: int, consumer_gid: int, kind: int) -> int:
    """Virtual-channel id: (producer, consumer, kind) -> unique tag."""
    return (producer_gid * 128 + consumer_gid) * 8 + kind


@dataclass
class _Ctx:
    cg: CondensedGraph
    sp: StagePlan
    chip: ChipConfig
    layout: GmemLayout
    bufs: Dict
    qp: Dict[int, QuantParams]
    member: Set[int]
    by_gid: Dict[int, OpSchedule]
    op_owner: Dict[int, int]
    em: object
    batch: int
    force_boundary: Set[int] = field(default_factory=set)


def _plan_buffers(cg: CondensedGraph, sched: OpSchedule, rep: ReplicaPlan,
                  chip: ChipConfig, lmems, em, op_owner) -> Dict:
    """Per-(group, replica) lmem buffers; per-core address maps."""
    g = cg[sched.gid]
    tag = f"group {g.idx} ({g.name})"
    for c in rep.cores:
        em(c)                                      # materialize lmem
    out: Dict = {"in": {}, "stage": {}, "wstage": {}, "psum": {},
                 "qtmp": {}, "bias": {}, "wsrc": {}}
    spec = sched.im2col
    r0, r1 = _needed_in_rows(cg, sched, rep,
                             spec.h if spec is not None else 0)
    in_nb = max(r1 - r0, 0) * _in_row_bytes(sched)
    out["in_row0"] = r0
    w_nb = sched.w_rows * sched.w_row_bytes \
        if sched.weight_source == "dynamic" else 0
    for c in rep.cores:
        out["in"][c] = lmems[c].alloc(0, in_nb, f"{tag} input")
        if w_nb:
            out["wsrc"][c] = lmems[c].alloc(0, w_nb, f"{tag} wsrc")
        out["stage"][c] = lmems[c].alloc(
            1, sched.m_chunk * sched.k_total if spec is not None else 0,
            f"{tag} im2col")
        # weight staging: sized to the largest tile actually loaded on
        # this core (a full MG upper-bounds it, but time-shared stages
        # pack many groups per core and the bound wastes segments)
        wstage_nb = max((a.k_len * a.n_len for a in rep.assigns
                         if a.core == c), default=0)
        out["wstage"][c] = lmems[c].alloc(1, wstage_nb, f"{tag} wstage")
        out["psum"][c] = lmems[c].alloc(
            2, sched.m_chunk * sched.n_total * 4, f"{tag} psum")
        out["qtmp"][c] = lmems[c].alloc(
            2, sched.m_chunk * sched.n_total, f"{tag} qtmp")
        if "bias" in sched.vector_ops:
            out["bias"][c] = lmems[c].alloc(2, sched.n_total * 4,
                                            f"{tag} bias")
    asm = rep.cores[0]
    y0, y1 = _conv_rows_to_compute(cg, sched, rep)
    if spec is not None:
        conv_nb = max(y1 - y0, 0) * spec.wo * sched.n_total
    else:
        conv_nb = max(rep.m_hi - rep.m_lo, 0) * sched.n_total
    out["conv"] = lmems[asm].alloc(3, conv_nb, f"{tag} conv-out")
    out["conv_row0"] = y0
    _, row_nb, _ = _out_geometry(cg, sched)
    o0, o1 = _owned_out_rows(cg, sched, rep)
    if sched.pool is not None or sched.gap:
        out["final"] = lmems[asm].alloc(3, max(o1 - o0, 1) * row_nb,
                                        f"{tag} final")
        out["final_row0"] = o0
    else:
        out["final"] = out["conv"]
        out["final_row0"] = y0 if spec is not None else rep.m_lo
    if sched.gap:
        out["gapacc"] = lmems[asm].alloc(2, sched.n_total * 4,
                                         f"{tag} gapacc")
        out["gaptmp"] = lmems[asm].alloc(2, sched.n_total * 4,
                                         f"{tag} gaptmp")
        if sched.pool is not None:
            p0, p1 = _pooled_rows(cg, sched, rep)
            out["pooled"] = lmems[asm].alloc(
                3, max(p1 - p0, 1) * sched.pool.wo * sched.n_total,
                f"{tag} pooled")
    _, side = _main_and_skip_preds(cg, g, op_owner)
    if side or _side_input_ops(cg, g):
        k0, k1, krow_nb = _side_rows(cg, sched, rep)
        out["skip"] = lmems[asm].alloc(
            0, max(max(k1 - k0, 1) * krow_nb, (o1 - o0) * row_nb),
            f"{tag} skip")
    return out


def _round_mask(rep: ReplicaPlan, core: int, rnd: int) -> int:
    mask = 0
    for a in rep.assigns:
        if a.core == core and a.round == rnd:
            mask |= 1 << a.slot
    return mask


def _emit_weight_gather(ctx: _Ctx, sched: OpSchedule, b, e: _Emitter,
                        a: MgAssign) -> None:
    """Stage one dynamic tile: strided V_MOV gather of the weight
    producer's activations (resident in ``wsrc``) into the dense
    ``(k_len, n_len)`` CIM write layout of ``wstage`` — the in-memory
    mirror of :func:`repro_torch.core.vecsem.dynamic_weight_matrix`."""
    g = ctx.cg[sched.gid]
    wsrc = b["wsrc"][a.core]
    wstage = b["wstage"][a.core]
    C = sched.w_row_bytes
    gk, gn = g.gemm_k, g.gemm_n
    if a.ch_cnt > 1:
        # block-diagonal tile: off-diagonal bytes must read as zero
        e.vec("zero", wstage, 0, 0, vlen=a.k_len * a.n_len,
              flags=FLAGS["i8"])
        blocks = [(a.ch_off + ci, 0, gk, 0, gn, ci * gk, ci * gn)
                  for ci in range(a.ch_cnt)]
    else:
        ch = a.ch_off
        blocks = [(ch, a.k_off - ch * gk, a.k_len,
                   a.n_off - ch * gn, a.n_len, 0, 0)]
    for ch, k0, klen, n0, nlen, dr, dc in blocks:
        dst = wstage + dr * a.n_len + dc
        if sched.w_transpose:
            # W[k, n] = wsrc[(n0 + n)·C + ch·gk + k0 + k]  (Q·Kᵀ)
            e.vec("mov", dst, wsrc + n0 * C + ch * gk + k0, 0,
                  vlen=nlen, rep=klen, seg_d=a.n_len, seg_a=1,
                  stride_a=C, flags=FLAGS["i8"])
        else:
            # W[k, n] = wsrc[(k0 + k)·C + ch·gn + n0 + n]  (P·V)
            e.vec("mov", dst, wsrc + k0 * C + ch * gn + n0, 0,
                  vlen=nlen, rep=klen, seg_d=a.n_len, seg_a=C,
                  flags=FLAGS["i8"])


def _emit_weight_load(ctx: _Ctx, sched: OpSchedule, rep: ReplicaPlan,
                      rnd: int) -> None:
    b = ctx.bufs[(sched.gid, rep.replica)]
    dynamic = sched.weight_source == "dynamic"
    for a in rep.assigns:
        if a.round != rnd:
            continue
        e = ctx.em(a.core)
        if dynamic:
            _emit_weight_gather(ctx, sched, b, e, a)
        else:
            addr, nb = ctx.layout.weights[(sched.gid, a.k_off, a.n_off,
                                           a.ch_off)]
            e.gld(b["wstage"][a.core], addr, nb)
        e.sreg("MG_SEL", a.slot)
        e.sreg("MG_KOFF", a.k_off)
        e.sreg("MG_NOFF", a.n_off)
        e.greg(1, b["wstage"][a.core])
        e.sreg("MG_NLEN", a.n_len)
        e.raw("CIM_LOAD", mg=a.slot, src=1, rows=a.k_len)
    # static bias rides round 0 of the (re)load; dynamic groups load it
    # once in the stage prologue instead (their weights re-load every
    # sample, the bias blob does not change)
    if rnd == 0 and not dynamic and "bias" in sched.vector_ops \
            and sched.gid in ctx.layout.biases:
        addr, nb = ctx.layout.biases[sched.gid]
        for c in rep.cores:
            ctx.em(c).gld(b["bias"][c], addr, nb)


def _emit_weight_load_incr(ctx: _Ctx, sched: OpSchedule,
                           rep: ReplicaPlan) -> None:
    """Append-row weight re-stage (``kv_append`` groups, samples > 0).

    The appended producer row is resident at the tail of ``wsrc`` (the
    incremental GLD in the sample loop); only the tiles it touches are
    re-staged — the shapes come from :func:`~repro_torch.core.oplevel.
    incremental_ops`, the single shared definition trace prices:

    * non-transpose (``P·V``): the new V row is one new weight *row*
      per head — one ``n_len``-wide gather V_MOV and a single-row
      ``CIM_LOAD`` at the row's array offset;
    * transpose (``Q·Kᵀ``): the new K row is one new weight *column*
      per head — a strided column gather, then a row-granular re-write
      of the touched tile (``k_len`` = head-dim rows).

    Timing-faithful emission (what trace and the perf simulator price);
    functionally-exact decode would need per-assign ``wstage``
    persistence, which the shared staging buffer does not provide —
    decode runs on the perf/trace rungs of the ladder.
    """
    g = ctx.cg[sched.gid]
    b = ctx.bufs[(sched.gid, rep.replica)]
    row = sched.w_rows - 1
    C = sched.w_row_bytes
    gk, gn = g.gemm_k, g.gemm_n

    def load(e: _Emitter, a: MgAssign, src: int, k_off: int,
             rows: int) -> None:
        e.sreg("MG_SEL", a.slot)
        e.sreg("MG_KOFF", k_off)
        e.sreg("MG_NOFF", a.n_off)
        e.greg(1, src)
        e.sreg("MG_NLEN", a.n_len)
        e.raw("CIM_LOAD", mg=a.slot, src=1, rows=rows)

    for a in rep.assigns:
        if incremental_ops(g, sched, a) is None:
            continue
        e = ctx.em(a.core)
        wsrc = b["wsrc"][a.core]
        wstage = b["wstage"][a.core]
        if a.ch_cnt > 1:
            if sched.w_transpose:
                for ci in range(a.ch_cnt):
                    ch = a.ch_off + ci
                    # new column `row` of head ch's diagonal block
                    e.vec("mov",
                          wstage + ci * gk * a.n_len + ci * gn + row,
                          wsrc + row * C + ch * gk, 0, vlen=1, rep=gk,
                          seg_d=a.n_len, seg_a=1, flags=FLAGS["i8"])
                load(e, a, wstage, a.k_off, a.k_len)
            else:
                for ci in range(a.ch_cnt):
                    ch = a.ch_off + ci
                    lrow = ci * gk + row    # block-local weight row
                    e.vec("mov", wstage + lrow * a.n_len + ci * gn,
                          wsrc + row * C + ch * gn, 0, vlen=gn,
                          flags=FLAGS["i8"])
                    load(e, a, wstage + lrow * a.n_len,
                         a.k_off + lrow, 1)
            continue
        ch = a.ch_off
        if sched.w_transpose:
            col = row - (a.n_off - ch * gn)
            e.vec("mov", wstage + col,
                  wsrc + row * C + ch * gk + (a.k_off - ch * gk), 0,
                  vlen=1, rep=a.k_len, seg_d=a.n_len, seg_a=1,
                  flags=FLAGS["i8"])
            load(e, a, wstage, a.k_off, a.k_len)
        else:
            lrow = row - (a.k_off - ch * gk)
            e.vec("mov", wstage + lrow * a.n_len,
                  wsrc + row * C + ch * gn + (a.n_off - ch * gn), 0,
                  vlen=a.n_len, flags=FLAGS["i8"])
            load(e, a, wstage + lrow * a.n_len, a.k_off + lrow, 1)


# ---------------------------------------------------------------------------
# Per-sample emission
# ---------------------------------------------------------------------------


def _emit_sample(ctx: _Ctx, sched: OpSchedule, rep: ReplicaPlan,
                 s: int) -> None:
    cg = ctx.cg
    g = cg[sched.gid]
    b = ctx.bufs[(sched.gid, rep.replica)]
    spec = sched.im2col
    q = ctx.qp[g.idx]
    main, side = _main_and_skip_preds(cg, g, ctx.op_owner)

    # ---- 1. acquire main input ----------------------------------------------
    # routing works in BYTE ranges of the producer's output buffer so that
    # differing row units (feature rows vs flattened gemm rows) compose
    in_rows_total = spec.h if spec is not None else 0
    r0, r1 = _needed_in_rows(cg, sched, rep, in_rows_total)
    row_nb = _in_row_bytes(sched)
    need_lo, need_hi = r0 * row_nb, r1 * row_nb
    if main is None or main not in ctx.member:
        base, _ = (ctx.layout.inputs[s] if main is None
                   else ctx.layout.acts[(main, s)])
        if main is None:
            # multi-input graphs: offset to this group's input operand
            # within the per-sample region (0 for single-input graphs)
            base += ctx.layout.input_offsets.get(
                _main_input_op(cg, g) or -1, 0)
        for c in rep.cores:
            ctx.em(c).gld(b["in"][c], base + need_lo, need_hi - need_lo)
    else:
        prod = ctx.by_gid[main]
        _, prnb, _ = _out_geometry(cg, prod)
        for prep in prod.replicas:
            p0, p1 = _owned_out_rows(cg, prod, prep)
            lo, hi = max(need_lo, p0 * prnb), min(need_hi, p1 * prnb)
            if hi <= lo:
                continue
            for c in rep.cores:
                ctx.em(c).recv(b["in"][c] + lo - need_lo,
                               prep.cores[0], hi - lo,
                               tag=f"in:{g.name}@s{s}",
                               stream=_stream_id(main, g.idx, 0))

    # ---- 1b. acquire skip/scale operands --------------------------------------
    o0, o1 = _owned_out_rows(cg, sched, rep)
    _, out_row_nb, _ = _out_geometry(cg, sched)
    k0, k1, krow_nb = _side_rows(cg, sched, rep)
    bcast_side = False
    for sgid in side:
        if k1 <= k0:
            break
        prod_sched = ctx.by_gid.get(sgid)
        prod_rows, prod_row_nb = None, None
        if prod_sched is not None:
            prod_rows, prod_row_nb, _ = _out_geometry(cg, prod_sched)
        bcast = prod_rows == 1 and ((k1 - k0) * krow_nb > krow_nb
                                    or krow_nb != prod_row_nb)
        if sgid in ctx.member:
            prod = ctx.by_gid[sgid]
            for prep in prod.replicas:
                p0, p1 = _owned_out_rows(cg, prod, prep)
                if bcast:
                    lo, hi = (0, 1) if (p0, p1) == (0, 1) else (0, 0)
                else:
                    lo, hi = max(k0, p0), min(k1, p1)
                if hi <= lo:
                    continue
                nb = prod_row_nb if bcast else krow_nb
                off = 0 if bcast else (lo - k0) * krow_nb
                ctx.em(rep.cores[0]).recv(
                    b["skip"] + off, prep.cores[0], (hi - lo) * nb,
                    tag=f"skip:{g.name}@s{s}",
                    stream=_stream_id(sgid, g.idx, 2 if bcast else 1))
        else:
            base, nbt = ctx.layout.acts[(sgid, s)]
            if bcast:
                ctx.em(rep.cores[0]).gld(b["skip"], base, nbt)
            else:
                ctx.em(rep.cores[0]).gld(b["skip"], base + k0 * krow_nb,
                                         (k1 - k0) * krow_nb)
        bcast_side = bcast_side or bcast
    side_inputs = _side_input_ops(cg, g)
    if k1 > k0:
        # residual operand arriving as a graph input (a system-level
        # pipeline cut upstream): load it from the gmem input region
        for sop in side_inputs:
            base, _ = ctx.layout.inputs[s]
            base += ctx.layout.input_offsets.get(sop, 0)
            ctx.em(rep.cores[0]).gld(b["skip"], base + k0 * krow_nb,
                                     (k1 - k0) * krow_nb)

    # ---- 1c. acquire dynamic weights (a predecessor's activations) ----------
    dynamic = sched.weight_source == "dynamic"
    incr = False
    if dynamic:
        if spec is not None:
            raise CodegenError(f"{g.name}: dynamic weights on a conv "
                               f"anchor are not supported")
        wgid = sched.weight_pred
        w_nb = sched.w_rows * sched.w_row_bytes
        # append-only cache (kv_append): samples > 0 fetch only the
        # appended row into the resident wsrc and re-stage just the
        # tiles it touches.  Needs a gmem-resident source (an in-stage
        # producer re-SENDs its whole output every sample) and a
        # single-round schedule (slot cycling leaves nothing resident).
        incr = (sched.w_incremental and sched.n_rounds == 1 and s > 0
                and (wgid is None or wgid not in ctx.member))
        if wgid is None or wgid not in ctx.member:
            base, _ = (ctx.layout.inputs[s] if wgid is None
                       else ctx.layout.acts[(wgid, s)])
            if wgid is None and sched.w_input is not None:
                base += ctx.layout.input_offsets.get(sched.w_input, 0)
            if incr:
                off = (sched.w_rows - 1) * sched.w_row_bytes
                for c in rep.cores:
                    ctx.em(c).gld(b["wsrc"][c] + off, base + off,
                                  sched.w_row_bytes)
            else:
                for c in rep.cores:
                    ctx.em(c).gld(b["wsrc"][c], base, w_nb)
        else:
            prod = ctx.by_gid[wgid]
            _, prnb, ptot = _out_geometry(cg, prod)
            if prnb != sched.w_row_bytes or ptot != w_nb:
                raise CodegenError(
                    f"{g.name}: weight producer '{prod.name}' output "
                    f"layout ({ptot}B rows of {prnb}) does not match "
                    f"the weight operand ({w_nb}B rows of "
                    f"{sched.w_row_bytes})")
            for prep in prod.replicas:
                p0, p1 = _owned_out_rows(cg, prod, prep)
                if p1 <= p0:
                    continue
                for c in rep.cores:
                    ctx.em(c).recv(b["wsrc"][c] + p0 * prnb,
                                   prep.cores[0], (p1 - p0) * prnb,
                                   tag=f"wgt:{g.name}@s{s}",
                                   stream=_stream_id(wgid, g.idx, 5))

    # ---- 2. compute ------------------------------------------------------------
    y0, y1 = _conv_rows_to_compute(cg, sched, rep)
    if dynamic and sched.n_rounds > 1:
        # weights change per sample AND exceed the free slots: re-gather
        # and re-load per (chunk, round) from the resident wsrc — pure
        # local-memory traffic, so the single-m-chunk restriction of the
        # gmem-streamed path does not apply
        _emit_linear_chunks_dynamic(ctx, sched, rep, b, q)
    else:
        for rnd in range(sched.n_rounds):
            # multi-round groups stream weights every sample (slots were
            # left holding the previous sample's last round); dynamic
            # groups re-write their arrays every sample — append-only
            # caches re-stage just the appended row's tiles
            if incr:
                if rnd == 0:
                    _emit_weight_load_incr(ctx, sched, rep)
            elif rnd > 0 or (sched.n_rounds > 1 and s > 0) or dynamic:
                _emit_weight_load(ctx, sched, rep, rnd)
            if spec is not None:
                for y in range(y0, y1):
                    for x0 in range(0, spec.wo, sched.m_chunk):
                        x1 = min(spec.wo, x0 + sched.m_chunk)
                        _emit_conv_chunk(ctx, sched, rep, b, spec, y, x0,
                                         x1, rnd, q, y0)
            else:
                _emit_linear_chunks(ctx, sched, rep, b, rnd, q)

    # ---- 3. assembly (multi-core replicas) ------------------------------------
    if len(rep.cores) > 1:
        _emit_assembly(ctx, sched, rep, b, spec, y0, y1)

    e = ctx.em(rep.cores[0])

    # ---- 4. fused tail (graph order) ------------------------------------------
    has_side_op = "add" in sched.vector_ops or "mul" in sched.vector_ops
    self_skip = has_side_op and not side and not side_inputs
    side_pre = _side_pre_reduce(sched)

    def apply_side(buf_addr: int, lo: int, hi: int, row_nb: int) -> None:
        """Saturating residual add / SE scale (+ trailing relu) on int8."""
        if hi <= lo:
            return
        if self_skip:
            # the residual operand IS the main input: rows already local
            if spec is None or spec.stride != 1 or \
                    _in_row_bytes(sched) != row_nb:
                raise CodegenError(f"{sched.name}: self-residual needs a "
                                   f"stride-1 shape-preserving anchor")
            src = b["in"][rep.cores[0]] + (lo - b["in_row0"]) * row_nb
        else:
            src = b["skip"]
        if "mul" in sched.vector_ops and bcast_side:
            e.vec("mul", buf_addr, buf_addr, src, vlen=sched.n_total,
                  rep=(hi - lo) * row_nb // sched.n_total,
                  seg_d=sched.n_total, seg_a=sched.n_total, seg_b=0,
                  flags=FLAGS["i8"])
        else:
            e.vec("add", buf_addr, buf_addr, src,
                  vlen=(hi - lo) * row_nb, flags=FLAGS["i8"])
        if _relu_after_side(sched):
            e.vec("relu", buf_addr, buf_addr, 0,
                  vlen=(hi - lo) * row_nb, flags=FLAGS["i8"])

    if has_side_op and side_pre:
        apply_side(b["conv"], k0, k1, krow_nb)
    if sched.gap:
        if sched.pool is not None:
            p0, p1 = _pooled_rows(cg, sched, rep)
            _emit_pool(sched, rep, b, e, spec, y0, y1, p0, p1,
                       dst_buf=b["pooled"])
        _emit_gap(ctx, sched, rep, b, spec, y0, y1, q)
        if rep.replica != 0:
            return
        o0, o1 = 0, 1
    elif sched.pool is not None:
        _emit_pool(sched, rep, b, e, spec, y0, y1, o0, o1,
                   dst_buf=b["final"])
    if has_side_op and not side_pre:
        apply_side(b["final"], o0, o1, out_row_nb)

    # ---- 4b. fused special tails (softmax / layernorm / gelu) -----------------
    # applied on the assembled int8 rows, in graph order after the
    # residual (validated by _validate_special_tail); row-segment
    # integer semantics shared with the oracle via repro_torch.core.vecsem
    for vop in sched.vector_ops:
        if vop not in SPECIAL_TAIL_OPS or o1 <= o0:
            continue
        total = (o1 - o0) * out_row_nb
        if vop == "gelu":
            e.vec("gelu", b["final"], b["final"], 0, vlen=total,
                  flags=FLAGS["i8"])
            continue
        # softmax normalizes per head-row segment; layernorm per row
        seg = g.gemm_n if vop == "softmax" else sched.n_total
        e.vec(vop, b["final"], b["final"], 0, vlen=seg,
              rep=total // seg, seg_d=seg, seg_a=seg, flags=FLAGS["i8"])

    # ---- 5. deliver -------------------------------------------------------------
    consumers = [h for h in cg if g.idx in h.preds]
    boundary_out = (not consumers) or any(h.idx not in ctx.member
                                          for h in consumers) \
        or g.idx in ctx.force_boundary
    my_rows, my_row_nb, _ = _out_geometry(cg, sched)
    for h in consumers:
        if h.idx not in ctx.member:
            continue
        cons = ctx.by_gid[h.idx]
        hmain, _ = _main_and_skip_preds(cg, h, ctx.op_owner)
        if cons.weight_source == "dynamic" and cons.weight_pred == g.idx:
            # this output IS the consumer's weight operand: every core
            # of every consumer replica gathers tiles from it
            if o1 > o0:
                for crep in cons.replicas:
                    for tc in crep.cores:
                        e.send(tc, b["final"], (o1 - o0) * my_row_nb,
                               tag=f"wgt:{g.name}->{h.name}@s{s}",
                               stream=_stream_id(g.idx, h.idx, 5))
            if hmain != g.idx:
                continue
        for crep in cons.replicas:
            if hmain == g.idx:
                # byte-range intersection (mirrors consumer acquisition)
                c0, c1 = _needed_in_rows(cg, cons, crep,
                                         cons.im2col.h
                                         if cons.im2col is not None else 0)
                crnb = _in_row_bytes(cons)
                lo_b = max(o0 * my_row_nb, c0 * crnb)
                hi_b = min(o1 * my_row_nb, c1 * crnb)
                if hi_b <= lo_b:
                    continue
                for tc in crep.cores:
                    e.send(tc, b["final"] + lo_b - o0 * my_row_nb,
                           hi_b - lo_b,
                           tag=f"out:{g.name}->{h.name}@s{s}",
                           stream=_stream_id(g.idx, h.idx, 0))
                continue
            c0, c1, crow_nb = _side_rows(cg, cons, crep)
            if my_rows == 1 and (c1 - c0 != 1 or crow_nb != my_row_nb):
                # broadcast (SE-style) operand: one row to replica 0
                if c1 > c0 and o0 == 0 and o1 >= 1:
                    e.send(crep.cores[0], b["final"], my_row_nb,
                           tag=f"bcast:{g.name}->{h.name}@s{s}",
                           stream=_stream_id(g.idx, h.idx, 2))
                continue
            lo, hi = max(o0, c0), min(o1, c1)
            if hi <= lo:
                continue
            e.send(crep.cores[0], b["final"] + (lo - o0) * out_row_nb,
                   (hi - lo) * out_row_nb,
                   tag=f"side:{g.name}->{h.name}@s{s}",
                   stream=_stream_id(g.idx, h.idx, 1))
    if boundary_out and o1 > o0:
        base, _ = ctx.layout.acts[(g.idx, s)]
        e.gst(b["final"], base + o0 * out_row_nb, (o1 - o0) * out_row_nb)


# -- chunk emission -----------------------------------------------------------


def _emit_conv_chunk(ctx: _Ctx, sched: OpSchedule, rep: ReplicaPlan, b,
                     spec: Im2colSpec, y: int, x0: int, x1: int, rnd: int,
                     q: QuantParams, conv_y0: int) -> None:
    npos = x1 - x0
    K = sched.k_total
    r0 = b["in_row0"]
    s = spec.stride
    for c in rep.cores:
        e = ctx.em(c)
        stage = b["stage"][c]
        inb = b["in"][c]
        # interior position range whose full kw window is in [0, W)
        xlo = max(x0, math.ceil(spec.pad / s)) if spec.pad else x0
        xhi = min(x1, (spec.w - spec.kw + spec.pad) // s + 1)
        top_bot = (y * s - spec.pad < 0
                   or y * s - spec.pad + spec.kh > spec.h)
        if spec.pad > 0 and (top_bot or xlo > x0 or xhi < x1):
            e.vec("zero", stage, 0, 0, vlen=K, rep=npos, seg_d=K,
                  flags=FLAGS["i8"])
        for ky in range(spec.kh):
            iy = y * s - spec.pad + ky
            if iy < 0 or iy >= spec.h:
                continue
            irow = inb + (iy - r0) * spec.w * spec.cin
            if not spec.depthwise:
                # bulk: positions [xlo, xhi) copy their full (kw*cin) row
                if xhi > xlo:
                    e.vec("mov",
                          stage + (xlo - x0) * K + ky * spec.kw * spec.cin,
                          irow + (xlo * s - spec.pad) * spec.cin, 0,
                          vlen=spec.kw * spec.cin, rep=xhi - xlo,
                          seg_d=K, seg_a=s * spec.cin, flags=FLAGS["i8"])
                # clipped edges, one position at a time
                for x in list(range(x0, min(xlo, x1))) + \
                        list(range(max(xhi, x0), x1)):
                    sx = x * s - spec.pad
                    c0 = max(0, -sx)                  # first valid tap
                    c1 = min(spec.kw, spec.w - sx)    # end of valid taps
                    if c1 <= c0:
                        continue
                    e.vec("mov",
                          stage + (x - x0) * K
                          + (ky * spec.kw + c0) * spec.cin,
                          irow + (sx + c0) * spec.cin, 0,
                          vlen=(c1 - c0) * spec.cin, rep=1,
                          flags=FLAGS["i8"])
            else:
                # depth-wise: per (ky,kx) channel-contiguous taps into the
                # (g, ky, kx) patch layout
                for kx in range(spec.kw):
                    sx0 = -spec.pad + kx
                    lo = max(x0, math.ceil(-sx0 / s))
                    hi = min(x1 - 1, (spec.w - 1 - sx0) // s)
                    if hi < lo:
                        continue
                    e.vec("mov",
                          stage + (lo - x0) * K + ky * spec.kw + kx,
                          irow + (lo * s + sx0) * spec.cin, 0,
                          vlen=spec.cin, rep=hi - lo + 1,
                          seg_d=K, seg_a=s * spec.cin,
                          stride_d=spec.kh * spec.kw, stride_a=1,
                          flags=FLAGS["i8"])
        mask = _round_mask(rep, c, rnd)
        e.mvm(b["psum"][c], stage, rep=npos, acc=(rnd > 0), mask=mask,
              seg_in=K, seg_out=sched.n_total * 4)
    _emit_postops_chunk(ctx, sched, rep, b, q, npos=npos,
                        out_off=((y - conv_y0) * spec.wo + x0)
                        * sched.n_total,
                        last_round=(rnd == sched.n_rounds - 1))


def _emit_linear_mvm(ctx: _Ctx, sched: OpSchedule, rep: ReplicaPlan, b,
                     c0: int, npos: int, rnd: int) -> None:
    """One m-chunk's MVM burst on every core of the replica (shared by
    the round-outer static path and the chunk-outer dynamic path)."""
    K = sched.k_total
    for c in rep.cores:
        e = ctx.em(c)
        e.mvm(b["psum"][c], b["in"][c] + (c0 - rep.m_lo) * K, rep=npos,
              acc=(rnd > 0), mask=_round_mask(rep, c, rnd), seg_in=K,
              seg_out=sched.n_total * 4)


def _emit_linear_chunks(ctx: _Ctx, sched: OpSchedule, rep: ReplicaPlan,
                        b, rnd: int, q: QuantParams) -> None:
    m0, m1 = rep.m_lo, rep.m_hi
    for c0 in range(m0, m1, sched.m_chunk):
        c1 = min(m1, c0 + sched.m_chunk)
        npos = c1 - c0
        _emit_linear_mvm(ctx, sched, rep, b, c0, npos, rnd)
        _emit_postops_chunk(ctx, sched, rep, b, q, npos=npos,
                            out_off=(c0 - m0) * sched.n_total,
                            last_round=(rnd == sched.n_rounds - 1))


def _emit_linear_chunks_dynamic(ctx: _Ctx, sched: OpSchedule,
                                rep: ReplicaPlan, b,
                                q: QuantParams) -> None:
    """Dynamic multi-round emission: chunk-outer / round-inner.

    Each m-chunk's INT32 partial sums accumulate across rounds before
    post-ops run once, with the round's weights re-gathered from the
    resident ``wsrc`` buffer — this is what lifts the static path's
    "multi-round requires a single m-chunk" restriction for dynamic
    weights (re-loading costs local-memory traffic only)."""
    m0, m1 = rep.m_lo, rep.m_hi
    for c0 in range(m0, m1, sched.m_chunk):
        c1 = min(m1, c0 + sched.m_chunk)
        npos = c1 - c0
        for rnd in range(sched.n_rounds):
            _emit_weight_load(ctx, sched, rep, rnd)
            _emit_linear_mvm(ctx, sched, rep, b, c0, npos, rnd)
        _emit_postops_chunk(ctx, sched, rep, b, q, npos=npos,
                            out_off=(c0 - m0) * sched.n_total,
                            last_round=True)


def _core_columns(rep: ReplicaPlan, core: int) -> List[MgAssign]:
    seen: Dict[int, MgAssign] = {}
    for a in rep.assigns:
        if a.core == core and a.n_off not in seen:
            seen[a.n_off] = a
    return list(seen.values())


def _emit_postops_chunk(ctx: _Ctx, sched: OpSchedule, rep: ReplicaPlan, b,
                        q: QuantParams, npos: int, out_off: int,
                        last_round: bool) -> None:
    """bias -> relu -> requant -> place int8 rows."""
    if not last_round:
        return
    N = sched.n_total
    multi = len(rep.cores) > 1
    # relu applies on INT32 pre-quant iff it is the first fused op after
    # bias (graph order); a relu that follows add/mul runs post-add on int8
    first = next((v for v in sched.vector_ops if v != "bias"), None)
    relu_here = first == "relu"
    for c in rep.cores:
        e = ctx.em(c)
        cols = _core_columns(rep, c)
        if "bias" in sched.vector_ops:
            for a in cols:
                e.vec("add", b["psum"][c] + a.n_off * 4,
                      b["psum"][c] + a.n_off * 4,
                      b["bias"][c] + a.n_off * 4,
                      vlen=a.n_len, rep=npos, seg_d=N * 4, seg_a=N * 4,
                      seg_b=0)
        e.sreg("Q_SCALE", q.scale)
        e.sreg("Q_SHIFT", q.shift)
        e.sreg("ACC_DIV", 1)
        if not multi:
            if relu_here:
                e.vec("relu", b["psum"][c], b["psum"][c], 0,
                      vlen=npos * N)
            e.vec("quant", b["conv"] + out_off, b["psum"][c], 0,
                  vlen=npos * N)
        else:
            for a in cols:
                if relu_here:
                    e.vec("relu", b["psum"][c] + a.n_off * 4,
                          b["psum"][c] + a.n_off * 4, 0,
                          vlen=a.n_len, rep=npos, seg_d=N * 4,
                          seg_a=N * 4)
                e.vec("quant", b["qtmp"][c], b["psum"][c] + a.n_off * 4,
                      0, vlen=a.n_len, rep=npos, seg_d=a.n_len,
                      seg_a=N * 4)
                if c != rep.cores[0]:
                    e.send(rep.cores[0], b["qtmp"][c], npos * a.n_len,
                           tag=f"nslice:{sched.name}",
                           stream=_stream_id(sched.gid, sched.gid, 3))
                else:
                    e.vec("mov", b["conv"] + out_off + a.n_off,
                          b["qtmp"][c], 0, vlen=a.n_len, rep=npos,
                          seg_d=N, seg_a=a.n_len, flags=FLAGS["i8"])


def _emit_assembly(ctx: _Ctx, sched: OpSchedule, rep: ReplicaPlan, b,
                   spec, y0: int, y1: int) -> None:
    """Assembly core interleaves sibling cores' quantized n-slices."""
    e = ctx.em(rep.cores[0])
    N = sched.n_total
    if spec is not None:
        chunks = [((y - y0) * spec.wo + x0, min(spec.wo - x0, sched.m_chunk))
                  for y in range(y0, y1)
                  for x0 in range(0, spec.wo, sched.m_chunk)]
    else:
        span = rep.m_hi - rep.m_lo
        chunks = [(c0, min(span - c0, sched.m_chunk))
                  for c0 in range(0, span, sched.m_chunk)]
    for (off, npos) in chunks:
        for c in rep.cores[1:]:
            for a in _core_columns(rep, c):
                e.recv(b["qtmp"][rep.cores[0]], c, npos * a.n_len,
                       tag=f"asm:{sched.name}",
                       stream=_stream_id(sched.gid, sched.gid, 3))
                e.vec("mov", b["conv"] + off * N + a.n_off,
                      b["qtmp"][rep.cores[0]], 0, vlen=a.n_len, rep=npos,
                      seg_d=N, seg_a=a.n_len, flags=FLAGS["i8"])


def _emit_pool(sched: OpSchedule, rep: ReplicaPlan, b, e, spec,
               y0: int, y1: int, o0: int, o1: int,
               dst_buf: int = 0) -> None:
    """Fused max pooling over this replica's conv rows (HWC, post-relu:
    zero-init equals -inf since inputs are non-negative)."""
    p = sched.pool
    if p.kind != "maxpool":
        raise CodegenError(f"{sched.name}: fused {p.kind} not supported")
    N = sched.n_total
    W = spec.wo
    for po in range(o0, o1):
        dst = dst_buf + (po - o0) * p.wo * N
        e.vec("zero", dst, 0, 0, vlen=p.wo * N, flags=FLAGS["i8"])
        for jy in range(p.k):
            iy = po * p.stride - p.pad + jy
            if iy < y0 or iy >= y1:
                continue
            for jx in range(p.k):
                sx0 = -p.pad + jx
                lo = max(0, math.ceil(-sx0 / p.stride))
                hi = min(p.wo - 1, (W - 1 - sx0) // p.stride)
                if hi < lo:
                    continue
                e.vec("max", dst + lo * N, dst + lo * N,
                      b["conv"] + (iy - y0) * W * N
                      + (lo * p.stride + sx0) * N,
                      vlen=N, rep=hi - lo + 1, seg_d=N, seg_a=N,
                      seg_b=p.stride * N, flags=FLAGS["i8"])


def _emit_gap(ctx: _Ctx, sched: OpSchedule, rep: ReplicaPlan, b, spec,
              y0: int, y1: int, q: QuantParams) -> None:
    """Global average pool: per-replica partials, reduce on replica 0."""
    e = ctx.em(rep.cores[0])
    N = sched.n_total
    if sched.pool is not None:
        p0, p1 = _pooled_rows(ctx.cg, sched, rep)
        src, npos = b["pooled"], (p1 - p0) * sched.pool.wo
    elif spec is not None:
        src, npos = b["conv"], (y1 - y0) * spec.wo
    else:
        src, npos = b["conv"], rep.m_hi - rep.m_lo
    acc = b["gapacc"]
    e.vec("zero", acc, 0, 0, vlen=N)
    if npos > 0:
        e.vec("sum8", acc, src, 0, vlen=N, rep=npos, seg_d=0,
              seg_a=N)
    rep0 = sched.replicas[0]
    if rep.replica != 0:
        e.send(rep0.cores[0], acc, N * 4, tag=f"gap:{sched.name}",
               stream=_stream_id(sched.gid, sched.gid, 4))
        return
    e0 = ctx.em(rep0.cores[0])
    for other in sched.replicas[1:]:
        e0.recv(b["gaptmp"], other.cores[0], N * 4,
                tag=f"gap:{sched.name}",
                stream=_stream_id(sched.gid, sched.gid, 4))
        e0.vec("add", acc, acc, b["gaptmp"], vlen=N)
    if sched.pool is not None:
        m = sched.pool.ho * sched.pool.wo
    else:
        m = max(sched.m_total, 1)
    e0.sreg("Q_SCALE", q.scale)
    e0.sreg("Q_SHIFT", q.shift)
    e0.sreg("ACC_DIV", m)              # mean folded into the requant
    e0.vec("quant", b["final"], acc, 0, vlen=N)
