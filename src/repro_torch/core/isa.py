"""CIMFlow instruction set architecture.

Host code: a copy of :mod:`repro.core.isa` (the JAX package), kept
identical so the port's results equal the reference's; the
port imports nothing of ``repro``.

Implements the paper's unified 32-bit instruction format (§III-B):

* 6-bit operation specifier (opcode), multiple 5-bit operand fields;
* supplementary fields: 6-bit functionality specifier, execution flags,
  and 10/16/26-bit immediates;
* up to four operands per instruction;
* three instruction categories — compute (CIM / vector / scalar),
  communication, and control flow;
* extensibility through a *customized instruction description template*
  (:class:`InstrDescriptor`): new operations integrate by registering a
  descriptor with its performance parameters (latency/energy classes), no
  framework changes required.

Encoding formats (bit widths sum to 32, packed MSB-first):

    R : opcode(6) rd(5) rs1(5) rs2(5) funct(6) flags(5)
    I : opcode(6) rd(5) rs1(5) imm16(16)
    C : opcode(6) rd(5) rs1(5) funct(6) imm10(10)
    J : opcode(6) imm26(26)

The compiler manipulates symbolic :class:`Instr` objects; `encode` /
`decode` provide the binary round-trip used by the ISA conformance tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "FORMATS",
    "InstrDescriptor",
    "Instr",
    "Isa",
    "PackedProgram",
    "Program",
    "default_isa",
    "VFUNCT",
    "SALU_FUNCT",
    "SREG",
    "FLAGS",
]


class IsaError(ValueError):
    pass


# field name -> width, per format (MSB first)
FORMATS: Dict[str, List[Tuple[str, int]]] = {
    "R": [("opcode", 6), ("rd", 5), ("rs1", 5), ("rs2", 5),
          ("funct", 6), ("flags", 5)],
    "I": [("opcode", 6), ("rd", 5), ("rs1", 5), ("imm16", 16)],
    "C": [("opcode", 6), ("rd", 5), ("rs1", 5), ("funct", 6), ("imm10", 10)],
    "J": [("opcode", 6), ("imm26", 26)],
}

_SIGNED_FIELDS = {"imm16", "imm10", "imm26"}


def _check_format(fmt: str) -> List[Tuple[str, int]]:
    if fmt not in FORMATS:
        raise IsaError(f"unknown format {fmt!r}")
    return FORMATS[fmt]


@dataclass(frozen=True)
class InstrDescriptor:
    """Instruction description template (paper §III-B, extensibility).

    ``operands`` maps *semantic* operand names (what the compiler uses, e.g.
    ``dst``/``src``/``size``) to *encoding* fields of ``fmt`` (e.g. ``rd``).
    ``unit`` names the execution unit for the simulator's pipeline model;
    ``latency_class``/``energy_class`` key into its performance tables, so a
    new instruction is fully specified by one descriptor.
    """

    name: str
    opcode: int
    fmt: str
    unit: str                      # cim | vector | scalar | noc | control
    operands: Dict[str, str] = field(default_factory=dict)
    latency_class: str = "alu"
    energy_class: str = "scalar_alu"
    funct: Optional[int] = None    # fixed funct value, if the op owns one
    description: str = ""

    def __post_init__(self) -> None:
        fields = dict(_check_format(self.fmt))
        if not 0 <= self.opcode < 64:
            raise IsaError(f"{self.name}: opcode {self.opcode} out of range")
        for sem, enc in self.operands.items():
            if enc not in fields:
                raise IsaError(
                    f"{self.name}: operand {sem!r} maps to unknown field "
                    f"{enc!r} of format {self.fmt}")
            if enc == "opcode":
                raise IsaError(f"{self.name}: cannot bind operand to opcode")
        if self.funct is not None and "funct" not in fields:
            raise IsaError(f"{self.name}: format {self.fmt} has no funct")


@dataclass
class Instr:
    """A symbolic instruction: descriptor name + semantic operand values."""

    op: str
    args: Dict[str, int] = field(default_factory=dict)
    # Optional metadata used by the compiler/simulator, not encoded.
    meta: Dict[str, Any] = field(default_factory=dict)

    def __repr__(self) -> str:  # compact, stable for goldens
        a = ", ".join(f"{k}={v}" for k, v in self.args.items())
        return f"{self.op}({a})"


class Isa:
    """A registry of instruction descriptors with encode/decode."""

    def __init__(self, name: str = "cimflow-v1") -> None:
        self.name = name
        self._by_name: Dict[str, InstrDescriptor] = {}
        # (opcode, funct-or-None) -> descriptor; ops sharing an opcode must
        # use distinct fixed functs.
        self._by_code: Dict[Tuple[int, Optional[int]], InstrDescriptor] = {}
        self._opcode_fmt: Dict[int, str] = {}
        # dense op numbering (registration order): the decode tables the
        # pre-decoded simulator indexes with — unlike the sparse
        # (opcode, funct) encoding space, ids are contiguous ints
        self._index: Dict[str, int] = {}

    # -- registration --------------------------------------------------------

    def register(self, d: InstrDescriptor) -> InstrDescriptor:
        if d.name in self._by_name:
            raise IsaError(f"duplicate instruction name {d.name}")
        if d.opcode in self._opcode_fmt:
            if self._opcode_fmt[d.opcode] != d.fmt:
                raise IsaError(
                    f"{d.name}: opcode {d.opcode} already bound to format "
                    f"{self._opcode_fmt[d.opcode]}")
            if d.funct is None:
                raise IsaError(
                    f"{d.name}: opcode {d.opcode} shared but no fixed funct")
        key = (d.opcode, d.funct)
        if key in self._by_code:
            raise IsaError(f"{d.name}: opcode/funct collision with "
                           f"{self._by_code[key].name}")
        self._by_name[d.name] = d
        self._by_code[key] = d
        self._opcode_fmt[d.opcode] = d.fmt
        self._index[d.name] = len(self._index)
        return d

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    # -- dense numbering / decode tables -------------------------------------

    @property
    def n_ops(self) -> int:
        return len(self._index)

    def op_id(self, name: str) -> int:
        """Dense instruction id (registration order, 0..n_ops-1)."""
        try:
            return self._index[name]
        except KeyError:
            raise IsaError(f"unknown instruction {name!r}") from None

    @property
    def op_index(self) -> Dict[str, int]:
        """name -> dense id map (a copy; ids are registration order)."""
        return dict(self._index)

    def op_names(self) -> List[str]:
        """Dense-id -> name table (index i holds the name of op id i)."""
        return list(self._index)

    def __getitem__(self, name: str) -> InstrDescriptor:
        try:
            return self._by_name[name]
        except KeyError:
            raise IsaError(f"unknown instruction {name!r}") from None

    @property
    def descriptors(self) -> List[InstrDescriptor]:
        return list(self._by_name.values())

    def pack_streams(self, streams: Sequence[Sequence[Instr]]
                     ) -> Tuple[np.ndarray, Dict[str, np.ndarray],
                                np.ndarray]:
        """Pack several instruction streams into one SoA table.

        Returns ``(op, args, offs)`` where ``op``/``args`` cover the
        concatenation of all streams and ``offs[k]`` is stream *k*'s
        start (``offs[-1]`` = total length).  Extraction is grouped per
        (op, operand) from each op's descriptor: one gather per pair
        instead of a per-instruction dict walk.
        """
        from itertools import chain
        from operator import attrgetter, itemgetter
        sizes = [len(s) for s in streams]
        n = int(sum(sizes))
        offs = np.zeros(len(sizes) + 1, dtype=np.int64)
        np.cumsum(sizes, out=offs[1:])
        index = self._index
        flat = list(chain.from_iterable(streams))
        op = np.fromiter(map(index.__getitem__, map(attrgetter("op"),
                                                    flat)),
                         dtype=np.int32, count=n)  # KeyError -> unknown
        argdicts = list(map(attrgetter("args"), flat))
        names = list(self._index)
        cols: Dict[str, np.ndarray] = {}
        present = np.flatnonzero(np.bincount(op, minlength=len(names)))
        for oid in present.tolist():
            nm = names[oid]
            cols_of = tuple(self._by_name[nm].operands)
            if not cols_of:
                continue
            pos = np.flatnonzero(op == oid)
            rows = list(map(argdicts.__getitem__, pos.tolist()))
            try:
                if len(cols_of) == 1:
                    vals = (list(map(itemgetter(cols_of[0]), rows)),)
                else:
                    vals = list(zip(*map(itemgetter(*cols_of), rows)))
            except KeyError:              # operand omitted somewhere
                vals = [[r.get(k, 0) for r in rows] for k in cols_of]
            for k, v in zip(cols_of, vals):
                c = cols.get(k)
                if c is None:
                    c = cols[k] = np.zeros(n, dtype=np.int64)
                c[pos] = v
        return op, cols, offs

    def instr(self, op: str, **args: int) -> Instr:
        """Build + validate a symbolic instruction."""
        d = self[op]
        unknown = set(args) - set(d.operands)
        if unknown:
            raise IsaError(f"{op}: unknown operands {sorted(unknown)}")
        return Instr(op, dict(args))

    # -- binary encoding ------------------------------------------------------

    def encode(self, ins: Instr) -> int:
        d = self[ins.op]
        fields = _check_format(d.fmt)
        values = {name: 0 for name, _ in fields}
        values["opcode"] = d.opcode
        if d.funct is not None:
            values["funct"] = d.funct
        for sem, enc in d.operands.items():
            values[enc] = ins.args.get(sem, 0)
        word = 0
        for fname, width in fields:
            v = int(values[fname])
            lo, hi = 0, (1 << width) - 1
            if fname in _SIGNED_FIELDS:
                lo = -(1 << (width - 1))
                hi = (1 << (width - 1)) - 1
                if not lo <= v <= hi:
                    raise IsaError(
                        f"{ins.op}: field {fname}={v} out of signed range")
                v &= (1 << width) - 1
            elif not lo <= v <= hi:
                raise IsaError(f"{ins.op}: field {fname}={v} exceeds "
                               f"{width} bits")
            word = (word << width) | v
        return word

    def decode(self, word: int) -> Instr:
        if not 0 <= word < (1 << 32):
            raise IsaError("instruction word out of 32-bit range")
        opcode = (word >> 26) & 0x3F
        fmt = self._opcode_fmt.get(opcode)
        if fmt is None:
            raise IsaError(f"unknown opcode {opcode}")
        fields = _check_format(fmt)
        values: Dict[str, int] = {}
        shift = 32
        for fname, width in fields:
            shift -= width
            v = (word >> shift) & ((1 << width) - 1)
            if fname in _SIGNED_FIELDS and v >= (1 << (width - 1)):
                v -= 1 << width
            values[fname] = v
        funct = values.get("funct")
        d = self._by_code.get((opcode, funct)) or self._by_code.get(
            (opcode, None))
        if d is None:
            raise IsaError(f"unknown opcode/funct ({opcode}, {funct})")
        args = {}
        for sem, enc in d.operands.items():
            args[sem] = values[enc]
        return Instr(d.name, args)


@dataclass
class PackedProgram:
    """Structure-of-arrays view of a :class:`Program`.

    ``op`` holds dense instruction ids (:meth:`Isa.op_id`); ``args`` maps
    each semantic operand name appearing anywhere in the stream to an
    int64 column (0 where an instruction lacks the operand).  This is the
    decode-once table the vectorized perf simulator replays — numpy
    gather/compare over columns instead of per-``Instr`` dict traffic.
    """

    op: np.ndarray                       # (n,) int32 dense op ids
    args: Dict[str, np.ndarray]          # operand name -> (n,) int64
    core_id: int = 0

    def __len__(self) -> int:
        return int(self.op.size)

    def col(self, name: str) -> np.ndarray:
        """Operand column (a shared zeros column if never present)."""
        got = self.args.get(name)
        if got is None:
            got = np.zeros(self.op.size, dtype=np.int64)
            self.args[name] = got
        return got


@dataclass
class Program:
    """An instruction stream for one core."""

    instrs: List[Instr] = field(default_factory=list)
    core_id: int = 0
    labels: Dict[str, int] = field(default_factory=dict)

    def append(self, ins: Instr) -> int:
        self.instrs.append(ins)
        return len(self.instrs) - 1

    def extend(self, more: Iterable[Instr]) -> None:
        self.instrs.extend(more)

    def __len__(self) -> int:
        return len(self.instrs)

    def __iter__(self):
        return iter(self.instrs)

    def encode(self, isa: "Isa") -> np.ndarray:
        return np.array([isa.encode(i) for i in self.instrs], dtype=np.uint32)

    def invalidate_pack(self) -> None:
        """Drop the memoized :meth:`pack` table.

        ``append``/``extend`` are covered by the cache's length check;
        call this after replacing an instruction *in place*
        (``prog.instrs[i] = ...``) so the vectorized simulator cannot
        replay a stale table.
        """
        self.__dict__.pop("_packed", None)

    def pack(self, isa: "Isa") -> PackedProgram:
        """Decode the stream into :class:`PackedProgram` column arrays.

        The result is memoized per ``Isa`` (invalidated by length
        changes; see :meth:`invalidate_pack` for in-place edits) —
        codegen ships every emitted program with its table, and the
        simulator, the equivalence tests and any analysis pass share
        that one decode.
        """
        cached = getattr(self, "_packed", None)
        if cached is not None and cached[0] is isa \
                and cached[2] == len(self.instrs):
            return cached[1]
        op, cols, _ = isa.pack_streams([self.instrs])
        packed = PackedProgram(op=op, args=cols, core_id=self.core_id)
        self._packed = (isa, packed, len(self.instrs))
        return packed

    def disassemble(self, isa: "Isa") -> str:
        lines = []
        rev_labels = {v: k for k, v in self.labels.items()}
        for pc, ins in enumerate(self.instrs):
            if pc in rev_labels:
                lines.append(f"{rev_labels[pc]}:")
            lines.append(f"  {pc:5d}: {ins!r}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Default instruction set
# ---------------------------------------------------------------------------

# Vector functionality specifier codes (shared V_OP opcode).
VFUNCT: Dict[str, int] = {
    "add": 0, "sub": 1, "mul": 2, "mac": 3, "max": 4, "min": 5,
    "relu": 6, "shl": 7, "shr": 8, "quant": 9, "dequant": 10,
    "mov": 11, "reduce_sum": 12, "reduce_max": 13,
    "sigmoid": 14, "silu": 15, "gelu": 16, "tanh": 17, "exp": 18,
    "maxpool": 19, "avgpool": 20, "addi": 21, "muli": 22, "recip": 23,
    "rsqrt": 24, "abs": 25, "clip": 26,
    "zero": 27,     # write VLEN zeros (with V_REP/VSEG_D segments)
    "sum8": 28,     # int32 dst[i] += int8 a[i] (GAP accumulation)
    # row-segment transformer ops: VLEN = segment length, V_REP = rows
    # (int8 in/out; integer semantics in repro_torch.core.vecsem)
    "softmax": 29,
    "layernorm": 30,
}

# Scalar ALU functs (shared S_ALU opcode).
SALU_FUNCT: Dict[str, int] = {
    "add": 0, "sub": 1, "mul": 2, "and": 3, "or": 4, "xor": 5,
    "slt": 6, "sll": 7, "srl": 8,
}

# Special-purpose register map (S_Reg file). Operation-specific state:
SREG: Dict[str, int] = {
    "VLEN": 0,          # vector length for V_OP
    "MG_MASK_LO": 1,    # active macro-group bitmap (low 16)
    "MG_MASK_HI": 2,
    "ACT_BITS": 3,      # bit-serial activation precision
    "Q_SCALE": 4,       # requant multiplier (fixed-point)
    "Q_SHIFT": 5,       # requant shift
    "Q_ZERO": 6,        # requant zero point
    "ACC_DIV": 7,       # requant pre-divisor (GAP mean folding); 0/1 = off
    "CLUSTER": 8,       # multicast cluster id for BCAST
    "VSTRIDE_D": 9,     # vector dst stride (elements)
    "VSTRIDE_A": 10,    # vector src-a stride
    "VSTRIDE_B": 11,    # vector src-b stride
    "POOL_W": 12,       # pooling window
    "POOL_S": 13,       # pooling stride
    # per-repetition segment advances (bytes) for V_REP'd vector ops
    "VSEG_D": 14,
    "VSEG_A": 15,
    "VSEG_B": 16,
    "V_REP": 17,        # vector-op repetition count (0/1 = single)
    # CIM macro-group addressing, latched by CIM_LOAD
    "MG_SEL": 18,       # target macro group for the next CIM_LOAD
    "MG_KOFF": 19,      # input-vector offset (elements) of the MG's k-slice
    "MG_NOFF": 20,      # output-channel offset of the MG's n-slice
    # CIM_MVM per-repetition address advances (bytes)
    "MVM_SEG_IN": 21,
    "MVM_SEG_OUT": 22,
    "MG_NLEN": 23,      # output channels of the MG being CIM_LOADed
    # virtual-channel id for SEND/RECV rendezvous: multiple logical
    # streams between one core pair stay order-independent (NoC message
    # tags / virtual channels)
    "CHANNEL": 24,
}

# Execution flag bits (R-format `flags` field).
FLAGS: Dict[str, int] = {
    "acc": 1 << 0,      # CIM_MVM: accumulate into dst instead of overwrite
    "relu": 1 << 1,     # fused relu on vector op result
    "i8": 1 << 2,       # operate on int8 data (default int32)
}


def default_isa() -> Isa:
    """Build the CIMFlow v1 instruction set."""
    isa = Isa()
    R = lambda **kw: isa.register(InstrDescriptor(**kw))  # noqa: E731

    # ---- CIM compute ------------------------------------------------------
    R(name="CIM_MVM", opcode=0, fmt="C", unit="cim",
      operands={"dst": "rd", "src": "rs1", "rep": "imm10", "acc": "funct"},
      latency_class="cim_mvm", energy_class="cim_mvm",
      description="Bit-serial MVM on the MGs selected by S_Reg[MG_MASK]; "
                  "reads activations at G[src], writes (acc&1: accumulates) "
                  "INT32 partial sums to G[dst]; rep = consecutive input "
                  "vectors, advancing by S_Reg[MVM_SEG_IN/OUT] bytes.")
    R(name="CIM_LOAD", opcode=1, fmt="C", unit="cim",
      operands={"mg": "rd", "src": "rs1", "rows": "imm10"},
      latency_class="cim_load", energy_class="cim_load",
      description="Load weight rows from local memory into macro group mg.")
    R(name="CIM_CFG", opcode=2, fmt="I", unit="cim",
      operands={"sreg": "rd", "imm": "imm16"},
      latency_class="alu", energy_class="scalar_alu",
      description="Write immediate to special register (CIM/vector config).")
    R(name="CIM_CFGR", opcode=3, fmt="R", unit="cim",
      operands={"sreg": "rd", "src": "rs1"},
      latency_class="alu", energy_class="scalar_alu",
      description="Write G_Reg value to special register.")

    # ---- Vector compute ---------------------------------------------------
    for vname, f in VFUNCT.items():
        R(name=f"V_{vname.upper()}", opcode=8, fmt="R", unit="vector",
          operands={"dst": "rd", "a": "rs1", "b": "rs2"},
          funct=f,
          latency_class=("vec_special" if vname in
                         ("sigmoid", "silu", "gelu", "tanh", "exp",
                          "recip", "rsqrt", "softmax", "layernorm")
                         else "vec_mul" if vname in ("mul", "mac", "muli",
                                                     "dequant", "quant")
                         else "vec_alu"),
          energy_class="vector_mul" if vname in ("mul", "mac", "muli")
                       else "vector_alu",
          description=f"Vector {vname} over S_Reg[VLEN] elements.")
    R(name="V_SETVL", opcode=9, fmt="I", unit="vector",
      operands={"len": "imm16"},
      latency_class="alu", energy_class="scalar_alu",
      description="Set vector length (elements).")

    # ---- Scalar compute ---------------------------------------------------
    for sname, f in SALU_FUNCT.items():
        R(name=f"S_{sname.upper()}", opcode=16, fmt="R", unit="scalar",
          operands={"dst": "rd", "a": "rs1", "b": "rs2"}, funct=f,
          latency_class="mul" if sname == "mul" else "alu",
          energy_class="scalar_alu",
          description=f"Scalar {sname}.")
    R(name="S_ADDI", opcode=17, fmt="I", unit="scalar",
      operands={"dst": "rd", "a": "rs1", "imm": "imm16"},
      latency_class="alu", energy_class="scalar_alu",
      description="dst = a + sign-extended imm16.")
    R(name="S_LUI", opcode=18, fmt="I", unit="scalar",
      operands={"dst": "rd", "imm": "imm16"},
      latency_class="alu", energy_class="scalar_alu",
      description="dst = imm16 << 16.")
    R(name="S_LD", opcode=19, fmt="I", unit="scalar",
      operands={"dst": "rd", "base": "rs1", "off": "imm16"},
      latency_class="mem", energy_class="lmem_read",
      description="Scalar load word from local memory.")
    R(name="S_ST", opcode=20, fmt="I", unit="scalar",
      operands={"src": "rd", "base": "rs1", "off": "imm16"},
      latency_class="mem", energy_class="lmem_write",
      description="Scalar store word to local memory.")

    # ---- Control flow -----------------------------------------------------
    R(name="BEQ", opcode=24, fmt="I", unit="control",
      operands={"a": "rd", "b": "rs1", "off": "imm16"},
      latency_class="branch", energy_class="scalar_alu",
      description="Branch to pc+off if G[a] == G[b].")
    R(name="BNE", opcode=25, fmt="I", unit="control",
      operands={"a": "rd", "b": "rs1", "off": "imm16"},
      latency_class="branch", energy_class="scalar_alu",
      description="Branch if not equal.")
    R(name="BLT", opcode=26, fmt="I", unit="control",
      operands={"a": "rd", "b": "rs1", "off": "imm16"},
      latency_class="branch", energy_class="scalar_alu",
      description="Branch if less-than (signed).")
    R(name="JAL", opcode=27, fmt="J", unit="control",
      operands={"off": "imm26"},
      latency_class="branch", energy_class="scalar_alu",
      description="Jump relative; link register is G[31].")
    R(name="HALT", opcode=28, fmt="J", unit="control",
      operands={},
      latency_class="alu", energy_class="scalar_alu",
      description="Stop the core.")
    R(name="NOP", opcode=29, fmt="J", unit="control", operands={},
      latency_class="alu", energy_class="scalar_alu",
      description="No operation.")

    # ---- Communication ----------------------------------------------------
    R(name="SEND", opcode=32, fmt="R", unit="noc",
      operands={"core": "rd", "src": "rs1", "size": "rs2"},
      latency_class="noc", energy_class="noc_flit",
      description="Send size bytes from local[G[src]] to core G[core]; "
                  "blocks until accepted by the NoC.")
    R(name="RECV", opcode=33, fmt="R", unit="noc",
      operands={"dst": "rd", "core": "rs1", "size": "rs2"},
      latency_class="noc", energy_class="noc_flit",
      description="Receive size bytes from core G[core] into local[G[dst]].")
    R(name="BCAST", opcode=34, fmt="R", unit="noc",
      operands={"src": "rs1", "size": "rs2"},
      latency_class="noc", energy_class="noc_flit",
      description="Multicast to the cluster in S_Reg[CLUSTER].")
    R(name="SYNC", opcode=35, fmt="I", unit="noc",
      operands={"barrier": "imm16"},
      latency_class="sync", energy_class="scalar_alu",
      description="Block until all cores of the barrier group arrive.")
    R(name="GLD", opcode=36, fmt="R", unit="noc",
      operands={"dst": "rd", "gaddr": "rs1", "size": "rs2"},
      latency_class="gmem", energy_class="gmem_read",
      description="Load size bytes from global memory to local[G[dst]].")
    R(name="GST", opcode=37, fmt="R", unit="noc",
      operands={"src": "rd", "gaddr": "rs1", "size": "rs2"},
      latency_class="gmem", energy_class="gmem_write",
      description="Store size bytes from local[G[src]] to global memory.")

    return isa
