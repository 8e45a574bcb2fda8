"""Cycle-accurate simulator + functional ISS (paper §III-D).

Host code: a copy of :mod:`repro.core.simulator` (the JAX package), kept
identical so the port's results equal the reference's; the
port imports nothing of ``repro``.

Models the chip at instruction granularity:

* **Core pipeline** — in-order single-issue IF/DE (1 cycle/instr) feeding
  per-unit execution pipelines (CIM / vector / scalar / NoC); units are
  decoupled (double-buffered staging), so a core's steady-state interval is
  the *max* of its unit loads, matching the compiler's cost model.  RECV /
  SYNC / blocking sends are hard synchronization points.
* **NoC** — 2-D mesh, XY routing, wormhole-style link reservation: every
  directed link a flit stream crosses is occupied for ``flits`` cycles;
  contention emerges from link ``free_at`` times.  Per-hop router latency.
* **Global memory** — ``ports`` concurrent streams at
  ``global_mem_bytes_per_cycle`` each; transfers pick the earliest-free
  port (bandwidth contention across cores).
* **Energy** — every instruction deposits events into the same ledger the
  analytic model uses (:mod:`repro_torch.core.energy` prices them).
* **Functional mode** (``mode="func"``) — additionally executes full data
  semantics: int8 local memories, macro-group weight arrays, INT32 MVM
  accumulation, requantization, strided vector ops, real SEND/RECV payloads
  and the global-memory image.  This is the ISS used to validate compiled
  programs bit-exactly against the INT8 oracle.

The simulator executes each *stage*'s programs to completion (all cores
HALT) and sums stage makespans — the sequential-stage execution model the
partitioner optimizes for.

Perf mode runs on the pre-decoded block-replay engine by default, with
each stage's decode as tensor code on the card
(:mod:`repro_torch.core.torchsim`, on CUDA unless the caller names a
``device``): programs decode once into per-instruction tables, basic
blocks replay as unit-run sums (:mod:`repro_torch.core.vectorsim`), and
only the shared-state instructions (SEND / RECV / GLD / GST / SYNC /
HALT) execute through the scheduler — cycle-, event- and busy-identical
to this interpreter at a fraction of the wall time.  The ``engine``
parameter pins a path explicitly (``"vector"`` and ``"scalar"`` are the
numpy host engines); functional mode always interprets.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from . import vecsem, vectorsim
from .arch import ChipConfig
from .codegen import GMEM_BASE, CompiledModel, StageProgram
from .energy import DEFAULT_TABLE, EnergyTable, energy_breakdown
from .isa import FLAGS, Instr, Isa, Program, SREG, VFUNCT
from .machine import MachineModel, machine_for

__all__ = ["Simulator", "SimReport", "SimError", "ENGINES"]

# Perf-mode execution engines: "torch" runs the decode's dataflow/
# latency passes as tensor code on the simulator's device (see
# :mod:`repro_torch.core.torchsim`) and falls back to the interpreter,
# per stage, for programs outside the decodable subset; "auto" (the
# default) is "torch"; "vector" replays pre-decoded basic blocks on the
# numpy host engine (see :mod:`repro_torch.core.vectorsim`) and refuses
# the fallback; "scalar" interprets one instruction at a time.  All are
# bit-identical.  ``mode="func"`` always interprets (data semantics are
# inherently per-instruction) and reads "auto" as "scalar".
ENGINES = ("auto", "vector", "scalar", "torch")


class SimError(RuntimeError):
    pass


class Deadlock(SimError):
    pass


@dataclass
class SimReport:
    cycles: float
    stage_cycles: List[float]
    events: Dict[str, float]
    unit_busy: Dict[str, float]           # unit -> total busy cycles
    instrs: int
    gmem: Optional[np.ndarray] = None     # functional mode: final image
    # pricing table the machine model attached (shared across fidelities)
    table: EnergyTable = DEFAULT_TABLE

    def energy(self, table: Optional[EnergyTable] = None
               ) -> Dict[str, float]:
        return energy_breakdown(self.events, table or self.table)

    def utilization(self, chip: ChipConfig) -> Dict[str, float]:
        denom = self.cycles * chip.n_cores
        return {u: b / denom for u, b in sorted(self.unit_busy.items())}

    def summary(self) -> str:
        e = self.energy()
        return (f"{self.cycles:.0f} cycles, {self.instrs} instrs, "
                f"{e['total'] / 1e6:.3f} mJ "
                f"(compute {100 * e['compute'] / e['total']:.0f}%, "
                f"noc {100 * e['noc'] / e['total']:.0f}%, "
                f"gmem {100 * e['gmem'] / e['total']:.0f}%, "
                f"static {100 * e['static'] / e['total']:.0f}%)")


# ---------------------------------------------------------------------------
# Per-core state
# ---------------------------------------------------------------------------


@dataclass
class _MgState:
    w: Optional[np.ndarray]     # (rows, n_len) int8, functional mode only
    rows: int
    n_len: int
    k_off: int
    n_off: int


class _Core:
    def __init__(self, core_id: int, prog: Program, chip: ChipConfig,
                 func: bool) -> None:
        self.id = core_id
        self.prog = prog
        self.pc = 0
        self.time = 0.0
        self.halted = False
        self.blocked = False
        self.gregs = np.zeros(32, dtype=np.int64)
        self.sregs = np.zeros(64, dtype=np.int64)
        self.sregs[SREG["ACC_DIV"]] = 1
        self.unit_free: Dict[str, float] = {}
        self.mgs: Dict[int, _MgState] = {}
        # functional-mode local memory is allocated lazily on first
        # access: a core whose program never loads/stores (or a wide
        # chip's mostly-idle cores) pays nothing
        self._func = func
        self._lmem_bytes = chip.core.local_mem.size_bytes
        self._lmem: Optional[np.ndarray] = None

    @property
    def lmem(self) -> Optional[np.ndarray]:
        if self._lmem is None and self._func:
            self._lmem = np.zeros(self._lmem_bytes, dtype=np.int8)
        return self._lmem

    def sreg(self, name: str) -> int:
        return int(self.sregs[SREG[name]])


# ---------------------------------------------------------------------------
# Simulator
# ---------------------------------------------------------------------------


class Simulator:
    def __init__(self, chip: ChipConfig, isa: Isa, mode: str = "perf",
                 max_cycles: float = 5e9, engine: str = "auto",
                 faults: Optional[object] = None,
                 device: Union[str, torch.device, None] = None) -> None:
        if mode not in ("perf", "func"):
            raise ValueError(mode)
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, "
                             f"got {engine!r}")
        if engine in ("vector", "torch") and mode == "func":
            raise ValueError("functional mode requires the scalar "
                             "engine (engine='auto' or 'scalar')")
        self.chip = chip
        # the one source of timing/bandwidth/energy rules — shared with
        # the analytic cost model and the trace fidelity
        self.m: MachineModel = machine_for(chip)
        self.isa = isa
        self.func = mode == "func"
        if engine == "auto":
            engine = "scalar" if self.func else "torch"
        self.engine = engine
        self.max_cycles = max_cycles
        # where engine="torch" runs its stage passes: CUDA unless the
        # caller names a device (raises without a card); unused by the
        # host engines
        self.device = resolve_device(device) if engine == "torch" else None
        # physical CIM-array fault injection (functional mode): any
        # object with corrupt_loaded(core_id, mg, w) -> w'.  None =
        # fault-free (exact no-op; perf-mode timing never depends on
        # it).
        self.faults = faults
        self._vfunct_names = {v: k for k, v in VFUNCT.items()}

    # -- public API ------------------------------------------------------------

    def run_model(self, model: CompiledModel,
                  gmem_image: Optional[np.ndarray] = None) -> SimReport:
        if self.func and gmem_image is None:
            raise SimError("functional mode requires a gmem image")
        gmem = None
        if gmem_image is not None:
            gmem = np.zeros(model.layout.size, dtype=np.int8)
            gmem[:gmem_image.size] = gmem_image
        events: Dict[str, float] = {}
        busy: Dict[str, float] = {}
        stage_cycles: List[float] = []
        instrs = 0
        vectorize = not self.func and self.engine != "scalar"
        if self.engine == "torch":
            from . import torchsim
            stage_fn = torchsim.run_stage
        else:
            stage_fn = vectorsim.run_stage
        for sp in model.stages:
            out = stage_fn(self, sp) if vectorize else None
            if out is None:
                if self.engine == "vector":
                    raise SimError(
                        "engine='vector': stage program is not "
                        "statically decodable (branches / scalar-ALU "
                        "register chains / custom ops)")
                out = self._run_stage(sp, gmem)
            c, ev, bz, n = out
            stage_cycles.append(c)
            instrs += n
            for k, v in ev.items():
                events[k] = events.get(k, 0.0) + v
            for k, v in bz.items():
                busy[k] = busy.get(k, 0.0) + v
        total = float(sum(stage_cycles))
        events["static_core_cycles"] = total * self.chip.n_cores
        return SimReport(cycles=total, stage_cycles=stage_cycles,
                         events=events, unit_busy=busy, instrs=instrs,
                         gmem=gmem, table=self.m.energy_table)

    # -- stage loop --------------------------------------------------------------

    def _run_stage(self, sp: StageProgram, gmem: Optional[np.ndarray]):
        chip = self.chip
        cores = {cid: _Core(cid, prog, chip, self.func)
                 for cid, prog in sp.programs.items()}
        self._gmem = gmem
        self._events: Dict[str, float] = {}
        self._busy: Dict[str, float] = {}
        self._instrs = 0
        # NoC / gmem shared state
        self._links: Dict[Tuple[int, int], float] = {}
        self._ports = [0.0] * self.m.gmem_ports
        self._chan: Dict[Tuple[int, int], deque] = {}
        self._barriers: Dict[int, List[_Core]] = {}

        pending = [c for c in cores.values() if len(c.prog) > 0]
        while True:
            ready = [c for c in pending if not c.halted and not c.blocked]
            if not ready:
                if all(c.halted for c in pending):
                    break
                blocked = [c.id for c in pending if c.blocked]
                raise Deadlock(f"cores {blocked} blocked "
                               f"(recv/sync with no sender)")
            core = min(ready, key=lambda c: c.time)
            self._step(core, cores)
            if core.time > self.max_cycles:
                raise SimError("max_cycles exceeded")
        makespan = max((c.time for c in cores.values()), default=0.0)
        return makespan, self._events, self._busy, self._instrs

    # -- helpers -----------------------------------------------------------------

    def _ev(self, key: str, amount: float) -> None:
        self._events[key] = self._events.get(key, 0.0) + amount

    # NOTE: _use/_route_delay/_gmem_xfer have line-for-line ports in
    # repro_torch.core.vectorsim (boundary handlers) — keep them in sync or
    # the engines diverge on shapes outside the pinned goldens.
    def _use(self, core: _Core, unit: str, latency: float) -> float:
        """Issue on a unit: in-order issue, decoupled unit pipelines."""
        t_issue = max(core.time + 1.0, core.unit_free.get(unit, 0.0))
        core.unit_free[unit] = t_issue + latency
        self._busy[unit] = self._busy.get(unit, 0.0) + latency
        core.time = t_issue
        return t_issue + latency

    def _sync(self, core: _Core, t: float) -> None:
        core.time = max(core.time, t)

    def _route_delay(self, src: int, dst: int, nbytes: int,
                     t_start: float) -> float:
        """Wormhole transfer: reserve each link on the XY route."""
        m = self.m
        occupy = m.link_occupancy_cycles(nbytes)
        t = t_start + m.inject_cycles
        if src == dst:
            return t + occupy
        for link in m.route(src, dst):
            t = max(t, self._links.get(link, 0.0)) + m.router_hop_cycles
            self._links[link] = t + occupy
        self._ev("noc_byte_hops", nbytes * m.hops(src, dst))
        return t + occupy

    def _gmem_xfer(self, nbytes: int, t_start: float) -> float:
        """Pick earliest-free gmem port."""
        i = min(range(len(self._ports)), key=lambda j: self._ports[j])
        t0 = max(t_start, self._ports[i])
        t1 = t0 + self.m.gmem_stream_cycles(nbytes, ports=1)
        self._ports[i] = t1
        self._ev("gmem_bytes", nbytes)
        return t1

    # -- instruction dispatch ------------------------------------------------------

    def _step(self, core: _Core, cores: Dict[int, "_Core"]) -> None:
        if core.pc >= len(core.prog):
            core.halted = True
            return
        ins = core.prog.instrs[core.pc]
        self._instrs += 1
        d = self.isa[ins.op]
        name, unit = ins.op, d.unit
        a = ins.args
        G, S = core.gregs, core.sregs

        if name == "HALT":
            core.pc += 1
            core.time += 1
            core.halted = True
            return
        if name == "NOP":
            core.pc += 1
            self._use(core, "scalar", 1)
            return

        # ---- scalar / control -------------------------------------------------
        if name == "S_ADDI":
            self._use(core, "scalar", self.m.scalar_alu_cycles)
            if a["dst"]:
                G[a["dst"]] = G[a["a"]] + a["imm"]
        elif name == "S_LUI":
            self._use(core, "scalar", self.m.scalar_alu_cycles)
            if a["dst"]:
                G[a["dst"]] = (a["imm"] & 0xFFFF) << 16
        elif name.startswith("S_") and name not in ("S_LD", "S_ST"):
            self._use(core, "scalar",
                      self.m.scalar_mul_cycles if name == "S_MUL"
                      else self.m.scalar_alu_cycles)
            if a.get("dst"):
                x, y = int(G[a["a"]]), int(G[a["b"]])
                G[a["dst"]] = {
                    "S_ADD": x + y, "S_SUB": x - y, "S_MUL": x * y,
                    "S_AND": x & y, "S_OR": x | y, "S_XOR": x ^ y,
                    "S_SLT": int(x < y), "S_SLL": x << (y & 31),
                    "S_SRL": (x & 0xFFFFFFFF) >> (y & 31),
                }[name]
        elif name in ("S_LD", "S_ST"):
            self._use(core, "scalar", self.m.scalar_ldst_cycles)
            if self.func:
                addr = int(G[a["base"]]) + a["off"]
                lm32 = core.lmem.view(np.int32)
                if name == "S_LD":
                    G[a["dst"]] = int(lm32[addr // 4])
                else:
                    lm32[addr // 4] = np.int32(G[a["src"]])
            self._ev("lmem_bytes", 4)
        elif name in ("BEQ", "BNE", "BLT"):
            x, y = int(G[a["a"]]), int(G[a["b"]])
            taken = {"BEQ": x == y, "BNE": x != y, "BLT": x < y}[name]
            self._use(core, "scalar", self.m.branch_cycles(taken))
            if taken:
                core.pc += a["off"]
                return
        elif name == "JAL":
            self._use(core, "scalar", self.m.branch_cycles(True))
            G[31] = core.pc + 1
            core.pc += a["off"]
            return

        # ---- CIM config -----------------------------------------------------------
        elif name == "CIM_CFG":
            self._use(core, "scalar", 1)
            S[a["sreg"]] = a["imm"]
        elif name == "CIM_CFGR":
            self._use(core, "scalar", 1)
            S[a["sreg"]] = G[a["src"]]

        # ---- CIM compute ------------------------------------------------------------
        elif name == "CIM_LOAD":
            rows = a["rows"]
            n_len = core.sreg("MG_NLEN")
            self._use(core, "cim", self.m.weight_load_cycles(rows))
            self._ev("cim_weight_load_bytes", rows * max(n_len, 1))
            self._ev("lmem_bytes", rows * max(n_len, 1))
            w = None
            if self.func:
                src = int(G[a["src"]])
                w = core.lmem[src:src + rows * n_len] \
                    .reshape(rows, n_len).copy()
                if self.faults is not None:
                    # the array's stuck bits corrupt whatever the
                    # compiler latches into it
                    w = self.faults.corrupt_loaded(core.id, a["mg"], w)
            core.mgs[a["mg"]] = _MgState(
                w=w, rows=rows, n_len=n_len,
                k_off=core.sreg("MG_KOFF"), n_off=core.sreg("MG_NOFF"))
        elif name == "CIM_MVM":
            rep = a["rep"]
            mask = (core.sreg("MG_MASK_LO") & 0xFFFF) \
                | (core.sreg("MG_MASK_HI") << 16)
            active = [core.mgs[i] for i in core.mgs if mask & (1 << i)]
            self._use(core, "cim", self.m.mvm_cycles(rep))
            seg_in = core.sreg("MVM_SEG_IN")
            seg_out = core.sreg("MVM_SEG_OUT")
            self._ev("cim_macro_passes",
                     rep * len(active) * self.m.macros_per_group)
            self._ev("lmem_bytes", rep * (seg_in + seg_out))
            if self.func and active:
                src, dst = int(G[a["src"]]), int(G[a["dst"]])
                lm = core.lmem
                lm32 = lm.view(np.int32)
                for t in range(rep):
                    obase = dst + t * seg_out
                    oview = lm32[obase // 4: obase // 4 + seg_out // 4]
                    if not (a.get("acc", 0) & 1):
                        oview[:] = 0
                    ibase = src + t * seg_in
                    for mg in active:
                        x = lm[ibase + mg.k_off: ibase + mg.k_off
                               + mg.rows].astype(np.int32)
                        y = x @ mg.w.astype(np.int32)
                        oview[mg.n_off: mg.n_off + mg.n_len] += y

        # ---- vector ---------------------------------------------------------------
        elif unit == "vector":
            self._exec_vector(core, ins)

        # ---- communication ----------------------------------------------------------
        elif name == "SEND":
            dst_core = int(G[a["core"]])
            src = int(G[a["src"]])
            size = int(G[a["size"]])
            stream = core.sreg("CHANNEL")
            done = self._use(core, "noc", self.m.send_issue_cycles(size))
            arrival = self._route_delay(core.id, dst_core, size, done)
            data = None
            if self.func:
                data = core.lmem[src:src + size].copy()
            self._chan.setdefault((core.id, dst_core, stream),
                                  deque()).append((arrival, size, data))
            self._ev("lmem_bytes", size)
            self._unblock(cores.get(dst_core))
        elif name == "RECV":
            src_core = int(G[a["core"]])
            dst = int(G[a["dst"]])
            size = int(G[a["size"]])
            stream = core.sreg("CHANNEL")
            q = self._chan.get((src_core, core.id, stream))
            if not q:
                core.blocked = True
                return                       # retry when a SEND arrives
            arrival, msize, data = q.popleft()
            if msize != size:
                raise SimError(
                    f"recv size mismatch {src_core}->{core.id}"
                    f"#{stream}: expected {size}, got {msize}")
            self._sync(core, arrival)
            self._use(core, "noc", self.m.send_issue_cycles(size))
            if self.func:
                core.lmem[dst:dst + size] = data
            self._ev("lmem_bytes", size)
        elif name == "BCAST":
            size = int(G[a["size"]])
            self._use(core, "noc", self.m.send_issue_cycles(size))
        elif name == "SYNC":
            bid = a["barrier"]
            group = self._barriers.setdefault(bid, [])
            if core not in group:
                group.append(core)
            n_need = len([c for c in cores.values()])
            if len(group) < n_need:
                core.blocked = True
                return
            t = max(c.time for c in group) + 1
            for c in group:
                c.time = t
                c.blocked = False
                if c is not core:
                    c.pc += 1
            self._barriers[bid] = []
        elif name == "GLD":
            gaddr = int(G[a["gaddr"]])
            dst = int(G[a["dst"]])
            size = int(G[a["size"]])
            done = self._gmem_xfer(size, core.time + 1)
            self._use(core, "noc", max(1.0, done - core.time - 1))
            self._ev("lmem_bytes", size)
            if self.func:
                off = gaddr - GMEM_BASE
                core.lmem[dst:dst + size] = self._gmem[off:off + size]
        elif name == "GST":
            gaddr = int(G[a["gaddr"]])
            src = int(G[a["src"]])
            size = int(G[a["size"]])
            done = self._gmem_xfer(size, core.time + 1)
            self._use(core, "noc", max(1.0, done - core.time - 1))
            self._ev("lmem_bytes", size)
            if self.func:
                off = gaddr - GMEM_BASE
                self._gmem[off:off + size] = core.lmem[src:src + size]
        else:
            raise SimError(f"unhandled instruction {name}")

        core.pc += 1

    def _unblock(self, core: Optional[_Core]) -> None:
        if core is not None and core.blocked:
            core.blocked = False

    # -- vector execution ----------------------------------------------------------

    def _exec_vector(self, core: _Core, ins: Instr) -> None:
        name = ins.op
        if name == "V_SETVL":
            self._use(core, "scalar", 1)
            core.sregs[SREG["VLEN"]] = ins.args["len"]
            return
        fn = name[2:].lower()
        vlen = max(1, core.sreg("VLEN"))
        rep = max(1, core.sreg("V_REP"))
        n = vlen * rep
        self._use(core, "vector", self.m.vector_cycles(fn, n))
        self._ev("vector_elems", n)
        flags = ins.args.get("flags", 0)
        i8 = bool(flags & FLAGS["i8"])
        esz = 1 if i8 else 4
        self._ev("lmem_bytes", n * esz * 2)
        if not self.func:
            return

        G, S = core.gregs, core.sregs
        lm = core.lmem
        dst, a_, b_ = int(G[ins.args["dst"]]), int(G[ins.args["a"]]), \
            int(G[ins.args["b"]])
        sd, sa, sb = core.sreg("VSEG_D"), core.sreg("VSEG_A"), \
            core.sreg("VSEG_B")
        td, ta, tb = max(1, core.sreg("VSTRIDE_D")), \
            max(1, core.sreg("VSTRIDE_A")), max(1, core.sreg("VSTRIDE_B"))

        lane = np.arange(vlen, dtype=np.int64)
        reps = np.arange(rep, dtype=np.int64)

        def idx(base: int, seg: int, stride: int, sz: int) -> np.ndarray:
            # element indices for (rep, vlen), in elements of ``sz`` bytes
            return ((base + reps[:, None] * seg) // sz
                    + lane[None, :] * stride)

        if fn == "zero":
            view = lm if i8 else lm.view(np.int32)
            view[idx(dst, sd, td, esz)] = 0
            return

        if fn == "quant":
            # int32 src -> int8 dst
            x = lm.view(np.int32)[idx(a_, sa, ta, 4)].astype(np.int64)
            scale = core.sreg("Q_SCALE")
            shift = core.sreg("Q_SHIFT")
            div = max(1, core.sreg("ACC_DIV"))
            zero = core.sreg("Q_ZERO")
            den = div << shift
            q = (x * scale + (den >> 1)) // den + zero
            lm[idx(dst, sd, td, 1)] = \
                np.clip(q, -128, 127).astype(np.int8)
            return
        if fn == "sum8":
            # int8 src accumulates into int32 dst
            acc = lm.view(np.int32)
            x = lm[idx(a_, sa, ta, 1)].astype(np.int32)
            di = idx(dst, sd, td, 4)
            if sd == 0 and td == 1:
                acc[di[0]] += x.sum(axis=0)
            else:
                for t in range(rep):
                    acc[di[t]] += x[t]
            return

        di = idx(dst, sd, td, esz)
        ai = idx(a_, sa, ta, esz)
        if fn == "mov":
            view = lm if i8 else lm.view(np.int32)
            view[di] = view[ai]
            return
        if fn == "relu":
            view = lm if i8 else lm.view(np.int32)
            view[di] = np.maximum(view[ai], 0)
            return
        if fn in ("softmax", "layernorm", "gelu"):
            # transformer tails: int8 row-segment semantics shared with
            # the oracle through repro_torch.core.vecsem (bit-exact contract)
            if not i8:
                raise SimError(f"functional mode: {fn} requires int8 "
                               f"operands")
            x = lm[ai]                       # (rep, vlen) row segments
            lm[di] = {"softmax": vecsem.softmax_i8,
                      "layernorm": vecsem.layernorm_i8,
                      "gelu": vecsem.gelu_i8}[fn](
                          torch.from_numpy(x)).numpy()
            return

        bi = idx(b_, sb, tb, esz)
        if i8:
            x = lm[ai].astype(np.int16)
            y = lm[bi].astype(np.int16)
        else:
            v32 = lm.view(np.int32)
            x = v32[ai].astype(np.int64)
            y = v32[bi].astype(np.int64)
        if fn == "add":
            z = x + y
        elif fn == "sub":
            z = x - y
        elif fn == "mul":
            z = x * y
        elif fn == "max":
            z = np.maximum(x, y)
        elif fn == "min":
            z = np.minimum(x, y)
        else:
            raise SimError(f"functional mode: vector op {fn!r} "
                           f"not implemented (perf-only LUT op)")
        if i8:
            lm[di] = np.clip(z, -128, 127).astype(np.int8)
        else:
            lm.view(np.int32)[di] = \
                np.clip(z, -2**31, 2**31 - 1).astype(np.int32)
