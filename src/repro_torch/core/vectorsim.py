"""Vectorized pre-decoded replay engine for the perf-mode simulator.

Host code: a copy of :mod:`repro.core.vectorsim` (the JAX package), kept
identical so the port's results equal the reference's; the
port imports nothing of ``repro``.

The scalar interpreter in :mod:`repro_torch.core.simulator` pays a Python
dispatch per instruction — ~10 µs each on the golden workloads — which
makes cycle-accurate ground-truthing the bottleneck of every calibrated
DSE run.  This module removes that cost for ``mode="perf"`` without
changing a single reported number:

* **Decode once** — every core's :class:`~repro_torch.core.isa.Program` is
  packed into structure-of-arrays columns (:meth:`Program.pack`) and the
  whole stage is *statically executed* in one batch of numpy passes over
  the concatenated instruction stream: in perf mode no instruction reads
  simulated data (``S_LD`` does not write back), so every G_Reg/S_Reg
  value, macro-group occupancy mask, per-instruction unit and
  :class:`~repro_torch.core.machine.MachineModel` latency is known at decode
  time from the immediate stream alone (segmented cumulative sums for
  register dataflow, ``searchsorted`` timelines for register reads,
  cumulative OR for MG occupancy, batched latency lookups).
* **Basic blocks** — each stream splits at the instructions that touch
  *shared* state (SEND / RECV / GLD / GST / SYNC / HALT).  Everything
  between two such points is core-local, so its event-ledger and
  unit-busy contributions are summed at decode time, and its timing
  collapses to a short list of *unit runs*: consecutive instructions on
  one execution unit advance the in-order issue clock by
  ``max(1, latency)`` each, so a run replays as one addition of a
  precomputed cumulative sum.
* **Replay** — the runtime loop schedules *blocks and boundary ops*
  instead of instructions, with exactly the scalar interpreter's
  pick-order (earliest core time, program-dict order on ties).  Shared
  NoC-link / gmem-port / channel / barrier state is only ever mutated
  by boundary handlers that are line-for-line ports of the scalar ones,
  so link reservations and port picks happen in the identical global
  order and the replay is cycle- and event-identical.

Exactness note: block replay re-associates float additions only through
pre-summed run/ledger constants.  Every latency the default and swept
chips produce is a dyadic rational (integer latencies, power-of-two
bandwidth divisors), for which float addition is exact in any order; a
chip configured with non-power-of-two divisors could in principle
differ from the scalar path in the last ulp.

Branches and scalar-ALU register chains are *statically resolved*: in
perf mode no instruction writes a register from simulated data (S_LD
does not write back), so the register file — and with it every branch
condition and loop bound — is a pure function of the immediate stream.
Such programs are unrolled at decode time by a scalar pre-execution
(:meth:`StageDecoder.unroll_decode`) into the same block/boundary
replay items the vectorized path produces.  Only custom instructions
and unrolls beyond the cap fall back to the scalar interpreter per
stage; ``mode="func"`` always uses it (bit-exact data semantics are
inherently per-instruction).

The replay loop schedules cores through an event heap keyed on
``(core time, program order)`` — identical pick order to the scalar
interpreter's linear min-scan, O(log n_cores) per item.
"""

from __future__ import annotations

import heapq
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .isa import Isa, Program, SREG
from .machine import MachineModel

__all__ = ["StageDecoder", "DecodeUnsupported", "run_stage"]


class DecodeUnsupported(Exception):
    """Program uses features outside the static perf-decode subset."""


# execution-unit numbering shared by decode tables and replay state
UNITS = ("scalar", "vector", "cim", "noc")
_SCALAR, _VECTOR, _CIM, _NOC = range(4)

# instruction kinds; everything >= _K_SEND is a shared-state boundary
_K_CONST, _K_VEC, _K_MVM, _K_WLOAD, _K_BCAST = range(5)
_K_SEND, _K_RECV, _K_GLD, _K_GST, _K_SYNC, _K_HALT = range(5, 11)
_K_UNSUP = 11

# runtime item tags (boundary tags reuse the kind ids)
_BLOCK, _END = 100, 101

# event-ledger keys whose totals are decode-time constants
_EV_KEYS = ("lmem_bytes", "cim_weight_load_bytes", "cim_macro_passes",
            "vector_elems")

_S_VLEN = SREG["VLEN"]
_S_VREP = SREG["V_REP"]
_S_CHANNEL = SREG["CHANNEL"]
_S_MASK_LO = SREG["MG_MASK_LO"]
_S_MASK_HI = SREG["MG_MASK_HI"]
_S_SEG_IN = SREG["MVM_SEG_IN"]
_S_SEG_OUT = SREG["MVM_SEG_OUT"]
_S_NLEN = SREG["MG_NLEN"]
_I8_FLAG = 1 << 2                      # FLAGS["i8"]


class _DecodedStage:
    """One stage's pre-decoded replay plan + static ledger totals."""

    __slots__ = ("items", "n_prog", "busy", "unit_used", "events",
                 "ev_present", "n_static")

    def __init__(self) -> None:
        self.items: Dict[int, List[tuple]] = {}   # core -> replay items
        self.n_prog: Dict[int, int] = {}          # core -> program length
        self.busy = [0.0] * 4                     # block-op busy cycles
        self.unit_used = [False] * 4
        self.events = [0.0] * 4                   # _EV_KEYS totals
        self.ev_present = [False] * 4
        self.n_static = 0                         # block-op instructions


class _Prep:
    """Machine-independent front half of a stage decode.

    Holds the concatenated, dead-code-filtered instruction columns of
    every *batchable* program of a stage, plus the lists of empty and
    unroll-needed programs.  Produced by :meth:`StageDecoder._prep` and
    consumed by both the numpy passes (:meth:`StageDecoder.decode_stage`)
    and the torch engine (:mod:`repro_torch.core.torchsim`), which share it so a
    fleet evaluation preps each stage exactly once.
    """

    __slots__ = ("cids", "packs", "sizes", "offs", "op", "kind", "pid",
                 "starts", "n", "n_prog", "empty", "unroll",
                 "_colcache", "_live", "_all_live", "_zeros")

    def __init__(self) -> None:
        self.cids: List[int] = []
        self.packs: List[Any] = []
        self.n_prog: Dict[int, int] = {}
        self.empty: List[int] = []
        self.unroll: List[Tuple[int, Program]] = []
        self.n = 0
        self._colcache: Dict[str, np.ndarray] = {}
        self._zeros: Optional[np.ndarray] = None

    def col(self, name: str) -> np.ndarray:
        """Concatenated operand column (zeros where ops lack it)."""
        c = self._colcache.get(name)
        if c is None:
            if self._zeros is None:
                self._zeros = np.zeros(self.n, dtype=np.int64)
            parts = [p.args.get(name) for p in self.packs]
            if not any(x is not None for x in parts):
                c = self._zeros
            else:
                c = (parts[0] if len(self.packs) == 1
                     else np.concatenate(
                         [x if x is not None
                          else np.zeros(s, dtype=np.int64)
                          for x, s in zip(parts, self.sizes.tolist())]))
                if not self._all_live:
                    c = c[self._live]
            self._colcache[name] = c
        return c


def _finish_decode(out: _DecodedStage, pr: _Prep, unit: np.ndarray,
                   lat: np.ndarray, bitems: Dict[int, tuple],
                   ev_tot: List[float], ev_cnt: List[int]) -> None:
    """Back half of a stage decode, shared by the numpy and torch paths.

    From the per-instruction latencies and resolved boundary items,
    collapse each program into unit runs + boundary replay items and
    accumulate the static busy / event / instruction totals into
    ``out``.  Everything here is plain numpy over ``pr``'s columns, so
    both engines produce byte-identical replay plans given identical
    ``lat`` / ``bitems``.
    """
    kind, pid, offs = pr.kind, pr.pid, pr.offs
    cids, n = pr.cids, pr.n
    bmask = kind >= _K_SEND
    bound_pos = np.flatnonzero(bmask)
    for p in np.flatnonzero(kind == _K_HALT).tolist():
        bitems[p] = (_K_HALT,)

    # ---- unit runs --------------------------------------------------
    nb = ~bmask
    run_start = nb.copy()
    run_start[1:] &= (unit[1:] != unit[:-1]) | bmask[:-1]
    run_start[offs[:-1]] = nb[offs[:-1]]         # break at core boundary
    rs = np.flatnonzero(run_start)
    mstep = np.maximum(1.0, lat)
    mstep[bmask] = 0.0
    if len(rs):
        marks = np.flatnonzero(run_start | bmask)
        mext = np.append(marks, n)
        ends = mext[np.searchsorted(marks, rs, side="right")] - 1
        run_A = np.add.reduceat(mstep, rs) - mstep[ends]
        runs = list(zip(unit[rs].tolist(), run_A.tolist(),
                        lat[ends].tolist()))
    else:
        runs = []

    # ---- static stage totals ----------------------------------------
    lat_nb = np.where(bmask, 0.0, lat)
    busy = np.bincount(unit, weights=lat_nb, minlength=4)
    cnt = np.bincount(unit[nb], minlength=4)
    for u in range(4):
        out.busy[u] += float(busy[u])
        out.unit_used[u] = out.unit_used[u] or bool(cnt[u])
    for k in range(4):
        out.events[k] += ev_tot[k]
        out.ev_present[k] = out.ev_present[k] or ev_cnt[k] > 0
    out.n_static += int(nb.sum())

    # ---- assemble per-core replay items -----------------------------
    # all run-index lookups batched: for each boundary, the block
    # before it spans runs [kp, kb); per-program tails span [kt, kh)
    nb_b = len(bound_pos)
    prange = np.arange(len(pr.packs))
    b_by_pid = pid[bound_pos]
    b_first = np.searchsorted(b_by_pid, prange, side="left")
    b_last = np.searchsorted(b_by_pid, prange, side="right")
    prev_pos = np.empty(nb_b, dtype=np.int64)
    if nb_b:
        prev_pos[0] = offs[b_by_pid[0]]
        same = b_by_pid[1:] == b_by_pid[:-1]
        prev_pos[1:] = np.where(same, bound_pos[:-1] + 1,
                                offs[b_by_pid[1:]])
    kb = np.searchsorted(rs, bound_pos).tolist()
    kp = np.searchsorted(rs, prev_pos).tolist()
    tail_pos = np.where(b_last > b_first,
                        bound_pos[np.maximum(b_last - 1, 0)] + 1
                        if nb_b else offs[:-1],
                        offs[:-1][prange])
    kt = np.searchsorted(rs, tail_pos).tolist()
    kh = np.searchsorted(rs, offs[1:]).tolist()
    bp_list = bound_pos.tolist()
    for p, cid in enumerate(cids):
        items: List[tuple] = []
        hi = int(offs[p + 1])
        b0, b1 = int(b_first[p]), int(b_last[p])
        for i in range(b0, b1):
            if kb[i] > kp[i]:
                items.append((_BLOCK, runs[kp[i]:kb[i]]))
            items.append(bitems[bp_list[i]])
        if kh[p] > kt[p]:
            items.append((_BLOCK, runs[kt[p]:kh[p]]))
        if not (b1 > b0 and bitems[bp_list[b1 - 1]][0] == _K_HALT
                and bp_list[b1 - 1] == hi - 1):
            items.append((_END,))
        out.items[cid] = items


class StageDecoder:
    """Decode tables for one (Isa, MachineModel) pair.

    Built once per :class:`~repro_torch.core.simulator.Simulator`; holds dense
    per-op-id kind / unit / constant-latency / vector-class tables so
    :meth:`decode_stage` is a fixed number of numpy passes over the
    stage's concatenated program columns, independent of core count.
    """

    def __init__(self, isa: Isa, m: MachineModel) -> None:
        self.isa = isa
        self.m = m
        n = isa.n_ops
        self.kind = np.full(n, _K_UNSUP, dtype=np.int8)
        self.unit = np.zeros(n, dtype=np.int8)
        self.clat = np.zeros(n, dtype=np.float64)
        self.vcls = np.zeros(n, dtype=np.int8)
        oid = isa.op_index

        const = {
            "NOP": 1.0, "CIM_CFG": 1.0, "CIM_CFGR": 1.0, "V_SETVL": 1.0,
            "S_ADDI": float(m.scalar_alu_cycles),
            "S_LUI": float(m.scalar_alu_cycles),
            "S_LD": float(m.scalar_ldst_cycles),
            "S_ST": float(m.scalar_ldst_cycles),
        }
        bound = {"SEND": _K_SEND, "RECV": _K_RECV, "GLD": _K_GLD,
                 "GST": _K_GST, "SYNC": _K_SYNC, "HALT": _K_HALT}
        for d in isa.descriptors:
            i = oid[d.name]
            if d.name in const:
                self.kind[i] = _K_CONST
                self.unit[i] = _SCALAR
                self.clat[i] = const[d.name]
            elif d.name in bound:
                self.kind[i] = bound[d.name]
            elif d.name == "CIM_MVM":
                self.kind[i], self.unit[i] = _K_MVM, _CIM
            elif d.name == "CIM_LOAD":
                self.kind[i], self.unit[i] = _K_WLOAD, _CIM
            elif d.name == "BCAST":
                self.kind[i], self.unit[i] = _K_BCAST, _NOC
            elif d.unit == "vector":
                self.kind[i], self.unit[i] = _K_VEC, _VECTOR
                self.vcls[i] = m.vector_class(d.name[2:].lower())
            # anything else (scalar ALU chains, branches, custom ops)
            # stays _K_UNSUP -> scalar-interpreter fallback
        g = lambda nm: oid.get(nm, -1)            # noqa: E731
        self.id_addi, self.id_lui = g("S_ADDI"), g("S_LUI")
        self.id_cfg, self.id_cfgr = g("CIM_CFG"), g("CIM_CFGR")
        self.id_setvl = g("V_SETVL")
        self.id_sld, self.id_sst = g("S_LD"), g("S_ST")
        self._vector_ops = {d.name for d in isa.descriptors
                            if d.unit == "vector" and d.name != "V_SETVL"}

    # -- decode-time unrolling (branches / scalar-ALU chains) ---------------

    _SALU = {
        "S_ADD": lambda x, y: x + y, "S_SUB": lambda x, y: x - y,
        "S_MUL": lambda x, y: x * y, "S_AND": lambda x, y: x & y,
        "S_OR": lambda x, y: x | y, "S_XOR": lambda x, y: x ^ y,
        "S_SLT": lambda x, y: int(x < y),
        "S_SLL": lambda x, y: x << (y & 31),
        "S_SRL": lambda x, y: (x & 0xFFFFFFFF) >> (y & 31),
    }
    UNROLL_CAP = 1_000_000

    def _needs_unroll(self, pk) -> bool:
        """True when the live range holds control flow / S_ALU chains —
        interpretable at decode time but outside the vectorized batch."""
        op = pk.op
        kind = self.kind[op]
        h = np.flatnonzero(kind == _K_HALT)
        end = int(h[0]) + 1 if len(h) else len(op)
        if bool((kind[:end] == _K_UNSUP).any()):
            return True
        dst = pk.args.get("dst")
        acol = pk.args.get("a")
        if dst is None or acol is None:
            return False
        addi = op[:end] == self.id_addi
        return bool((addi & (dst[:end] != 0) & (acol[:end] != 0)
                     & (acol[:end] != dst[:end])).any())

    def unroll_decode(self, program: Program, cid: int,
                      out: "_DecodedStage") -> None:
        """Scalar pre-execution of one program at decode time.

        Perf mode's register file is fully static (no instruction
        writes a register from simulated data), so branches and scalar
        ALU chains resolve here: the walked pc trace collapses into the
        same block/boundary replay items — and identical busy / event /
        instruction totals — the vectorized path produces.  Raises
        :class:`DecodeUnsupported` for instructions even this path
        cannot execute (custom ops) or when the unrolled trace exceeds
        :data:`UNROLL_CAP`.
        """
        m = self.m
        instrs = program.instrs
        n = len(instrs)
        G = [0] * 32
        S = [0] * 64
        occ = 0                               # MG occupancy mask
        items: List[tuple] = []
        runs: List[tuple] = []
        cur: List[float] = []
        cur_u = -1
        busy = [0.0] * 4
        used = [False] * 4
        ev = [0.0] * 4
        evp = [False] * 4
        n_static = 0
        halted = False

        def close_run() -> None:
            nonlocal cur
            if cur:
                A = 0.0
                for lat in cur[:-1]:
                    A += lat if lat > 1.0 else 1.0
                runs.append((cur_u, A, cur[-1]))
                cur = []

        def emit(u: int, lat: float) -> None:
            nonlocal cur_u, n_static
            if u != cur_u:
                close_run()
                cur_u = u
            cur.append(float(lat))
            busy[u] += lat
            used[u] = True
            n_static += 1

        def boundary(item: tuple) -> None:
            nonlocal cur_u
            close_run()
            cur_u = -1
            if runs:
                items.append((_BLOCK, list(runs)))
                runs.clear()
            items.append(item)

        pc = 0
        steps = 0
        while pc < n:
            steps += 1
            if steps > self.UNROLL_CAP:
                raise DecodeUnsupported(
                    f"core {cid}: unrolled trace exceeds "
                    f"{self.UNROLL_CAP} instructions")
            ins = instrs[pc]
            name = ins.op
            a = ins.args
            if name == "HALT":
                boundary((_K_HALT,))
                halted = True
                break
            if name == "NOP":
                emit(_SCALAR, 1.0)
            elif name == "S_ADDI":
                emit(_SCALAR, m.scalar_alu_cycles)
                if a["dst"]:
                    G[a["dst"]] = G[a["a"]] + a["imm"]
            elif name == "S_LUI":
                emit(_SCALAR, m.scalar_alu_cycles)
                if a["dst"]:
                    G[a["dst"]] = (a["imm"] & 0xFFFF) << 16
            elif name in self._SALU:
                emit(_SCALAR, m.scalar_mul_cycles if name == "S_MUL"
                     else m.scalar_alu_cycles)
                if a.get("dst"):
                    G[a["dst"]] = self._SALU[name](G[a["a"]], G[a["b"]])
            elif name in ("S_LD", "S_ST"):
                emit(_SCALAR, m.scalar_ldst_cycles)
                ev[0] += 4.0
                evp[0] = True
            elif name in ("BEQ", "BNE", "BLT"):
                x, y = G[a["a"]], G[a["b"]]
                taken = {"BEQ": x == y, "BNE": x != y,
                         "BLT": x < y}[name]
                emit(_SCALAR, m.branch_cycles(taken))
                if taken:
                    pc += a["off"]
                    continue
            elif name == "JAL":
                emit(_SCALAR, m.branch_cycles(True))
                G[31] = pc + 1
                pc += a["off"]
                continue
            elif name == "CIM_CFG":
                emit(_SCALAR, 1.0)
                S[a["sreg"]] = a["imm"]
            elif name == "CIM_CFGR":
                emit(_SCALAR, 1.0)
                S[a["sreg"]] = G[a["src"]]
            elif name == "CIM_LOAD":
                rows = a["rows"]
                emit(_CIM, m.weight_load_cycles(rows))
                wl = rows * max(S[_S_NLEN], 1)
                ev[0] += wl
                ev[1] += wl
                evp[0] = evp[1] = True
                occ |= 1 << a["mg"]
            elif name == "CIM_MVM":
                rep = a["rep"]
                emit(_CIM, m.mvm_cycles(rep))
                mask = (S[_S_MASK_LO] & 0xFFFF) | (S[_S_MASK_HI] << 16)
                active = bin(occ & mask).count("1")
                ev[2] += rep * active * m.macros_per_group
                ev[0] += rep * (S[_S_SEG_IN] + S[_S_SEG_OUT])
                evp[0] = evp[2] = True
            elif name == "V_SETVL":
                emit(_SCALAR, 1.0)
                S[_S_VLEN] = a["len"]
            elif name == "BCAST":
                emit(_NOC, m.send_issue_cycles(int(G[a["size"]])))
            elif name in self._vector_ops:
                fn = name[2:].lower()
                nel = max(1, S[_S_VLEN]) * max(1, S[_S_VREP])
                emit(_VECTOR, m.vector_cycles(fn, nel))
                esz = 1 if (a.get("flags", 0) & _I8_FLAG) else 4
                ev[3] += nel
                ev[0] += nel * esz * 2
                evp[0] = evp[3] = True
            elif name == "SEND":
                boundary((_K_SEND, int(G[a["core"]]), int(G[a["size"]]),
                          S[_S_CHANNEL]))
            elif name == "RECV":
                boundary((_K_RECV, int(G[a["core"]]), int(G[a["size"]]),
                          S[_S_CHANNEL]))
            elif name == "GLD":
                boundary((_K_GLD, int(G[a["size"]])))
            elif name == "GST":
                boundary((_K_GST, int(G[a["size"]])))
            elif name == "SYNC":
                boundary((_K_SYNC, a["barrier"]))
            else:
                raise DecodeUnsupported(
                    f"core {cid}: instruction {name!r}")
            pc += 1
        if not halted:
            close_run()
            if runs:
                items.append((_BLOCK, list(runs)))
                runs.clear()
            items.append((_END,))
        out.items[cid] = items
        for u in range(4):
            out.busy[u] += busy[u]
            out.unit_used[u] = out.unit_used[u] or used[u]
            out.events[u] += ev[u]
            out.ev_present[u] = out.ev_present[u] or evp[u]
        out.n_static += n_static

    # -- dataflow helpers ---------------------------------------------------

    @staticmethod
    def _group(key: np.ndarray, pos: np.ndarray, *vals: np.ndarray
               ) -> Dict[int, Tuple[np.ndarray, ...]]:
        """Split (pos, *vals) into per-key slices (pos stays sorted)."""
        out: Dict[int, Tuple[np.ndarray, ...]] = {}
        if not len(pos):
            return out
        order = np.lexsort((pos, key))       # by key, position-sorted
        key_s = key[order]
        first = np.ones(len(key_s), dtype=bool)
        first[1:] = key_s[1:] != key_s[:-1]
        starts = np.flatnonzero(first)
        ends = np.append(starts[1:], len(key_s))
        cols = (pos[order],) + tuple(v[order] for v in vals)
        for s, e in zip(starts.tolist(), ends.tolist()):
            out[int(key_s[s])] = tuple(c[s:e] for c in cols)
        return out

    def _timeline(self, wmap, key: int, pos: np.ndarray,
                  start: np.ndarray) -> np.ndarray:
        """Value of per-core timeline ``key`` just before positions
        ``pos`` (``start`` = each position's program start, so a read
        never observes another core's writes)."""
        out = np.zeros(pos.shape, dtype=np.int64)
        got = wmap.get(int(key))
        if got is None or not len(pos):
            return out
        wp, wv = got
        j = np.searchsorted(wp, pos, side="left")
        has = j > 0
        jj = j[has] - 1
        ok = wp[jj] >= start[has]
        sel = np.flatnonzero(has)[ok]
        out[sel] = wv[jj[ok]]
        return out

    def _resolve_gregs(self, gmap, regs: np.ndarray, pos: np.ndarray,
                       start: np.ndarray) -> np.ndarray:
        """G_Reg values ``G[regs[i]]`` just before positions ``pos``."""
        out = np.zeros(len(pos), dtype=np.int64)
        for r, (p, s) in self._group(regs, pos, start).items():
            if r == 0:
                continue
            idx = np.searchsorted(pos, p)        # positions are unique
            out[idx] = self._timeline(gmap, r, p, s)
        return out

    # -- decode -------------------------------------------------------------

    def _prep(self, programs: Dict[int, Program]) -> "_Prep":
        """Shared front half of decode: pack, split off empty/unrolled
        programs, drop dead code, and concatenate the batchable columns.

        Machine-independent — the numpy passes below and the torch engine
        (:mod:`repro_torch.core.torchsim`) both start from the same `_Prep`.
        Raises :class:`DecodeUnsupported` for live instructions outside
        the batchable subset.
        """
        pr = _Prep()
        cids = pr.cids
        packs = pr.packs
        for cid, prog in programs.items():
            pr.n_prog[cid] = len(prog)
            if len(prog) == 0:
                pr.empty.append(cid)
                continue
            try:
                # cache hit when codegen shipped the table with the
                # program; handwritten programs pack here once
                pk = prog.pack(self.isa)
            except KeyError as e:            # op not in the ISA at all
                raise DecodeUnsupported(
                    f"unknown instruction {e}") from e
            if self._needs_unroll(pk):
                # control flow / scalar-ALU chains: statically resolved
                # by decode-time scalar pre-execution (perf mode's
                # register file never depends on simulated data)
                pr.unroll.append((cid, prog))
            else:
                cids.append(cid)
                packs.append(pk)
        if not cids:
            return pr

        sizes = np.array([p.op.size for p in packs], dtype=np.int64)
        offs = np.zeros(len(packs) + 1, dtype=np.int64)
        np.cumsum(sizes, out=offs[1:])
        op = (packs[0].op if len(packs) == 1
              else np.concatenate([p.op for p in packs]))
        kind = self.kind[op]

        # ---- drop dead code (straight-line: nothing runs past HALT) ----
        pid = np.repeat(np.arange(len(packs)), sizes)
        hpos = np.flatnonzero(kind == _K_HALT)
        n_eff = sizes.copy()
        if len(hpos):
            hpid = pid[hpos]
            p_first, i_first = np.unique(hpid, return_index=True)
            n_eff[p_first] = hpos[i_first] - offs[p_first] + 1
        live_end = offs[:-1] + n_eff
        live = np.arange(offs[-1]) < live_end[pid]
        all_live = bool(live.all())
        if not all_live:
            op, kind, pid = op[live], kind[live], pid[live]
            offs = np.zeros(len(packs) + 1, dtype=np.int64)
            np.cumsum(n_eff, out=offs[1:])
        n = int(offs[-1])

        if (kind == _K_UNSUP).any():
            bad = int(np.flatnonzero(kind == _K_UNSUP)[0])
            p = int(pid[bad])
            raise DecodeUnsupported(
                f"core {cids[p]}: instruction "
                f"{programs[cids[p]].instrs[bad - int(offs[p])].op!r}")

        pr.sizes, pr.offs = sizes, offs
        pr.op, pr.kind, pr.pid = op, kind, pid
        pr.starts = offs[:-1][pid]               # program start of each pc
        pr.n = n
        pr._live, pr._all_live = live, all_live

        is_addi = op == self.id_addi
        dst, a_col = pr.col("dst"), pr.col("a")
        bad = is_addi & (dst != 0) & (a_col != 0) & (a_col != dst)
        if bad.any():
            raise DecodeUnsupported("S_ADDI with cross-register source")
        return pr

    def decode_stage(self, programs: Dict[int, Program]) -> _DecodedStage:
        """Statically execute all of a stage's programs in one batch.

        Raises :class:`DecodeUnsupported` when any live instruction is
        outside the subset (the caller falls back to the interpreter).
        """
        out = _DecodedStage()
        pr = self._prep(programs)
        out.n_prog = pr.n_prog
        for cid in pr.empty:
            out.items[cid] = [(_END,)]
        for cid, prog in pr.unroll:
            self.unroll_decode(prog, cid, out)
        if not pr.cids:
            return out

        op, kind, pid = pr.op, pr.kind, pr.pid
        starts, col = pr.starts, pr.col

        m = self.m
        unit = self.unit[op]
        lat = self.clat[op].copy()
        ev_tot = [0.0] * 4
        ev_cnt = [0] * 4

        # ---- G_Reg dataflow (emitter idiom: LUI / ADDI-from-0/self) ----
        dst, a_col, imm = col("dst"), col("a"), col("imm")
        is_lui = op == self.id_lui
        is_addi = op == self.id_addi
        wpos = np.flatnonzero((is_lui | is_addi) & (dst != 0))
        gmap: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        if len(wpos):
            reg = dst[wpos]
            lui = is_lui[wpos]
            w_imm = imm[wpos]
            base_val = np.where(lui, (w_imm & 0xFFFF) << 16, w_imm)
            incr = ~lui & (a_col[wpos] == reg)    # ADDI dst, dst, imm
            order = np.lexsort((wpos, reg))
            reg_s, pos_s = reg[order], wpos[order]
            first = np.ones(len(reg_s), dtype=bool)
            # a chain resets at a load-immediate, at the register's first
            # write, and at a program (core) boundary
            first[1:] = ((reg_s[1:] != reg_s[:-1])
                         | (pid[pos_s[1:]] != pid[pos_s[:-1]]))
            reset = ~incr[order] | first
            contrib = np.where(reset, base_val[order], w_imm[order])
            cs = np.cumsum(contrib)
            rpos = np.flatnonzero(reset)
            seg = np.cumsum(reset) - 1
            val_s = cs - (cs[rpos] - contrib[rpos])[seg]
            gstarts = np.flatnonzero(
                np.concatenate([[True], reg_s[1:] != reg_s[:-1]]))
            gends = np.append(gstarts[1:], len(reg_s))
            for s, e in zip(gstarts.tolist(), gends.tolist()):
                gmap[int(reg_s[s])] = (pos_s[s:e], val_s[s:e])

        # ---- S_Reg dataflow (CIM_CFG / CIM_CFGR / V_SETVL) -------------
        cfg = np.flatnonzero(op == self.id_cfg)
        cfgr = np.flatnonzero(op == self.id_cfgr)
        setvl = np.flatnonzero(op == self.id_setvl)
        sreg_col = col("sreg")
        spos = np.concatenate([cfg, cfgr, setvl])
        sidx = np.concatenate([sreg_col[cfg], sreg_col[cfgr],
                               np.full(len(setvl), _S_VLEN,
                                       dtype=np.int64)])
        sval = np.concatenate([
            imm[cfg],
            self._resolve_gregs(gmap, col("src")[cfgr], cfgr,
                                starts[cfgr]),
            col("len")[setvl]])
        smap = {k: (p, v) for k, (p, v)
                in self._group(sidx, spos, sval).items()}

        # ---- S_LD / S_ST ledger traffic (4 B words) --------------------
        mem = np.flatnonzero((op == self.id_sld) | (op == self.id_sst))
        ev_tot[0] += 4.0 * len(mem)
        ev_cnt[0] += len(mem)

        # ---- vector ops: n = max(1, VLEN) * max(1, V_REP) --------------
        vpos = np.flatnonzero(kind == _K_VEC)
        if len(vpos):
            vstart = starts[vpos]
            vlen = self._timeline(smap, _S_VLEN, vpos, vstart)
            vrep = self._timeline(smap, _S_VREP, vpos, vstart)
            n_el = np.maximum(vlen, 1) * np.maximum(vrep, 1)
            lat[vpos] = m.vector_cycles_array(self.vcls[op[vpos]], n_el)
            esz = np.where(col("flags")[vpos] & _I8_FLAG, 1, 4)
            ev_tot[0] += float((n_el * esz * 2).sum())
            ev_tot[3] += float(n_el.sum())
            ev_cnt[0] += len(vpos)
            ev_cnt[3] += len(vpos)

        # ---- CIM_LOAD: rows latency, rows * MG_NLEN ledger -------------
        lpos = np.flatnonzero(kind == _K_WLOAD)
        if len(lpos):
            rows = col("rows")[lpos]
            lat[lpos] = m.weight_load_cycles_array(rows)
            nlen = np.maximum(
                self._timeline(smap, _S_NLEN, lpos, starts[lpos]), 1)
            wl = float((rows * nlen).sum())
            ev_tot[0] += wl
            ev_tot[1] += wl
            ev_cnt[0] += len(lpos)
            ev_cnt[1] += len(lpos)

        # ---- CIM_MVM: rep latency, MG-occupancy macro passes -----------
        mpos = np.flatnonzero(kind == _K_MVM)
        if len(mpos):
            mstart = starts[mpos]
            rep = col("rep")[mpos]
            lat[mpos] = m.mvm_cycles_array(rep)
            mask = ((self._timeline(smap, _S_MASK_LO, mpos, mstart)
                     & 0xFFFF)
                    | (self._timeline(smap, _S_MASK_HI, mpos,
                                      mstart) << 16))
            loaded = np.zeros(len(mpos), dtype=np.int64)
            if len(lpos):
                bits = 1 << col("mg")[lpos]
                occ = np.empty(len(lpos), dtype=np.int64)
                lpid = pid[lpos]
                lstarts = np.flatnonzero(
                    np.concatenate([[True], lpid[1:] != lpid[:-1]]))
                lends = np.append(lstarts[1:], len(lpos))
                for s, e in zip(lstarts.tolist(), lends.tolist()):
                    occ[s:e] = np.bitwise_or.accumulate(bits[s:e])
                j = np.searchsorted(lpos, mpos, side="left")
                has = j > 0
                jj = j[has] - 1
                ok = lpos[jj] >= mstart[has]
                sel = np.flatnonzero(has)[ok]
                loaded[sel] = occ[jj[ok]]
            act = loaded & mask
            active = np.zeros(len(mpos), dtype=np.int64)
            for b in range(32):
                active += (act >> b) & 1
            ev_tot[2] += float((rep * active).sum() * m.macros_per_group)
            seg = (self._timeline(smap, _S_SEG_IN, mpos, mstart)
                   + self._timeline(smap, _S_SEG_OUT, mpos, mstart))
            ev_tot[0] += float((rep * seg).sum())
            ev_cnt[0] += len(mpos)
            ev_cnt[2] += len(mpos)

        # ---- BCAST: sender-side injection occupancy (core-local) -------
        bcast = np.flatnonzero(kind == _K_BCAST)
        if len(bcast):
            size = self._resolve_gregs(gmap, col("size")[bcast], bcast,
                                       starts[bcast])
            lat[bcast] = m.send_issue_cycles_array(size)

        # ---- boundary items --------------------------------------------
        bitems: Dict[int, tuple] = {}
        for tag in (_K_SEND, _K_RECV):
            kpos = np.flatnonzero(kind == tag)
            if not len(kpos):
                continue
            kstart = starts[kpos]
            peer = self._resolve_gregs(gmap, col("core")[kpos], kpos,
                                       kstart)
            size = self._resolve_gregs(gmap, col("size")[kpos], kpos,
                                       kstart)
            stream = self._timeline(smap, _S_CHANNEL, kpos, kstart)
            for p, c, s, st in zip(kpos.tolist(), peer.tolist(),
                                   size.tolist(), stream.tolist()):
                bitems[p] = (tag, c, s, st)
        for tag in (_K_GLD, _K_GST):
            kpos = np.flatnonzero(kind == tag)
            if len(kpos):
                size = self._resolve_gregs(gmap, col("size")[kpos], kpos,
                                           starts[kpos])
                for p, s in zip(kpos.tolist(), size.tolist()):
                    bitems[p] = (tag, s)
        sync = np.flatnonzero(kind == _K_SYNC)
        if len(sync):
            barrier = col("barrier")[sync]
            for p, b in zip(sync.tolist(), barrier.tolist()):
                bitems[p] = (_K_SYNC, b)

        _finish_decode(out, pr, unit, lat, bitems, ev_tot, ev_cnt)
        return out


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------


class _VCore:
    __slots__ = ("id", "items", "ip", "time", "F", "blocked", "halted",
                 "n_prog")

    def __init__(self, core_id: int, items: List[tuple],
                 n_prog: int) -> None:
        self.id = core_id
        self.items = items
        self.ip = 0
        self.time = 0.0
        self.F = [0.0, 0.0, 0.0, 0.0]       # per-unit free times
        self.blocked = False
        self.halted = False
        self.n_prog = n_prog


def run_stage(sim: Any, sp: Any) -> Optional[Tuple[float, Dict[str, float],
                                                   Dict[str, float], int]]:
    """Vectorized replay of one stage.

    Returns ``(makespan, events, busy, instrs)`` exactly as the scalar
    ``Simulator._run_stage`` would, or ``None`` when any program of the
    stage is outside the decodable subset.
    """
    dec = getattr(sim, "_vdecoder", None)
    if dec is None or dec.isa is not sim.isa:
        dec = sim._vdecoder = StageDecoder(sim.isa, sim.m)
    try:
        ds = dec.decode_stage(sp.programs)
    except DecodeUnsupported:
        return None
    return replay_stage(sim, sp, ds)


def replay_stage(sim: Any, sp: Any,
                 ds: _DecodedStage) -> Tuple[float, Dict[str, float],
                                             Dict[str, float], int]:
    """Replay one pre-decoded stage (shared by the numpy/torch engines).

    ``sim`` only needs ``.m`` and ``.max_cycles`` — the fleet evaluator
    passes a lightweight shim instead of a full ``Simulator``.
    """
    from .simulator import Deadlock, SimError     # late: avoid cycle
    m = sim.m
    max_cycles = sim.max_cycles
    cores = {cid: _VCore(cid, ds.items[cid], ds.n_prog[cid])
             for cid in sp.programs}
    pending = [c for c in cores.values() if c.n_prog > 0]

    # decode-time constants: block-op busy/ledger/instruction totals
    # (every block replays exactly once on any run that returns)
    events: Dict[str, float] = {}
    busy4 = list(ds.busy)
    used4 = list(ds.unit_used)
    instrs = ds.n_static
    for k in range(4):
        if ds.ev_present[k]:
            events[_EV_KEYS[k]] = ds.events[k]

    links: Dict[Tuple[int, int], float] = {}
    ports = [0.0] * m.gmem_ports
    chan: Dict[Tuple[int, int, int], deque] = {}
    barriers: Dict[int, List[_VCore]] = {}
    n_need = len(cores)

    def ev(key: str, amount: float) -> None:
        events[key] = events.get(key, 0.0) + amount

    # The three helpers below are line-for-line ports of
    # Simulator._use / _route_delay / _gmem_xfer: any change to NoC
    # arbitration, port policy or issue timing MUST be mirrored there
    # (the equivalence suite and the bench cycle gate pin the goldens,
    # but only shapes they cover).
    def use_noc(core: _VCore, latency: float) -> float:
        t_issue = core.time + 1.0
        if core.F[_NOC] > t_issue:
            t_issue = core.F[_NOC]
        core.F[_NOC] = t_issue + latency
        busy4[_NOC] += latency
        used4[_NOC] = True
        core.time = t_issue
        return t_issue + latency

    def route_delay(src: int, dst: int, nbytes: int,
                    t_start: float) -> float:
        occupy = m.link_occupancy_cycles(nbytes)
        t = t_start + m.inject_cycles
        if src == dst:
            return t + occupy
        for link in m.route(src, dst):
            t = max(t, links.get(link, 0.0)) + m.router_hop_cycles
            links[link] = t + occupy
        ev("noc_byte_hops", nbytes * m.hops(src, dst))
        return t + occupy

    # event heap keyed on (time, program order): pops exactly the core
    # the interpreter's linear min-scan would pick (earliest time, then
    # program-dict order on ties), at O(log n) per item — the linear
    # scan dominated replay wall time on 64+-core stages.  Invariant:
    # every runnable (non-halted, non-blocked) core sits in the heap
    # exactly once; blocked cores re-enter when a SEND/SYNC frees them.
    seq = {c.id: i for i, c in enumerate(pending)}
    heap: List[Tuple[float, int, _VCore]] = [
        (c.time, seq[c.id], c) for c in pending]
    heapq.heapify(heap)

    def wake(other: "_VCore") -> None:
        other.blocked = False
        heapq.heappush(heap, (other.time, seq[other.id], other))

    while heap:
        et, sq, core = heapq.heappop(heap)
        if core.halted:
            continue
        if et != core.time:
            # stale key (a SYNC release advanced this core's clock
            # while it sat in the heap): lazily re-key so pick order
            # stays exactly (current time, program order) — the scalar
            # interpreter's min-scan
            heapq.heappush(heap, (core.time, sq, core))
            continue
        item = core.items[core.ip]
        tag = item[0]

        if tag == _BLOCK:
            t = core.time
            F = core.F
            for u, A, L in item[1]:
                x = t + 1.0
                f = F[u]
                t = (f if f > x else x) + A
                F[u] = t + L
            core.time = t
            core.ip += 1
        elif tag == _K_SEND:
            instrs += 1
            _, dst, size, stream = item
            done = use_noc(core, m.send_issue_cycles(size))
            arrival = route_delay(core.id, dst, size, done)
            chan.setdefault((core.id, dst, stream),
                            deque()).append((arrival, size, None))
            ev("lmem_bytes", size)
            other = cores.get(dst)
            if other is not None and other.blocked:
                wake(other)
            core.ip += 1
        elif tag == _K_RECV:
            instrs += 1
            _, src, size, stream = item
            q = chan.get((src, core.id, stream))
            if not q:
                core.blocked = True          # retry when a SEND arrives
            else:
                arrival, msize, _data = q.popleft()
                if msize != size:
                    raise SimError(
                        f"recv size mismatch {src}->{core.id}"
                        f"#{stream}: expected {size}, got {msize}")
                if arrival > core.time:
                    core.time = arrival
                use_noc(core, m.send_issue_cycles(size))
                ev("lmem_bytes", size)
                core.ip += 1
        elif tag in (_K_GLD, _K_GST):
            instrs += 1
            size = item[1]
            t_start = core.time + 1
            i = min(range(len(ports)), key=ports.__getitem__)
            t0 = ports[i] if ports[i] > t_start else t_start
            done = t0 + m.gmem_stream_cycles(size, ports=1)
            ports[i] = done
            ev("gmem_bytes", size)
            use_noc(core, max(1.0, done - core.time - 1))
            ev("lmem_bytes", size)
            core.ip += 1
        elif tag == _K_SYNC:
            instrs += 1
            group = barriers.setdefault(item[1], [])
            if core not in group:
                group.append(core)
            if len(group) < n_need:
                core.blocked = True
            else:
                t = max(c.time for c in group) + 1
                for c in group:
                    c.time = t
                    c.ip += 1
                    if c is core:
                        c.blocked = False
                    elif c.blocked:
                        # a member spuriously woken by an earlier SEND
                        # already holds a heap ticket — don't double-push
                        wake(c)
                barriers[item[1]] = []
        elif tag == _K_HALT:
            instrs += 1
            core.time += 1
            core.halted = True
        else:                                  # _END
            core.halted = True
        if core.time > max_cycles:
            raise SimError("max_cycles exceeded")
        if not core.halted and not core.blocked:
            heapq.heappush(heap, (core.time, seq[core.id], core))

    if pending and not all(c.halted for c in pending):
        blocked = [c.id for c in pending if c.blocked]
        raise Deadlock(f"cores {blocked} blocked "
                       f"(recv/sync with no sender)")
    makespan = max((c.time for c in cores.values()), default=0.0)
    busy = {UNITS[u]: busy4[u] for u in range(4) if used4[u]}
    return makespan, events, busy, instrs
