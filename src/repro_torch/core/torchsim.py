"""Torch backend for the pre-decoded perf engine (``engine="torch"``).

Counterpart of :mod:`repro.core.jaxsim`, rewritten on tensors.
:mod:`repro_torch.core.vectorsim` reduces perf-mode decode to a fixed
set of array passes over a stage's concatenated instruction columns —
segmented cumulative sums for G_Reg/S_Reg dataflow, a segmented OR for
macro-group occupancy, and batched :class:`~repro_torch.core.machine.
MachineModel` latency lookups.  This module runs exactly those passes as
plain tensor code on the simulator's device (CUDA unless the caller
names another), with the machine's timing constants as *tensor inputs*:

* ``Simulator(engine="torch")`` — one machine.  The columns go up in
  one copy, the pass returns per-instruction latencies plus the
  resolved register / sreg / occupancy values, and they come back in
  two copies; the host then assembles replay items with the *identical
  numpy expressions* the numpy engine uses
  (:func:`vectorsim._finish_decode`), so every reported number —
  cycles, stage_cycles, unit_busy, events, instrs — is bit-identical.
* :class:`FleetStageDecoder` — many machines.  The pass splits into its
  machine-independent dataflow half, computed once, and its latency
  half, broadcast over a leading machine axis (constants shaped
  ``(M, 1)``): one set of launches decodes a stage for a whole fleet of
  DSE points ("same program, different chip constants").

Bit-identity: the device returns only *per-instruction* int64 values and
float64 latencies, computed with formulas mirrored term-for-term from
:class:`MachineModel`'s ``*_cycles_array`` methods (int64 arithmetic,
one final cast to float64, IEEE division).  Every constant is an int64
or float64 tensor — never a Python scalar, which torch would combine
with an int64 tensor in float32.  Every *sum* (event ledgers, unit busy,
run prefix sums) happens on the host in the shared numpy back half.
The scans are prefix-safe and torch recompiles nothing per shape, so no
padding is needed.  Programs with control flow / scalar-ALU chains take
the same decode-time unroll path as the numpy engine; anything
undecodable falls back to the scalar interpreter per stage, unchanged.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from .isa import Isa, Program
from .machine import MachineModel
from .vectorsim import (
    StageDecoder, DecodeUnsupported, _DecodedStage, _Prep, _finish_decode,
    replay_stage, _END, _K_VEC, _K_MVM, _K_WLOAD, _K_BCAST, _K_CONST,
    _K_SEND, _K_RECV, _K_GLD, _K_GST, _K_SYNC,
    _S_VLEN, _S_VREP, _S_CHANNEL, _S_MASK_LO, _S_MASK_HI,
    _S_SEG_IN, _S_SEG_OUT, _S_NLEN, _I8_FLAG,
)

__all__ = ["TorchStageDecoder", "FleetStageDecoder", "MachineTables",
           "StageTiming", "decoder_for", "run_stage"]

Device = Union[str, torch.device, None]

# machine timing-constant layout (order is the pass's argument order)
_INT_KEYS = ("vector_lanes", "vector_alu_latency", "vector_mul_latency",
             "vector_special_latency", "mvm_interval_beats",
             "mvm_fill_beats")
_FLT_KEYS = ("scalar_alu_cycles", "scalar_ldst_cycles",
             "weight_load_rows_per_cycle", "link_bytes_per_cycle")

# instruction columns shipped to the device, after op / starts
_COL_NAMES = ("dst", "a", "imm", "sreg", "src", "len", "rows", "mg",
              "rep", "core", "size")

# tracked S_Reg timeline columns, in device order
_SREG_IDS = np.array([_S_VLEN, _S_VREP, _S_CHANNEL, _S_MASK_LO,
                      _S_MASK_HI, _S_SEG_IN, _S_SEG_OUT, _S_NLEN],
                     dtype=np.int64)
_SREG_KEYS = ("vlen", "vrep", "chan", "mask_lo", "mask_hi",
              "seg_in", "seg_out", "nlen")
_VLEN_COL = 0

# resolved per-instruction values, in download order
_RES_KEYS = ("core", "size", "loaded") + _SREG_KEYS

# macro-group ids are 5-bit operands: occupancy is a 32-bit mask
_N_MG = 32


class MachineTables:
    """Stacked timing constants — the machine axis of a fleet.

    ``ints`` is ``(M, 6)`` int64 and ``flts`` ``(M, 4)`` float64, in
    ``_INT_KEYS`` / ``_FLT_KEYS`` order, built from
    :meth:`MachineModel.timing_constants` so the batched latency
    arithmetic stays bit-identical to each machine's own accessors.
    """

    __slots__ = ("ints", "flts", "n_machines")

    def __init__(self, ints: torch.Tensor, flts: torch.Tensor) -> None:
        self.ints = ints
        self.flts = flts
        self.n_machines = int(ints.shape[0])

    @classmethod
    def stack(cls, machines: List[MachineModel],
              device: torch.device) -> "MachineTables":
        rows = [m.timing_constants() for m in machines]
        ints = np.array([[r[k] for k in _INT_KEYS] for r in rows],
                        dtype=np.int64)
        flts = np.array([[r[k] for k in _FLT_KEYS] for r in rows],
                        dtype=np.float64)
        return cls(torch.from_numpy(ints).to(device),
                   torch.from_numpy(flts).to(device))


def _latsel_table(dec: StageDecoder) -> np.ndarray:
    """Per-op constant-latency selector: 0 = none (boundary / batched
    kinds), 1 = literal 1.0, 2 = scalar-ALU, 3 = scalar-load/store —
    mirrors the ``const`` table in :class:`StageDecoder.__init__`."""
    t = np.zeros(dec.isa.n_ops, dtype=np.int64)
    t[dec.kind == _K_CONST] = 1
    for i in (dec.id_addi, dec.id_lui):
        if i >= 0:
            t[i] = 2
    for i in (dec.id_sld, dec.id_sst):
        if i >= 0:
            t[i] = 3
    return t


class StageTiming:
    """Opt-in split of the torch engine's decode time.

    Set a decoder's ``timing`` to one of these and every stage decode
    adds to it: ``prep_s``, the host front half (pack, dead code,
    unrolled programs); ``h2d_ms`` / ``pass_ms`` / ``d2h_ms`` on the
    device's clock (CUDA events; wall time on the CPU); and
    ``finish_s``, the host back half.  ``None`` (the default) records
    nothing.
    """

    def __init__(self) -> None:
        self.prep_s = 0.0
        self.h2d_ms = 0.0
        self.pass_ms = 0.0
        self.d2h_ms = 0.0
        self.finish_s = 0.0
        self.calls = 0

    def as_dict(self) -> Dict[str, float]:
        return {"prep_s": self.prep_s, "h2d_ms": self.h2d_ms,
                "pass_ms": self.pass_ms,
                "d2h_ms": self.d2h_ms, "finish_s": self.finish_s,
                "calls": self.calls}


class _Marks:
    """Four timestamps around upload / pass / download on one device."""

    def __init__(self, device: torch.device) -> None:
        self.cuda = device.type == "cuda"
        self.t: List[Any] = []

    def mark(self) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.t.append(e)
        else:
            self.t.append(time.perf_counter())

    def add_to(self, timing: StageTiming) -> None:
        if self.cuda:
            self.t[-1].synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(self.t, self.t[1:])]
        else:
            ms = [(b - a) * 1e3 for a, b in zip(self.t, self.t[1:])]
        timing.h2d_ms += ms[0]
        timing.pass_ms += ms[1]
        timing.d2h_ms += ms[2]
        timing.calls += 1


# ---------------------------------------------------------------------------
# Device pass
# ---------------------------------------------------------------------------


class _OpTables:
    """Per-op decode tables of one :class:`StageDecoder` on one device."""

    def __init__(self, dec: StageDecoder, device: torch.device) -> None:
        def up(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a.astype(np.int64)).to(device)

        self.device = device
        self.kind = up(dec.kind)
        self.vcls = up(dec.vcls)
        self.latsel = up(_latsel_table(dec))
        self.sreg_ids = up(_SREG_IDS)
        self.ids = (dec.id_lui, dec.id_addi, dec.id_cfg, dec.id_cfgr,
                    dec.id_setvl)


# The dense timelines below are ``(R, n)``: one row per register / sreg /
# macro group, the instruction axis innermost.  Every scan along it is
# one 1-D ``cumsum`` over the flattened rows, which torch runs as one
# device-wide scan; ``cummax``, and scans along an outer axis,
# parallelise only over the other axis (R rows here) and walk ``n`` in
# sequence.


def _last_write(w: torch.Tensor) -> torch.Tensor:
    """``(R, n)`` bool -> ``(R, n)`` int64: per row, the last column at
    or before each column where ``w`` is set; negative before the row's
    first (an earlier row's write, or none, lies before the row's
    start in flat order)."""
    r, n = w.shape
    flat = w.reshape(-1)
    count = torch.cumsum(flat, 0)             # writes so far, flat order
    # slot k holds the k-th write's flat position; slot 0 is -1
    slots = torch.cat([flat.new_full((1,), -1, dtype=torch.int64),
                       flat.nonzero().squeeze(1)])
    last = slots[count].view(r, n)
    return last - torch.arange(0, r * n, n, dtype=torch.int64,
                               device=w.device)[:, None]


def _exclusive(last: torch.Tensor) -> torch.Tensor:
    """:func:`_last_write` strictly before each column (-1 first)."""
    return torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]],
                     dim=1)


def _row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int64 cumsum along each row of ``(R, n)`` (wrapping
    modulo 2^64, as numpy's does)."""
    c = torch.cumsum(x.reshape(-1), 0).view_as(x)
    base = torch.cat([c.new_zeros(1), c[:-1, -1]])
    return c - base[:, None]


def _dataflow(tabs: _OpTables, cols: Dict[str, torch.Tensor],
              n_regs: int) -> Tuple[Dict[str, torch.Tensor],
                                    Dict[str, torch.Tensor]]:
    """Machine-independent half of the stage pass.

    Returns ``(resolved, lat_in)``: the resolved per-instruction values
    the host back half reads, and the columns the latency half needs.
    Every read observes only the last write strictly before the reader
    *within the reader's program* (``>= starts``), never another core's.
    """
    id_lui, id_addi, id_cfg, id_cfgr, id_setvl = tabs.ids
    op, starts = cols["op"], cols["starts"]
    dev = op.device
    kind = tabs.kind[op]

    # ---- G_Reg dataflow: dense (n_regs, n) chain-cumsum --------------
    is_lui = op == id_lui
    is_addi = op == id_addi
    dst, a_col, imm = cols["dst"], cols["a"], cols["imm"]
    wr = (is_lui | is_addi) & (dst != 0)
    regs = torch.arange(n_regs, dtype=torch.int64, device=dev)[:, None]
    w = wr & (dst == regs)
    base = torch.where(is_lui, (imm & 0xFFFF) << 16, imm)
    lastw = _exclusive(_last_write(w))
    reset = w & (is_lui | (a_col != regs) | (lastw < starts))
    contrib = torch.where(w, torch.where(reset, base, imm), 0)
    c = _row_cumsum(contrib)
    before = c - contrib                      # cumsum exclusive of column
    vals = c - torch.gather(before, 1,
                            _last_write(reset).clamp_min(0))
    vis = torch.where(lastw >= starts,
                      torch.gather(vals, 1, lastw.clamp_min(0)), 0)

    def greg_read(col: torch.Tensor) -> torch.Tensor:
        return torch.gather(vis, 0, col[None, :])[0]

    rd_src = greg_read(cols["src"])
    rd_core = greg_read(cols["core"])
    rd_size = greg_read(cols["size"])

    # ---- S_Reg timelines: dense (8, n) last-write gather -------------
    is_cfgr = op == id_cfgr
    is_setvl = op == id_setvl
    sw = ((op == id_cfg) | is_cfgr) & (cols["sreg"]
                                       == tabs.sreg_ids[:, None])
    sw[_VLEN_COL] |= is_setvl
    sval = torch.where(is_cfgr, rd_src,
                       torch.where(is_setvl, cols["len"], imm))
    slast = _exclusive(_last_write(sw))
    scur = torch.where(slast >= starts, sval[slast.clamp_min(0)], 0)

    # ---- MG occupancy: segmented OR, one row per macro group ---------
    # bit b of ``loaded`` is set when the last CIM_LOAD of group b
    # before the instruction lies in the instruction's program
    mgs = torch.arange(_N_MG, dtype=torch.int64, device=dev)[:, None]
    wl = (kind == _K_WLOAD) & (cols["mg"] == mgs)
    lwl = _exclusive(_last_write(wl))
    loaded = ((lwl >= starts).to(torch.int64) << mgs).sum(dim=0)

    resolved = {"core": rd_core, "size": rd_size, "loaded": loaded}
    for k, key in enumerate(_SREG_KEYS):
        resolved[key] = scur[k]
    lat_in = {"kind": kind, "vcls": tabs.vcls[op],
              "latsel": tabs.latsel[op], "vlen": scur[0],
              "vrep": scur[1], "rows": cols["rows"],
              "rep": cols["rep"], "size": rd_size}
    return resolved, lat_in


def _latency(tables: MachineTables,
             x: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-machine half: ``(M, n)`` float64 latencies, term-for-term the
    :class:`MachineModel` ``*_cycles_array`` expressions."""
    ints = tables.ints[:, :, None]             # (M, 6, 1)
    flts = tables.flts[:, :, None]             # (M, 4, 1)
    lanes, v_alu, v_mul, v_special, ivl, fill = ints.unbind(1)
    alu_f, ldst_f, wl_rate, link_bpc = flts.unbind(1)
    kind, vcls = x["kind"], x["vcls"]

    zero = torch.zeros_like(alu_f)
    one = torch.ones_like(alu_f)
    consts = torch.cat([zero, one, alu_f, ldst_f], dim=1)     # (M, 4)
    lat = consts[:, x["latsel"]]

    n_el = x["vlen"].clamp_min(1) * x["vrep"].clamp_min(1)
    n_el = n_el.clamp_min(1)
    beats = -(-n_el // lanes)                 # ceil-div, exact int64
    vlat = torch.where(vcls == 2, beats * v_special,
                       beats + torch.where(vcls == 1, v_mul, v_alu)
                       ).to(torch.float64)
    lat = torch.where(kind == _K_VEC, vlat, lat)
    lat = torch.where(kind == _K_WLOAD,
                      x["rows"].to(torch.float64) / wl_rate, lat)
    lat = torch.where(kind == _K_MVM,
                      (x["rep"] * ivl + fill).to(torch.float64), lat)
    lat = torch.where(kind == _K_BCAST,
                      torch.maximum(one, x["size"].to(torch.float64)
                                    / link_bpc), lat)
    return lat


# ---------------------------------------------------------------------------
# Host halves
# ---------------------------------------------------------------------------


def _reg_count(pr: _Prep) -> int:
    """Dense G_Reg width for this stage (highest register read + 1).

    Raises :class:`DecodeUnsupported` when a register operand falls
    outside the architectural file — the caller then takes the scalar
    fallback, exactly like any other undecodable stage.
    """
    hi = 0
    for name in ("dst", "src", "core", "size"):
        c = pr.col(name)
        if c.size:
            lo_v, hi_v = int(c.min()), int(c.max())
            if lo_v < 0 or hi_v >= 32:
                raise DecodeUnsupported(
                    f"register operand {name}={lo_v if lo_v < 0 else hi_v}"
                    " outside G0..G31")
            hi = max(hi, hi_v)
    return hi + 1


def _host_cols(pr: _Prep) -> np.ndarray:
    """The stage's columns as one ``(13, n)`` int64 block (op, starts,
    then ``_COL_NAMES``), so the upload is one copy."""
    block = np.empty((2 + len(_COL_NAMES), pr.n), dtype=np.int64)
    block[0] = pr.op
    block[1] = pr.starts
    for k, name in enumerate(_COL_NAMES, 2):
        block[k] = pr.col(name)
    return block


def _call_exec(tabs: _OpTables, tables: MachineTables, pr: _Prep,
               timing: Optional[StageTiming] = None
               ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Upload, run both halves of the pass, download.

    Returns ``(lat, res)``: ``(M, n)`` float64 latencies and the
    resolved ``(n,)`` int64 columns.
    """
    n_regs = _reg_count(pr)
    marks = _Marks(tabs.device) if timing is not None else None
    if marks is not None:
        marks.mark()
    block = torch.from_numpy(_host_cols(pr)).to(tabs.device)
    if marks is not None:
        marks.mark()
    cols = dict(zip(("op", "starts") + _COL_NAMES, block.unbind(0)))
    resolved, lat_in = _dataflow(tabs, cols, n_regs)
    lat = _latency(tables, lat_in)
    res = torch.stack([resolved[k] for k in _RES_KEYS])
    if marks is not None:
        marks.mark()
    lat_h = lat.cpu().numpy()
    res_h = res.cpu().numpy()
    if marks is not None:
        marks.mark()
        marks.add_to(timing)
    return lat_h, dict(zip(_RES_KEYS, res_h))


def _finish_from_device(out: _DecodedStage, pr: _Prep, dec: StageDecoder,
                        m: MachineModel, lat: np.ndarray,
                        res: Dict[str, np.ndarray]) -> None:
    """Numpy back half: event ledgers, boundary items, replay plan.

    Every expression here is copied verbatim from the numpy engine's
    ``decode_stage`` (same dtypes, same `.sum()` order), so the totals
    are bit-identical given identical per-instruction inputs.
    """
    op, kind, col = pr.op, pr.kind, pr.col
    ev_tot = [0.0] * 4
    ev_cnt = [0] * 4

    # ---- S_LD / S_ST ledger traffic (4 B words) --------------------
    n_mem = int(((op == dec.id_sld) | (op == dec.id_sst)).sum())
    ev_tot[0] += 4.0 * n_mem
    ev_cnt[0] += n_mem

    # ---- vector ops ------------------------------------------------
    vpos = np.flatnonzero(kind == _K_VEC)
    if len(vpos):
        n_el = (np.maximum(res["vlen"][vpos], 1)
                * np.maximum(res["vrep"][vpos], 1))
        esz = np.where(col("flags")[vpos] & _I8_FLAG, 1, 4)
        ev_tot[0] += float((n_el * esz * 2).sum())
        ev_tot[3] += float(n_el.sum())
        ev_cnt[0] += len(vpos)
        ev_cnt[3] += len(vpos)

    # ---- CIM_LOAD --------------------------------------------------
    lpos = np.flatnonzero(kind == _K_WLOAD)
    if len(lpos):
        rows = col("rows")[lpos]
        nlen = np.maximum(res["nlen"][lpos], 1)
        wl = float((rows * nlen).sum())
        ev_tot[0] += wl
        ev_tot[1] += wl
        ev_cnt[0] += len(lpos)
        ev_cnt[1] += len(lpos)

    # ---- CIM_MVM ---------------------------------------------------
    mpos = np.flatnonzero(kind == _K_MVM)
    if len(mpos):
        rep = col("rep")[mpos]
        mask = ((res["mask_lo"][mpos] & 0xFFFF)
                | (res["mask_hi"][mpos] << 16))
        act = res["loaded"][mpos] & mask
        active = np.zeros(len(mpos), dtype=np.int64)
        for b in range(32):
            active += (act >> b) & 1
        ev_tot[2] += float((rep * active).sum() * m.macros_per_group)
        seg = res["seg_in"][mpos] + res["seg_out"][mpos]
        ev_tot[0] += float((rep * seg).sum())
        ev_cnt[0] += len(mpos)
        ev_cnt[2] += len(mpos)

    # ---- boundary items --------------------------------------------
    bitems: Dict[int, tuple] = {}
    for tag in (_K_SEND, _K_RECV):
        kpos = np.flatnonzero(kind == tag)
        for p, c, s, st in zip(kpos.tolist(),
                               res["core"][kpos].tolist(),
                               res["size"][kpos].tolist(),
                               res["chan"][kpos].tolist()):
            bitems[p] = (tag, c, s, st)
    for tag in (_K_GLD, _K_GST):
        kpos = np.flatnonzero(kind == tag)
        for p, s in zip(kpos.tolist(), res["size"][kpos].tolist()):
            bitems[p] = (tag, s)
    sync = np.flatnonzero(kind == _K_SYNC)
    for p, b in zip(sync.tolist(), col("barrier")[sync].tolist()):
        bitems[p] = (_K_SYNC, b)

    _finish_decode(out, pr, dec.unit[op], lat, bitems, ev_tot, ev_cnt)


# ---------------------------------------------------------------------------
# Decoders
# ---------------------------------------------------------------------------


class TorchStageDecoder:
    """Single-machine tensor decode: drop-in for :class:`StageDecoder`.

    Wraps a numpy :class:`StageDecoder` for the machine-independent prep
    (pack / dead-code / unroll split) and per-op tables, and replaces
    the dataflow + latency passes with the tensor pass on ``device``
    (CUDA unless named; raises without a card).
    """

    def __init__(self, isa: Isa, m: MachineModel,
                 device: Device = None) -> None:
        self.isa = isa
        self.m = m
        self.device = resolve_device(device)
        self.npdec = StageDecoder(isa, m)
        self.tabs = _OpTables(self.npdec, self.device)
        self.tables = MachineTables.stack([m], self.device)
        self.timing: Optional[StageTiming] = None
        self.fallbacks = 0           # stages left to the interpreter

    def decode_stage(self, programs: Dict[int, Program]) -> _DecodedStage:
        t0 = time.perf_counter()
        out = _DecodedStage()
        pr = self.npdec._prep(programs)
        out.n_prog = pr.n_prog
        for cid in pr.empty:
            out.items[cid] = [(_END,)]
        for cid, prog in pr.unroll:
            self.npdec.unroll_decode(prog, cid, out)
        if self.timing is not None:
            self.timing.prep_s += time.perf_counter() - t0
        if not pr.cids:
            return out
        lat, res = _call_exec(self.tabs, self.tables, pr, self.timing)
        t0 = time.perf_counter()
        _finish_from_device(out, pr, self.npdec, self.m, lat[0], res)
        if self.timing is not None:
            self.timing.finish_s += time.perf_counter() - t0
        return out


class FleetStageDecoder:
    """Batched decode of one stage for a whole fleet of machines.

    One prep, one dataflow pass, one latency pass over the stacked
    :class:`MachineTables`, then one cheap numpy finish per machine —
    the replay plans are exactly what each machine's own
    ``Simulator(engine="torch")`` would build.
    """

    def __init__(self, isa: Isa, machines: List[MachineModel],
                 device: Device = None) -> None:
        self.isa = isa
        self.machines = list(machines)
        self.device = resolve_device(device)
        self.npdecs = [StageDecoder(isa, m) for m in self.machines]
        self.tabs = _OpTables(self.npdecs[0], self.device)
        self.tables = MachineTables.stack(self.machines, self.device)
        self.timing: Optional[StageTiming] = None

    def prep(self, programs: Dict[int, Program]) -> _Prep:
        """Machine-independent front half (cacheable by the caller)."""
        return self.npdecs[0]._prep(programs)

    def decode_stage(self, programs: Dict[int, Program],
                     prep: Optional[_Prep] = None) -> List[_DecodedStage]:
        t0 = time.perf_counter()
        pr = prep if prep is not None else self.prep(programs)
        if self.timing is not None:
            self.timing.prep_s += time.perf_counter() - t0
        lat = res = None
        if pr.cids:
            lat, res = _call_exec(self.tabs, self.tables, pr, self.timing)
        t0 = time.perf_counter()
        outs: List[_DecodedStage] = []
        for i, (m, dec) in enumerate(zip(self.machines, self.npdecs)):
            out = _DecodedStage()
            out.n_prog = dict(pr.n_prog)
            for cid in pr.empty:
                out.items[cid] = [(_END,)]
            for cid, prog in pr.unroll:
                dec.unroll_decode(prog, cid, out)
            if pr.cids:
                _finish_from_device(out, pr, dec, m, lat[i], res)
            outs.append(out)
        if self.timing is not None:
            self.timing.finish_s += time.perf_counter() - t0
        return outs


def decoder_for(sim: Any) -> TorchStageDecoder:
    """The simulator's torch decoder, built on first use (on
    ``sim.device``) and kept with the simulator."""
    dec = getattr(sim, "_tdecoder", None)
    if dec is None or dec.isa is not sim.isa:
        dec = sim._tdecoder = TorchStageDecoder(sim.isa, sim.m, sim.device)
    return dec


def run_stage(sim: Any, sp: Any) -> Optional[Tuple[float, Dict[str, float],
                                                   Dict[str, float], int]]:
    """Torch-engine counterpart of :func:`vectorsim.run_stage`.

    Decode on ``sim.device``, replay with the shared
    :func:`vectorsim.replay_stage`; ``None`` when the stage is outside
    the decodable subset (scalar-interpreter fallback, as ever; counted
    in the decoder's ``fallbacks``).
    """
    dec = decoder_for(sim)
    try:
        ds = dec.decode_stage(sp.programs)
    except DecodeUnsupported:
        dec.fallbacks += 1
        return None
    return replay_stage(sim, sp, ds)
