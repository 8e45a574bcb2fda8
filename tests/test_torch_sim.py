"""The port's simulate / trace / functional-ISS fidelities against the
JAX package.

* codegen: the port's ``CompiledModel`` streams equal the reference's,
  instruction by instruction;
* the torch stage engine (``engine="torch"``, ``device="cpu"``) is
  bit-identical to the port's scalar interpreter and to the reference's
  numpy ``vector`` and ``scalar`` engines — cycles, stage_cycles,
  events, unit_busy and instrs — on the golden workloads, hand-built
  corner cases and randomized programs;
* the fleet decode equals a loop of single-chip runs;
* the trace backend's report equals the reference's;
* the functional ISS equals the reference's ISS, the ``func:torch``
  oracle and an independent tensor transformer reference.

Every comparison is exact equality (tolerance 0).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro import flow as jflow
from repro.core import ref as jref
from repro.core.arch import default_chip as j_default_chip
from repro.core.codegen import StageProgram as JStageProgram
from repro.core.codegen import _ensure_vec_flag_operand as j_ensure_flag
from repro.core.isa import Program as JProgram
from repro.core.isa import default_isa as j_default_isa
from repro.core.mapping import CostParams as JCostParams
from repro.core.simulator import Simulator as JSimulator
from repro_torch import flow
from repro_torch.core import torchsim, vecsem, vectorsim
from repro_torch.core.arch import default_chip
from repro_torch.core.codegen import (QuantParams, StageProgram,
                                     _ensure_vec_flag_operand)
from repro_torch.core.isa import SREG, Program, default_isa
from repro_torch.core.machine import machine_for
from repro_torch.core.mapping import CostParams
from repro_torch.core.simulator import ENGINES, Simulator
from repro_torch.explore import FleetEvaluator, canonical_chip

from hypothesis import find, given, settings, strategies as st

pytestmark = pytest.mark.filterwarnings(
    "ignore:perf-mode lmem overflow:RuntimeWarning")

# small tensors: one intra-op thread keeps the parallel test processes
# from crowding each other's cores (the timing-sensitive tests among them)
torch.set_num_threads(1)

CPU = "cpu"
CHIP = default_chip()
J_CHIP = j_default_chip()
ISA = default_isa()
J_ISA = j_default_isa()
_ensure_vec_flag_operand(ISA)
j_ensure_flag(J_ISA)

SMALL_TF = {"n_layers": 1, "d_model": 128, "n_heads": 4, "seq": 16,
            "vocab": 64}
GOLDEN = [
    ("tiny_cnn", {}, "dp"),
    ("tiny_cnn", {}, "generic"),
    ("resnet18", {"res": 64}, "dp"),
    ("transformer", SMALL_TF, "dp"),
]
GOLDEN_IDS = ["tiny_cnn-dp", "tiny_cnn-generic", "resnet18-64",
              "transformer-1l"]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _compile_both(model, kw, strategy, batch=2, chip=None, jchip=None):
    opts = dict(strategy=strategy, workload_kw=kw or None,
                fidelity="simulate")
    art = flow.compile(model, chip or CHIP, flow.CompileOptions(
        params=CostParams(batch=batch), **opts))
    jart = jflow.compile(model, jchip or J_CHIP, jflow.CompileOptions(
        params=JCostParams(batch=batch), **opts))
    return art, jart


def assert_reports_identical(a, b):
    assert a.cycles == b.cycles
    assert a.stage_cycles == b.stage_cycles
    assert a.events == b.events
    assert a.unit_busy == b.unit_busy
    assert a.instrs == b.instrs


def assert_stage_identical(a, b):
    makespan_a, events_a, busy_a, instrs_a = a
    makespan_b, events_b, busy_b, instrs_b = b
    assert makespan_a == makespan_b
    assert events_a == events_b
    assert busy_a == busy_b
    assert instrs_a == instrs_b


def I(op, **args):                       # noqa: E743 — terse test DSL
    return (op, args)


def _programs(isa, prog_cls, spec):
    out = {}
    for cid, instrs in spec.items():
        p = prog_cls(core_id=cid)
        for op, args in instrs:
            p.append(isa.instr(op, **args))
        out[cid] = p
    return out


def run_stage_all(spec, chip=CHIP, jchip=J_CHIP, scalar_exact=True):
    """One stage on the port's torch, vector and scalar engines and on
    the reference's vector and scalar engines; all must agree.

    ``scalar_exact=False`` holds the scalar interpreters to the last
    ulp only: with non-dyadic latencies the block replay re-associates
    float additions (the reference's own exactness note in
    ``vectorsim``), so there the torch engine is bit-identical to the
    vector engines it mirrors."""
    sp = StageProgram(stage=None, schedules=[],
                      programs=_programs(ISA, Program, spec))
    jsp = JStageProgram(stage=None, schedules=[],
                        programs=_programs(J_ISA, JProgram, spec))
    out_t = torchsim.run_stage(
        Simulator(chip, ISA, engine="torch", device=CPU), sp)
    assert out_t is not None, "stage unexpectedly not decodable"
    out_v = vectorsim.run_stage(Simulator(chip, ISA, engine="vector"), sp)
    out_jv = vectorsim.run_stage(JSimulator(jchip, J_ISA, engine="vector"),
                                 jsp)
    out_s = Simulator(chip, ISA, engine="scalar")._run_stage(sp, None)
    out_js = JSimulator(jchip, J_ISA, engine="scalar")._run_stage(jsp,
                                                                  None)
    for other in (out_v, out_jv):
        assert_stage_identical(out_t, other)
    for other in (out_s, out_js):
        if scalar_exact:
            assert_stage_identical(out_t, other)
        else:
            assert out_t[0] == pytest.approx(other[0], rel=1e-12)
            assert out_t[1] == other[1] and out_t[3] == other[3]
    return out_t


def _send(dst, size, stream, r=1):
    return [
        I("CIM_CFG", sreg=SREG["CHANNEL"], imm=stream),
        I("S_ADDI", dst=r, a=0, imm=dst),
        I("S_ADDI", dst=r + 1, a=0, imm=64),
        I("S_ADDI", dst=r + 2, a=0, imm=size),
        I("SEND", core=r, src=r + 1, size=r + 2),
    ]


def _recv(src, size, stream, r=4):
    return [
        I("CIM_CFG", sreg=SREG["CHANNEL"], imm=stream),
        I("S_ADDI", dst=r, a=0, imm=128),
        I("S_ADDI", dst=r + 1, a=0, imm=src),
        I("S_ADDI", dst=r + 2, a=0, imm=size),
        I("RECV", dst=r, core=r + 1, size=r + 2),
    ]


def _timing_chips(base, n=6):
    """Chips sharing ``base``'s structure, varying only timing
    constants (built like the reference suite's)."""
    chips = []
    for i in range(n):
        chips.append(dataclasses.replace(
            base,
            core=dataclasses.replace(
                base.core,
                scalar=dataclasses.replace(base.core.scalar,
                                           alu_latency=1 + i % 3,
                                           ldst_latency=2 + i % 2),
                vector=dataclasses.replace(base.core.vector,
                                           alu_latency=1 + i % 4,
                                           mul_latency=2 + i % 3),
                cim=dataclasses.replace(
                    base.core.cim,
                    weight_load_rows_per_cycle=1 + i % 4)),
            noc=dataclasses.replace(base.noc, router_latency=1 + i % 3),
            clock_ghz=1.0 + 0.2 * i,
            name=f"t{i}"))
    return chips


def _nonpow2(base):
    """1/3-row weight loads and 3-flit links: non-dyadic latencies."""
    return dataclasses.replace(
        base,
        core=dataclasses.replace(
            base.core,
            cim=dataclasses.replace(base.core.cim,
                                    weight_load_rows_per_cycle=3)),
        noc=dataclasses.replace(base.noc, flits_per_cycle=3),
        global_mem_bytes_per_cycle=48, name="nonpow2")


# ---------------------------------------------------------------------------
# codegen: identical streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,kw,strategy", GOLDEN, ids=GOLDEN_IDS)
def test_codegen_streams_identical(model, kw, strategy):
    art, jart = _compile_both(model, kw, strategy)
    cm, jcm = art.model, jart.model
    assert cm.batch == jcm.batch and cm.total_instrs == jcm.total_instrs
    assert len(cm.stages) == len(jcm.stages)
    for st_, jst in zip(cm.stages, jcm.stages):
        assert list(st_.programs) == list(jst.programs)
        for cid, prog in st_.programs.items():
            got = [(i.op, i.args) for i in prog]
            want = [(i.op, i.args) for i in jst.programs[cid]]
            assert got == want, f"core {cid}"
    assert cm.layout.size == jcm.layout.size
    assert cm.layout.weights == jcm.layout.weights
    assert cm.layout.acts == jcm.layout.acts
    assert {k: (q.scale, q.shift) for k, q in cm.quant.items()} == \
        {k: (q.scale, q.shift) for k, q in jcm.quant.items()}
    assert art.pass_record("codegen").summary == \
        jart.pass_record("codegen").summary


# ---------------------------------------------------------------------------
# golden compiled workloads: torch == scalar == reference vector/scalar
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,kw,strategy", GOLDEN, ids=GOLDEN_IDS)
def test_golden_workload_equivalence(model, kw, strategy):
    art, jart = _compile_both(model, kw, strategy)
    cm, jcm = art.model, jart.model
    tor = Simulator(CHIP, cm.isa, engine="torch",
                    device=CPU).run_model(cm)
    reps = [Simulator(CHIP, cm.isa, engine="scalar").run_model(cm),
            JSimulator(J_CHIP, jcm.isa, engine="vector").run_model(jcm),
            JSimulator(J_CHIP, jcm.isa, engine="scalar").run_model(jcm)]
    for rep in reps:
        assert_reports_identical(tor, rep)
    ev = art.evaluate("simulate", engine="torch", device=CPU)
    jev = jart.evaluate("simulate", engine="vector")
    assert (ev.cycles, ev.energy, ev.throughput_sps) == \
        (jev.cycles, jev.energy, jev.throughput_sps)


def test_nonpow2_timing_constants_identical():
    """Non-dyadic latencies through the tensor latency mirrors: the
    host replays the device's float64 latencies in the same order as
    the numpy engine, so every number stays bit-identical."""
    chip, jchip = _nonpow2(default_chip(n_cores=8, mesh_cols=4)), \
        _nonpow2(j_default_chip(n_cores=8, mesh_cols=4))
    art, jart = _compile_both("tiny_cnn", {}, "dp", chip=chip,
                              jchip=jchip)
    tor = Simulator(chip, art.model.isa, engine="torch",
                    device=CPU).run_model(art.model)
    vec = JSimulator(jchip, jart.model.isa,
                     engine="vector").run_model(jart.model)
    assert_reports_identical(tor, vec)


# ---------------------------------------------------------------------------
# hand-built corner cases
# ---------------------------------------------------------------------------


def test_recv_blocks_until_send():
    run_stage_all({0: _send(1, 32, 7) + [I("S_ADDI", dst=5, a=0, imm=1)]
                   * 50 + [I("HALT")],
                   1: _recv(0, 32, 7) + [I("HALT")]})


def test_sync_barrier_and_gmem_ports():
    def body(cid, delay):
        return ([I("S_ADDI", dst=1, a=0, imm=256),
                 I("S_ADDI", dst=2, a=0, imm=1024 * cid),
                 I("S_ADDI", dst=3, a=0, imm=200 + delay)]
                + [I("NOP")] * delay
                + [I("GLD", dst=1, gaddr=2, size=3), I("SYNC", barrier=1),
                   I("GST", src=1, gaddr=2, size=3), I("HALT")])

    run_stage_all({c: body(c, 3 * c) for c in range(5)})


def test_cfgr_and_lui_addi_chains():
    run_stage_all({0: [
        I("S_LUI", dst=9, imm=2),
        I("S_ADDI", dst=9, a=9, imm=100),
        I("CIM_CFGR", sreg=SREG["VLEN"], src=9),
        I("V_ADD", dst=1, a=2, b=3),
        I("S_LD", dst=9, base=1, off=0),
        I("CIM_CFGR", sreg=SREG["VLEN"], src=9),
        I("V_ADD", dst=1, a=2, b=3),
        I("HALT")]})


def test_mvm_occupancy_and_vector_classes():
    run_stage_all({0: [
        I("CIM_CFG", sreg=SREG["MG_NLEN"], imm=16),
        I("CIM_CFG", sreg=SREG["MG_KOFF"], imm=0),
        I("S_ADDI", dst=1, a=0, imm=0),
        I("CIM_LOAD", mg=0, src=1, rows=64),
        I("CIM_LOAD", mg=2, src=1, rows=32),
        I("CIM_CFG", sreg=SREG["MG_MASK_LO"], imm=0b101),
        I("CIM_CFG", sreg=SREG["MVM_SEG_IN"], imm=64),
        I("CIM_CFG", sreg=SREG["MVM_SEG_OUT"], imm=128),
        I("CIM_MVM", dst=1, src=1, rep=7, acc=0),
        I("V_SETVL", len=48),
        I("CIM_CFG", sreg=SREG["V_REP"], imm=3),
        I("V_MUL", dst=1, a=2, b=3),
        I("V_SIGMOID", dst=1, a=2, b=0),
        I("V_MAX", dst=1, a=2, b=3, flags=4),
        I("HALT")]})


def test_mg_occupancy_across_programs_up_to_mg31():
    """Loads in several programs of one stage, macro groups up to 31
    (bit 31 of the occupancy mask, set through MG_MASK_HI): an MVM sees
    only its own program's loads, and a program without loads sees
    none."""
    def core(mgs, mask_lo, mask_hi, tail_mg=None):
        body = [I("CIM_CFG", sreg=SREG["MG_NLEN"], imm=8),
                I("S_ADDI", dst=1, a=0, imm=0)]
        body += [I("CIM_LOAD", mg=g, src=1, rows=16 + g) for g in mgs]
        body += [I("CIM_CFG", sreg=SREG["MG_MASK_LO"], imm=mask_lo),
                 I("CIM_CFG", sreg=SREG["MG_MASK_HI"], imm=mask_hi),
                 I("CIM_MVM", dst=1, src=1, rep=3, acc=0)]
        if tail_mg is not None:
            body += [I("CIM_LOAD", mg=tail_mg, src=1, rows=4),
                     I("CIM_MVM", dst=1, src=1, rep=5, acc=1)]
        return body + [I("HALT")]

    spec = {0: core([31, 0, 17], 0xFFFF, 0xFFFF, tail_mg=16),
            1: core([30, 31], 0x0001, 0xC000),
            2: core([], 0xFFFF, 0xFFFF),
            3: core([5, 5, 15], 0x8020, 0x0000, tail_mg=31)}
    _, events, _, _ = run_stage_all(spec)
    assert events["cim_macro_passes"] > 0


def test_large_values_expose_no_float32():
    """``rows / wl_rate`` and ``size / link_bpc`` at magnitudes where a
    float32 intermediate would round (rows and sizes above 2^24, with
    non-dyadic rates), and long vectors whose ceil-division needs
    exact int64."""
    chip, jchip = (_nonpow2(default_chip(n_cores=4, mesh_cols=2)),
                   _nonpow2(j_default_chip(n_cores=4, mesh_cols=2)))
    m = machine_for(chip)
    assert m.link_bytes_per_cycle not in (1.0, 2.0, 4.0, 8.0, 16.0, 32.0)
    rows = (1 << 24) + 3
    spec = {0: [I("CIM_CFG", sreg=SREG["MG_NLEN"], imm=64),
                I("S_ADDI", dst=1, a=0, imm=0),
                I("CIM_LOAD", mg=7, src=1, rows=rows),
                I("CIM_LOAD", mg=9, src=1, rows=(1 << 30) + 7),
                I("S_LUI", dst=8, imm=0x7FFF),
                I("S_ADDI", dst=8, a=8, imm=12345),
                I("BCAST", src=1, size=8),
                I("V_SETVL", len=(1 << 27) + 5),
                I("CIM_CFG", sreg=SREG["V_REP"], imm=77),
                I("V_EXP", dst=1, a=2, b=0),
                I("HALT")],
            1: [I("S_LUI", dst=3, imm=0x1234),
                I("S_ADDI", dst=3, a=3, imm=1),
                I("BCAST", src=1, size=3),
                I("HALT")]}
    run_stage_all(spec, chip=chip, jchip=jchip, scalar_exact=False)
    # the latencies themselves, against the numpy decode's float64
    sp = StageProgram(stage=None, schedules=[],
                      programs=_programs(ISA, Program, spec))
    dec = torchsim.TorchStageDecoder(ISA, m, CPU)
    pr = dec.npdec._prep(sp.programs)
    lat, _ = torchsim._call_exec(dec.tabs, dec.tables, pr)
    wl = np.flatnonzero(pr.kind == vectorsim._K_WLOAD)
    np.testing.assert_array_equal(
        lat[0][wl], m.weight_load_cycles_array(pr.col("rows")[wl]))
    assert lat[0][wl[0]] != float(np.float32(rows)) / 3.0


def test_branchy_program_unrolls_statically():
    run_stage_all({0: [I("S_ADDI", dst=1, a=0, imm=3),
                       I("S_ADDI", dst=2, a=0, imm=0),
                       I("S_ADDI", dst=1, a=1, imm=-1),
                       I("BNE", a=1, b=2, off=-1),
                       I("HALT")]})


def test_register_outside_file_is_declined():
    """A register operand beyond G31 is outside the tensor decode's
    dense register file: the torch engine declines the stage (the
    simulator then takes the scalar path), as the reference's JAX
    engine does."""
    spec = {0: [I("S_ADDI", dst=40, a=0, imm=16),
                I("V_SETVL", len=16), I("V_ADD", dst=1, a=2, b=3),
                I("HALT")]}
    sp = StageProgram(stage=None, schedules=[],
                      programs=_programs(ISA, Program, spec))
    sim = Simulator(CHIP, ISA, engine="torch", device=CPU)
    assert torchsim.run_stage(sim, sp) is None


def test_undecodable_stage_falls_back_to_scalar(monkeypatch):
    """A stage outside the decodable subset (here: an unroll beyond the
    cap) runs on the scalar interpreter inside ``engine="torch"`` and
    reports identically."""
    monkeypatch.setattr(vectorsim.StageDecoder, "UNROLL_CAP", 4)
    body = [I("S_ADDI", dst=1, a=0, imm=5),
            I("S_ADDI", dst=2, a=0, imm=0),
            I("S_ADDI", dst=1, a=1, imm=-1),
            I("BNE", a=1, b=2, off=-1),
            I("HALT")]
    decodable = {0: [I("V_SETVL", len=16), I("V_ADD", dst=1, a=2, b=3),
                     I("HALT")]}
    stages = [StageProgram(stage=None, schedules=[],
                           programs=_programs(ISA, Program, s))
              for s in ({0: body}, decodable)]
    sim = Simulator(CHIP, ISA, engine="torch", device=CPU)
    assert torchsim.run_stage(sim, stages[0]) is None
    assert torchsim.run_stage(sim, stages[1]) is not None
    assert torchsim.decoder_for(sim).fallbacks == 1

    class _M:                             # minimal CompiledModel stand-in
        layout = None

    _M.stages = stages
    assert_reports_identical(
        sim.run_model(_M()),
        Simulator(CHIP, ISA, engine="scalar").run_model(_M()))


def test_engine_validation_and_device():
    assert "torch" in ENGINES and "jax" not in ENGINES
    with pytest.raises(ValueError):
        Simulator(CHIP, ISA, mode="func", engine="torch", device=CPU)
    with pytest.raises(ValueError):
        Simulator(CHIP, ISA, engine="jax")
    assert Simulator(CHIP, ISA, engine="torch",
                     device=CPU).device == torch.device("cpu")
    # the default perf engine is torch; functional mode interprets
    sim = Simulator(CHIP, ISA, device=CPU)
    assert (sim.engine, sim.device) == ("torch", torch.device("cpu"))
    assert Simulator(CHIP, ISA, mode="func").engine == "scalar"
    # the host engines never touch a device
    for engine in ("vector", "scalar"):
        assert Simulator(CHIP, ISA, engine=engine).device is None


# ---------------------------------------------------------------------------
# fleet: one batched decode == loop of single runs
# ---------------------------------------------------------------------------


def test_fleet_equals_loop_of_single_evals():
    chips = _timing_chips(CHIP, 6)
    assert len({canonical_chip(c) for c in chips}) == 1
    cg = flow.compile("tiny_cnn", CHIP, flow.CompileOptions(
        params=CostParams(batch=2))).cg
    fe = FleetEvaluator(cg, params=CostParams(batch=2), device=CPU)
    payloads = fe.evaluate([(c, "dp") for c in chips])
    art = flow.compile(cg, canonical_chip(chips[0]), flow.CompileOptions(
        strategy="dp", params=CostParams(batch=2), fidelity="simulate"))
    cm = art.model
    # an evaluator given a StageTiming adds up each stage's decode
    timing = torchsim.StageTiming()
    again = FleetEvaluator(cg, params=CostParams(batch=2), device=CPU,
                           timing=timing).evaluate([(c, "dp") for c in chips])
    assert timing.calls == len(cm.stages)
    drop = ("wall_s",)
    assert [{k: v for k, v in pl.items() if k not in drop}
            for pl in again] == \
        [{k: v for k, v in pl.items() if k not in drop} for pl in payloads]
    jchips = _timing_chips(J_CHIP, 6)
    # the canonical chip is the default one: the same pinned program
    jart = jflow.compile("tiny_cnn", J_CHIP, jflow.CompileOptions(
        strategy="dp", params=JCostParams(batch=2), fidelity="simulate"))
    for chip, jchip, pl in zip(chips, jchips, payloads):
        rep = Simulator(chip, cm.isa, engine="torch",
                        device=CPU).run_model(cm)
        assert pl["cycles"] == rep.cycles
        assert pl["energy"] == dict(rep.energy())
        assert pl["throughput_sps"] == \
            cm.batch / (rep.cycles / (chip.clock_ghz * 1e9))
        assert_reports_identical(
            rep, Simulator(chip, cm.isa, engine="scalar").run_model(cm))
        assert_reports_identical(rep, JSimulator(
            jchip, jart.model.isa, engine="vector").run_model(jart.model))


def test_fleet_stage_decoder_matches_per_machine():
    chips = _timing_chips(CHIP, 3)
    machines = [machine_for(c) for c in chips]
    spec = {c: (_send((c + 1) % 3, 16, 10 + c)
                + _recv((c - 1) % 3, 16, 10 + (c - 1) % 3)
                + [I("V_SETVL", len=40), I("V_ADD", dst=1, a=2, b=3),
                   I("CIM_LOAD", mg=c, src=1, rows=10 + c),
                   I("HALT")])
            for c in range(3)}
    sp = StageProgram(stage=None, schedules=[],
                      programs=_programs(ISA, Program, spec))
    outs = torchsim.FleetStageDecoder(ISA, machines,
                                      CPU).decode_stage(sp.programs)
    for chip, ds in zip(chips, outs):
        sim = Simulator(chip, ISA, engine="torch", device=CPU)
        out_f = vectorsim.replay_stage(sim, sp, ds)
        assert_stage_identical(out_f, torchsim.run_stage(sim, sp))
        assert_stage_identical(out_f, Simulator(
            chip, ISA, engine="scalar")._run_stage(sp, None))


def test_stage_timing_records_each_call():
    art, _ = _compile_both("tiny_cnn", {}, "dp")
    sim = Simulator(CHIP, art.model.isa, engine="torch", device=CPU)
    torchsim.decoder_for(sim).timing = t = torchsim.StageTiming()
    sim.run_model(art.model)
    assert torchsim.decoder_for(sim).fallbacks == 0
    d = t.as_dict()
    assert d["calls"] == len(art.model.stages)
    assert min(d["h2d_ms"], d["pass_ms"], d["d2h_ms"],
               d["finish_s"]) > 0


# ---------------------------------------------------------------------------
# trace backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,kw,strategy", [
    ("tiny_cnn", {"res": 8}, "dp"),
    ("resnet18", {"res": 32}, "generic"),
    ("transformer", SMALL_TF, "dp"),
])
def test_trace_backend_identical(model, kw, strategy):
    opts = dict(strategy=strategy, batch=2, workload_kw=kw,
                fidelity="trace")
    art = flow.compile(model, CHIP, flow.CompileOptions(**opts))
    jart = jflow.compile(model, J_CHIP, jflow.CompileOptions(**opts))
    assert art.model is None             # trace needs no codegen
    rep, jrep = art.evaluate(), jart.evaluate()
    assert rep.backend == jrep.backend == "trace"
    assert (rep.cycles, rep.energy, rep.throughput_sps, rep.batch) == \
        (jrep.cycles, jrep.energy, jrep.throughput_sps, jrep.batch)
    t, jt = rep.trace, jrep.trace
    assert (t.stage_cycles, t.events, t.unit_busy, t.n_events) == \
        (jt.stage_cycles, jt.events, jt.unit_busy, jt.n_events)


# ---------------------------------------------------------------------------
# functional ISS
# ---------------------------------------------------------------------------


def _func_both(model, kw, chip, jchip, batch=2, seed=0):
    """The same state through the port's and the reference's codegen
    and functional ISS."""
    opts = dict(strategy="dp", batch=batch, workload_kw=kw,
                strict_lmem=True)
    jart0 = jflow.compile(model, jchip, jflow.CompileOptions(**opts))
    w, b, x = jref.random_init(jart0.cg, batch=batch, seed=seed)
    q = jref.auto_quant(jart0.cg, w, b, x)
    jart = jflow.compile(model, jchip, jflow.CompileOptions(
        fidelity="func", quant=q, **opts))
    art = flow.compile(model, chip, flow.CompileOptions(
        fidelity="func", quant={k: QuantParams(v.scale, v.shift)
                                for k, v in q.items()}, **opts))
    img = art.build_gmem_image(w, b, x)
    np.testing.assert_array_equal(img, jart.build_gmem_image(w, b, x))
    rep = art.evaluate("func", gmem_image=img)
    jrep = jart.evaluate("func", gmem_image=img)
    return art, rep, jrep, (w, b, x, q)


def _iss_output(art, rep, gid, sample):
    addr, nb = art.output_addr(gid, sample)
    off = addr - 0x10000000
    return rep.sim.gmem[off:off + nb]


@pytest.mark.parametrize("model,kw", [("tiny_cnn", {"res": 8}),
                                      ("transformer", SMALL_TF)])
def test_func_iss_equals_reference_and_oracle(model, kw):
    art, rep, jrep, (w, b, x, q) = _func_both(
        model, kw, default_chip(n_cores=8, mesh_cols=4),
        j_default_chip(n_cores=8, mesh_cols=4))
    assert rep.backend == "func"
    np.testing.assert_array_equal(rep.sim.gmem, jrep.sim.gmem)
    assert (rep.cycles, rep.energy) == (jrep.cycles, jrep.energy)
    oracle = art.evaluate("func:torch", weights=w, biases=b, inputs=x,
                          quant=q, device=CPU).outputs
    last = len(art.cg) - 1
    for s in range(x.shape[0]):
        np.testing.assert_array_equal(_iss_output(art, rep, last, s),
                                      oracle[last][s].reshape(-1),
                                      err_msg=f"sample {s}")


def test_transformer_func_matches_torch_reference():
    """func-mode output == an *independent* tensor forward pass:
    per-head einsum attention instead of block-diagonal matrices, and
    the integer softmax / layernorm / gelu written out here on int64
    tensors (only the LUTs are shared)."""
    H, dh, seq, d, vocab = 2, 32, 8, 64, 32
    kw = dict(n_layers=1, d_model=d, n_heads=H, seq=seq, vocab=vocab)
    art, rep, _, (w, b, x, q) = _func_both(
        "transformer", kw, default_chip(n_cores=8, mesh_cols=4),
        j_default_chip(n_cores=8, mesh_cols=4), seed=3)
    gid = {grp.name: grp.idx for grp in art.cg}
    exp2 = torch.from_numpy(vecsem.EXP2_LUT)
    gelu = torch.from_numpy(vecsem.GELU_LUT)
    assert not b                          # the LM carries no biases

    def t_quant(acc, g):
        den = 1 << q[g].shift
        v = (acc.to(torch.int64) * q[g].scale + (den >> 1)) // den
        return v.clamp(-128, 127).to(torch.int8)

    def t_lin(v, g):
        wt = torch.from_numpy(w[g]).to(torch.int64)
        return t_quant(v.to(torch.int64) @ wt, g)

    def t_softmax(v):
        vi = v.to(torch.int64)
        dd = (vi.amax(-1, keepdim=True) - vi).clamp(0, 255)
        e = exp2[dd]
        s = e.sum(-1, keepdim=True)
        return ((127 * e + (s >> 1)) // s).clamp(0, 127).to(torch.int8)

    def t_layernorm(v):
        vi = v.to(torch.int64)
        n = v.shape[-1]
        dv = n * vi - vi.sum(-1, keepdim=True)
        ms = (dv * dv).sum(-1, keepdim=True) // n
        r = torch.sqrt(ms.to(torch.float64)).to(torch.int64)
        r = torch.where(r * r > ms, r - 1, r)
        r = torch.where((r + 1) * (r + 1) <= ms, r + 1, r) + 1
        y = (2 * vecsem.LN_GAIN * dv + r) // (2 * r)
        return y.clamp(-128, 127).to(torch.int8)

    def t_sat_add(a, c):
        return (a.to(torch.int16) + c.to(torch.int16)).clamp(
            -128, 127).to(torch.int8)

    def heads(v):                         # (seq, d) -> (H, seq, dh)
        return v.reshape(seq, H, dh).permute(1, 0, 2).to(torch.int64)

    last = len(art.cg) - 1
    for s in range(x.shape[0]):
        e_ = t_lin(torch.from_numpy(x[s]), gid["embed"])
        qv = heads(t_lin(e_, gid["l0.attn.q"]))
        kv = heads(t_lin(e_, gid["l0.attn.k"]))
        vv = heads(t_lin(e_, gid["l0.attn.v"]))
        sc = t_quant(torch.einsum("hmd,hnd->hmn", qv, kv),
                     gid["l0.attn.scores"])
        sm = t_softmax(sc).to(torch.int64)
        ctx = t_quant(torch.einsum("hmn,hnd->hmd", sm, vv),
                      gid["l0.attn.ctx"])
        ctx = ctx.permute(1, 0, 2).reshape(seq, d)
        o = t_lin(ctx, gid["l0.attn.o"])
        x1 = t_layernorm(t_sat_add(o, e_))
        up = gelu[t_lin(x1, gid["l0.up"]).to(torch.int64) + 128]
        x2 = t_layernorm(t_sat_add(t_lin(up, gid["l0.down"]), x1))
        want = t_lin(x2, gid["lm_head"]).numpy().reshape(-1)
        np.testing.assert_array_equal(_iss_output(art, rep, last, s),
                                      want, err_msg=f"sample {s}")


# ---------------------------------------------------------------------------
# randomized straight-line programs: torch == scalar
# ---------------------------------------------------------------------------

_N_CORES = 3

_LOCAL_OPS = [
    lambda d: [I("NOP")],
    lambda d: [I("S_ADDI", dst=d(st.integers(1, 5)), a=0,
                 imm=d(st.integers(-100, 100)))],
    lambda d: [I("S_LUI", dst=d(st.integers(1, 5)),
                 imm=d(st.integers(0, 0xFFFF)))],
    lambda d: [I("S_LD", dst=6, base=1, off=0)],
    lambda d: [I("V_SETVL", len=d(st.integers(1, 200)))],
    lambda d: [I("CIM_CFG", sreg=SREG["V_REP"], imm=d(st.integers(0, 4)))],
    lambda d: [I("V_ADD", dst=1, a=2, b=3)],
    lambda d: [I("V_QUANT", dst=1, a=2, b=0,
                 flags=d(st.sampled_from([0, 4])))],
    lambda d: [I("V_EXP", dst=1, a=2, b=0)],
    lambda d: [I("CIM_CFG", sreg=SREG["MG_NLEN"],
                 imm=d(st.integers(1, 64)))],
    lambda d: [I("CIM_LOAD", mg=d(st.integers(0, 31)), src=1,
                 rows=d(st.integers(1, 128)))],
    lambda d: [I("CIM_CFG", sreg=SREG[d(st.sampled_from(
        ["MG_MASK_LO", "MG_MASK_HI"]))], imm=d(st.integers(0, 0xFFFF)))],
    lambda d: [I("CIM_MVM", dst=1, src=2, rep=d(st.integers(1, 8)),
                 acc=d(st.sampled_from([0, 1])))],
    lambda d: [I("S_ADDI", dst=7, a=0, imm=d(st.integers(1, 300))),
               I("GLD", dst=1, gaddr=2, size=7)],
    lambda d: [I("S_ADDI", dst=8, a=0, imm=d(st.integers(1, 64))),
               I("BCAST", src=1, size=8)],
]


@st.composite
def stage_specs(draw):
    """A random multi-core stage in the decodable subset: sends before
    receives within a phase, one stream per message, an all-core SYNC
    between phases, and optionally no HALT."""
    n_phases = draw(st.integers(1, 2))
    chunks = {c: [] for c in range(_N_CORES)}
    stream = 0
    for phase in range(n_phases):
        sends = {c: [] for c in chunks}
        recvs = {c: [] for c in chunks}
        for _ in range(draw(st.integers(0, 3))):
            src = draw(st.integers(0, _N_CORES - 1))
            dst = draw(st.integers(0, _N_CORES - 1))
            if src == dst:
                continue
            size = draw(st.integers(1, 96))
            sends[src].extend(_send(dst, size, stream))
            recvs[dst].extend(_recv(src, size, stream))
            stream += 1
        for c in chunks:
            ops = []
            for _ in range(draw(st.integers(0, 8))):
                ops.extend(draw(st.sampled_from(_LOCAL_OPS))(draw))
            chunks[c].extend(sends[c] + ops + recvs[c])
            chunks[c].append(I("SYNC", barrier=phase))
    for body in chunks.values():
        if draw(st.booleans()):
            body.append(I("HALT"))
    return chunks


def test_strategy_draws():
    """The strategy itself works (the reference's raises NameError)."""
    spec = find(stage_specs(),
                lambda s: sum(len(b) for b in s.values()) > 12)
    assert sorted(spec) == list(range(_N_CORES))
    assert all(body[-1][0] in ("SYNC", "HALT") for body in spec.values())


@settings(max_examples=25, deadline=None)
@given(stage_specs())
def test_random_programs_identical(spec):
    run_stage_all(spec)


@settings(max_examples=10, deadline=None)
@given(stage_specs())
def test_random_programs_fleet_identical(spec):
    """Fleet decode == each machine's own vector-engine run, exactly;
    == its scalar interpreter to the last ulp (the timing chips load
    weights at a non-dyadic 3 rows per cycle)."""
    chips = _timing_chips(CHIP, 3)
    sp = StageProgram(stage=None, schedules=[],
                      programs=_programs(ISA, Program, spec))
    outs = torchsim.FleetStageDecoder(
        ISA, [machine_for(c) for c in chips], CPU).decode_stage(
            sp.programs)
    for chip, ds in zip(chips, outs):
        out_f = vectorsim.replay_stage(
            Simulator(chip, ISA, engine="torch", device=CPU), sp, ds)
        assert_stage_identical(out_f, vectorsim.run_stage(
            Simulator(chip, ISA, engine="vector"), sp))
        out_s = Simulator(chip, ISA, engine="scalar")._run_stage(sp, None)
        assert out_f[0] == pytest.approx(out_s[0], rel=1e-12)
        assert out_f[1] == out_s[1] and out_f[3] == out_s[3]
