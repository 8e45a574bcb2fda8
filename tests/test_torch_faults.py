"""The port's fault injection (``repro_torch.faults``) against the JAX
package's ``repro.faults``.

* the same ``FaultModel`` resolves to the same stuck-at masks, on numpy
  weights and on tensors, and the tensor hooks (stuck-at weights,
  transient accumulator flips, bit 31 among them) equal the numpy ones;
* the faulty tensor oracle equals the reference's faulty numpy oracle,
  and ``func:torch`` with faults runs with its check on the CPU;
* the functional ISS with corrupted weights or ``PhysicalCimFaults``
  equals the reference's ISS;
* ``degradation_curve`` equals the reference's rows and
  ``BENCH_faults.json``;
* a degraded mesh (``SystemConfig.degrade``) re-plans around its failed
  chips and links as the reference does, and its func runs stay
  bit-exact;
* serving degradation (deadlines, shedding, retries, the saturation
  warning and the ``max_sim_s`` cap) gives the reference's metrics.

Mirrors ``tests/test_faults.py``; the serving tests use a one-layer
model (the reference's two-layer table takes tens of seconds to
compile).  Every comparison is exact (tolerance 0).
"""

import hashlib
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import flow as jflow
from repro.core import ref as jref
from repro.core import workloads as jworkloads
from repro.core.arch import ProtectionConfig as JProtectionConfig
from repro.core.arch import default_chip as j_default_chip
from repro.core.machine import machine_for as j_machine_for
from repro.faults import FaultModel as JFaultModel
from repro.faults import PhysicalCimFaults as JPhysicalCimFaults
from repro.faults import corrupt_gmem as j_corrupt_gmem
from repro.faults import degradation_curve as j_degradation_curve
from repro.faults import residual_rate as j_residual_rate
from repro.faults import resolve_faults as j_resolve_faults
from repro.serve import ServeModelCfg as JServeModelCfg
from repro.serve import ServeSim as JServeSim
from repro.serve import StepCostTable as JStepCostTable
from repro.serve import make_policy as j_make_policy
from repro.serve import metrics_json as j_metrics_json
from repro.system import SystemConfig as JSystemConfig
from repro.system import split_pipeline as j_split_pipeline
from repro_torch import flow
from repro_torch.convert import from_reference
from repro_torch.core import ref, workloads
from repro_torch.core.arch import ProtectionConfig, default_chip
from repro_torch.core.codegen import QuantParams
from repro_torch.core.machine import machine_for
from repro_torch.faults import (FaultModel, PhysicalCimFaults,
                                bit_error_rate, corrupt_gmem,
                                degradation_curve, residual_rate,
                                resolve_faults, top1_agreement)
from repro_torch.serve import (ServeModelCfg, ServeSim, StepCostTable,
                               make_policy, metrics_json, poisson_trace)
from repro_torch.system import SystemConfig, split_pipeline
from repro_torch.system.passes import SystemPartitionPass

torch.set_num_threads(1)

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
KW = dict(res=8, c=8)
RNG = np.random.default_rng(11)


def _tiny_setup(batch=2, seed=3):
    """The reference's state, and the same state as the port's tensors."""
    jcg = jworkloads.build("tiny_cnn", **KW).condense()
    cg = workloads.build("tiny_cnn", **KW).condense()
    w, b, x = jref.random_init(jcg, batch=batch, seed=seed)
    q = jref.auto_quant(jcg, w, b, x)
    return jcg, cg, (w, b, x, q), from_reference(w, b, x, q, CPU)


def _both_fault_sets(weights, tweights, **fm):
    return (j_resolve_faults(weights, j_default_chip(), JFaultModel(**fm)),
            resolve_faults(tweights, default_chip(), FaultModel(**fm)))


def _same_masks(jfs, fs):
    assert fs.counts == jfs.counts
    assert sorted(fs.stuck) == sorted(jfs.stuck)
    for gid, (o, a) in jfs.stuck.items():
        np.testing.assert_array_equal(fs.stuck[gid][0], o)
        np.testing.assert_array_equal(fs.stuck[gid][1], a)


# ---------------------------------------------------------------------------
# fault models and fault sets
# ---------------------------------------------------------------------------


def test_fault_model_validation_and_roundtrip():
    for bad in (dict(rate=1.5), dict(transient_rate=-0.1), dict(seed=-1)):
        with pytest.raises(ValueError):
            FaultModel(**bad)
    kw = dict(rate=1e-3, gmem_rate=1e-6, seed=9, failed_chips=(3, 1),
              failed_links=((2, 0),))
    fm = FaultModel(**kw)
    assert fm.failed_chips == (1, 3)          # normalized sorted
    assert fm.failed_links == ((0, 2),)
    assert FaultModel.from_dict(fm.to_dict()) == fm
    assert fm.to_dict() == JFaultModel(**kw).to_dict()
    assert FaultModel().is_null and not fm.is_null


@pytest.mark.parametrize("rate,seed", [(2e-3, 42), (2e-3, 43), (5e-3, 1),
                                       (2e-2, 0)])
def test_resolve_faults_masks_equal_reference(rate, seed):
    _, _, (w, *_), (tw, *_) = _tiny_setup()
    jfs, fs = _both_fault_sets(w, tw, rate=rate, seed=seed)
    assert fs.n_stuck > 0
    _same_masks(jfs, fs)
    # numpy weights resolve to the same set as tensors, every time
    _same_masks(jfs, resolve_faults(w, default_chip(),
                                    FaultModel(rate=rate, seed=seed)))


def test_corruption_idempotent_and_equal_on_tensors():
    """Stuck-at faults pin bits: applying the masks twice == once, and
    a tensor is corrupted as its numpy array is."""
    _, _, (w, *_), (tw, *_) = _tiny_setup()
    jfs, fs = _both_fault_sets(w, tw, rate=5e-3, seed=1)
    for gid, wt in tw.items():
        once = fs.corrupt_weight_matrix(gid, wt)
        twice = fs.corrupt_weight_matrix(gid, once)
        assert once.dtype == torch.int8 and torch.equal(once, twice)
        np.testing.assert_array_equal(
            once.numpy(), jfs.corrupt_weight_matrix(gid, w[gid]))
        np.testing.assert_array_equal(
            fs.corrupt_weight_matrix(gid, w[gid]), once.numpy())
    # the masks moved to the tensors' device once per set
    assert {d for _, d in fs._on_device} == {torch.device(CPU)}
    assert len(fs._on_device) == len(fs.stuck)
    with pytest.raises(ValueError):
        gid = next(iter(fs.stuck))
        fs.corrupt_weight_matrix(gid, tw[gid][:-1])


def test_rate_zero_is_exact_noop():
    _, cg, _, (tw, tb, tx, tq) = _tiny_setup()
    fm = FaultModel(rate=0.0)
    fs = resolve_faults(tw, default_chip(), fm)
    assert fs.n_stuck == 0 and not fs.stuck
    clean = ref.run_reference(cg, tw, tb, tq, tx)
    faulty = ref.run_reference(cg, tw, tb, tq, tx, faults=fs)
    for gid in clean:
        assert torch.equal(clean[gid], faulty[gid])
    img = RNG.integers(-128, 128, 4096).astype(np.int8)
    np.testing.assert_array_equal(corrupt_gmem(img, fm), img)
    acc = torch.from_numpy(RNG.integers(-1000, 1000, (7, 5)).astype(
        np.int32))
    assert torch.equal(fs.corrupt_acc(acc, 0, 0), acc)


def test_corrupt_acc_tensor_equals_numpy_with_bit31():
    """Transient flips on an int32 tensor equal the reference's
    ``np.bitwise_xor.at``: words that take several flips, and bit 31."""
    fs = resolve_faults({}, default_chip(),
                        FaultModel(transient_rate=2e-2, seed=5))
    jfs = j_resolve_faults({}, j_default_chip(),
                           JFaultModel(transient_rate=2e-2, seed=5))
    acc = RNG.integers(-2**31, 2**31, (50, 40)).astype(np.int32)
    bit31 = 0
    for gid, sample in [(0, 0), (1, 0), (1, 3), (7, 2)]:
        want = jfs.corrupt_acc(acc, gid, sample)
        got = fs.corrupt_acc(torch.from_numpy(acc), gid, sample)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(fs.corrupt_acc(acc, gid, sample),
                                      want)
        flipped = (want ^ acc).view(np.uint32)
        bit31 += int(((flipped >> 31) & 1).sum())
        assert (np.unpackbits(flipped.view(np.uint8)).reshape(-1, 32)
                .sum(1) > 1).any()            # several flips in one word
    assert bit31 > 0


# ---------------------------------------------------------------------------
# the faulty oracle and func:torch against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fm", [dict(rate=5e-3, seed=5),
                                dict(transient_rate=1e-3, seed=7),
                                dict(rate=2e-2, transient_rate=2e-2,
                                     seed=11)],
                         ids=["stuck", "transient", "both"])
def test_run_reference_faults_equal_reference(fm):
    jcg, cg, (w, b, x, q), (tw, tb, tx, tq) = _tiny_setup()
    jfs, fs = _both_fault_sets(w, tw, **fm)
    want = jref.run_reference(jcg, w, b, q, x, faults=jfs)
    got = ref.run_reference(cg, tw, tb, tq, tx, faults=fs)
    clean = jref.run_reference(jcg, w, b, q, x)
    assert any(not np.array_equal(want[g], clean[g]) for g in want)
    for gid in want:
        np.testing.assert_array_equal(got[gid].numpy(), want[gid])
    # deterministic per sample: the same set, the same outputs
    again = ref.run_reference(cg, tw, tb, tq, tx, faults=fs)
    for gid in got:
        assert torch.equal(got[gid], again[gid])


def test_func_torch_with_faults_on_cpu():
    """``func:torch`` corrupts both oracles alike, so ``check=True``
    holds on a faulty run; its outputs equal the reference's faulty
    oracle."""
    jcg, _, (w, b, x, q), (tw, *_) = _tiny_setup()
    jfs, fs = _both_fault_sets(w, tw, rate=2e-2, transient_rate=1e-3,
                               seed=2)
    art = flow.compile("tiny_cnn", default_chip(),
                       flow.CompileOptions(batch=2, workload_kw=KW))
    rep = art.evaluate("func:torch", weights=w, biases=b, inputs=x,
                       quant=q, check=True, faults=fs, device=CPU)
    want = jref.run_reference(jcg, w, b, q, x, faults=jfs)
    for gid in want:
        np.testing.assert_array_equal(rep.outputs[gid], want[gid])


# ---------------------------------------------------------------------------
# the functional ISS under faults
# ---------------------------------------------------------------------------


def _func_artifacts(q):
    chip = default_chip(n_cores=8, mesh_cols=4)
    jchip = j_default_chip(n_cores=8, mesh_cols=4)
    opts = dict(strategy="dp", batch=2, workload_kw=KW, strict_lmem=True,
                fidelity="func")
    art = flow.compile("tiny_cnn", chip, flow.CompileOptions(
        quant={k: QuantParams(v.scale, v.shift) for k, v in q.items()},
        **opts))
    jart = jflow.compile("tiny_cnn", jchip, jflow.CompileOptions(
        quant=q, **opts))
    return chip, jchip, art, jart


def test_oracle_vs_func_iss_bit_identical_under_faults():
    """The same logical fault set corrupts the tensor oracle and the
    gmem image the ISS executes: the ISS output equals the oracle's
    and the reference ISS's, bit for bit."""
    jcg, cg, (w, b, x, q), (tw, tb, tx, tq) = _tiny_setup()
    chip, jchip, art, jart = _func_artifacts(q)
    fs = resolve_faults(tw, chip, FaultModel(rate=2e-3, seed=5))
    jfs = j_resolve_faults(w, jchip, JFaultModel(rate=2e-3, seed=5))
    assert fs.n_stuck > 0
    _same_masks(jfs, fs)
    oracle = ref.run_reference(cg, tw, tb, tq, tx, faults=fs)
    img = art.build_gmem_image(fs.corrupt_weights(w), b, x)
    rep = art.evaluate("func", gmem_image=img)
    jrep = jart.evaluate("func", gmem_image=jart.build_gmem_image(
        jfs.corrupt_weights(w), b, x))
    np.testing.assert_array_equal(rep.sim.gmem, jrep.sim.gmem)
    last = len(cg) - 1
    for s in range(2):
        addr, nb = art.output_addr(last, s)
        got = rep.sim.gmem[addr - 0x10000000: addr - 0x10000000 + nb]
        want = oracle[last][s].reshape(-1).numpy()
        np.testing.assert_array_equal(got, want.view(np.int8)[:nb])


def test_physical_iss_hook_equals_reference():
    """Physical (core, mg) stuck bits at CIM_LOAD: the port's ISS equals
    the reference's; same seed -> same outputs; rate=0 -> bit-identical
    to the fault-free run; timing never depends on the data."""
    _, _, (w, b, x, q), _ = _tiny_setup()
    chip, jchip, art, jart = _func_artifacts(q)
    img = art.build_gmem_image(w, b, x)

    def run(faults):
        return art.evaluate("func", gmem_image=img, faults=faults).sim

    base = run(None)
    null = run(PhysicalCimFaults(chip, FaultModel(rate=0.0)))
    np.testing.assert_array_equal(base.gmem, null.gmem)
    fm = dict(rate=5e-3, seed=13)
    a = run(PhysicalCimFaults(chip, FaultModel(**fm)))
    b2 = run(PhysicalCimFaults(chip, FaultModel(**fm)))
    np.testing.assert_array_equal(a.gmem, b2.gmem)
    assert not np.array_equal(a.gmem, base.gmem)
    assert a.cycles == base.cycles
    ja = jart.evaluate("func", gmem_image=img,
                       faults=JPhysicalCimFaults(jchip, JFaultModel(**fm)))
    np.testing.assert_array_equal(a.gmem, ja.sim.gmem)
    assert a.cycles == ja.cycles


def test_gmem_corruption_equals_reference():
    img = RNG.integers(-128, 128, 1 << 14).astype(np.int8)
    a = corrupt_gmem(img, FaultModel(gmem_rate=1e-3, seed=2))
    np.testing.assert_array_equal(
        a, j_corrupt_gmem(img, JFaultModel(gmem_rate=1e-3, seed=2)))
    assert not np.array_equal(a, img)
    xor = (a ^ img).view(np.uint32)
    bits = np.unpackbits(xor.view(np.uint8)).reshape(-1, 32).sum(1)
    assert bits.max() == 1


def test_residual_rates_and_protection_costs():
    macro = default_chip().core.cim.macro
    jmacro = j_default_chip().core.cim.macro
    p = 1e-3
    assert residual_rate(p, ProtectionConfig(), macro) == p
    for kw in (dict(tmr=True), dict(ecc=True), dict(spare_rows=4),
               dict(ecc=True, spare_rows=4, tmr=True)):
        got = residual_rate(p, ProtectionConfig(**kw), macro)
        assert 0.0 <= got < p
        assert got == j_residual_rate(p, JProtectionConfig(**kw), jmacro)
    sp = ProtectionConfig(spare_rows=4)
    assert residual_rate(p, sp, macro, transient=True) == p
    full = dict(ecc=True, spare_rows=4, tmr=True)
    hard = machine_for(default_chip(protection=ProtectionConfig(**full)))
    jhard = j_machine_for(j_default_chip(
        protection=JProtectionConfig(**full)))
    assert (hard.weight_load_factor, hard.protection_area_factor,
            hard.mvm_fill_beats) == (jhard.weight_load_factor,
                                     jhard.protection_area_factor,
                                     jhard.mvm_fill_beats)
    fm = FaultModel(rate=p, transient_rate=p)
    mit = fm.mitigated(hard.chip)
    assert mit.rate < fm.rate and mit.transient_rate < fm.transient_rate
    assert mit.to_dict() == JFaultModel(rate=p, transient_rate=p) \
        .mitigated(jhard.chip).to_dict()


# ---------------------------------------------------------------------------
# degradation curves
# ---------------------------------------------------------------------------


def test_degradation_curve_equals_reference_and_golden():
    """The configuration ``benchmarks/bench_faults.py`` pins: the rows
    equal the reference's and ``BENCH_faults.json``'s, and the clean
    outputs hash to its ``clean_identity``."""
    golden = json.loads((ROOT / "BENCH_faults.json").read_text())
    rates = [r["rate"] for r in golden["degradation"]]
    cg = workloads.build("tiny_cnn", **KW).condense()
    rows = degradation_curve(cg, default_chip(), rates, batch=2, seed=0,
                             device=CPU)
    assert rows == golden["degradation"]
    jcg = jworkloads.build("tiny_cnn", **KW).condense()
    assert rows == j_degradation_curve(jcg, j_default_chip(), rates,
                                       batch=2, seed=0)
    assert rows[0]["n_stuck"] == 0 and rows[0]["ber"] == 0.0
    assert rows[-1]["n_stuck"] > 0 and rows[-1]["ber"] > 0.0

    w, b, x = ref.random_init(cg, batch=2, seed=0, device=CPU)
    clean = ref.run_reference(cg, w, b, ref.auto_quant(cg, w, b, x), x)
    h = hashlib.sha256()
    for gid in sorted(clean):
        h.update(np.ascontiguousarray(clean[gid].numpy()).tobytes())
    assert h.hexdigest() == golden["clean_identity"]["output_sha256"]
    assert bit_error_rate(clean[0].numpy(), clean[0].numpy()) == 0.0
    last = clean[len(cg) - 1].numpy()
    assert top1_agreement(last, last) == 1.0


def test_degradation_curve_transient_base():
    """``base`` carries the transient rate into every step."""
    cg = workloads.build("tiny_cnn", **KW).condense()
    jcg = jworkloads.build("tiny_cnn", **KW).condense()
    kw = dict(batch=2, seed=1)
    got = degradation_curve(cg, default_chip(), [0.0, 1e-2],
                            base=FaultModel(transient_rate=1e-3, seed=4),
                            device=CPU, **kw)
    want = j_degradation_curve(jcg, j_default_chip(), [0.0, 1e-2],
                               base=JFaultModel(transient_rate=1e-3,
                                                seed=4), **kw)
    assert got == want and got[0]["ber"] > 0.0


# ---------------------------------------------------------------------------
# mesh failover
# ---------------------------------------------------------------------------


def test_degraded_mesh_replan_conserves_work():
    cg = workloads.build("transformer").condense()
    sysc = SystemConfig.mesh(4).degrade(failed_chips=(2,))
    assert sysc.alive_slots == (0, 1, 3) and sysc.n_alive == 3
    plan = split_pipeline(cg, default_chip(), sysc)
    assert plan.total_macs() == cg.total_macs
    assert all(s.mesh_slot != 2 for s in plan.slices)
    covered = [g for s in plan.slices for g in s.gids]
    assert covered == list(range(len(cg)))
    jplan = j_split_pipeline(
        jworkloads.build("transformer").condense(), j_default_chip(),
        JSystemConfig.mesh(4).degrade(failed_chips=(2,)))
    dump = SystemPartitionPass("pipeline").dump
    assert dump(plan) == dump(jplan)
    assert [s.mesh_slot for s in plan.slices] == \
        [s.mesh_slot for s in jplan.slices]


def test_degraded_mesh_func_bit_exact_tiny_cnn():
    """1 failed chip of a 2x2 mesh: the re-planned pipeline runs
    func-mode bit-exact against the port's oracle and the reference's
    ``run_func``; the degraded report equals the reference's."""
    sysc = SystemConfig.mesh(4).degrade(failed_chips=(1,))
    jsysc = JSystemConfig.mesh(4).degrade(failed_chips=(1,))
    art = flow.compile("tiny_cnn", default_chip(), flow.CompileOptions(
        fidelity="func", batch=2, system=sysc))
    jart = jflow.compile("tiny_cnn", j_default_chip(), jflow.CompileOptions(
        fidelity="func", batch=2, system=jsysc))
    assert art.n_chips <= 3 and art.n_chips == jart.n_chips
    w, b, x = jref.random_init(jart.cg, batch=2, seed=17)
    q = jref.auto_quant(jart.cg, w, b, x)
    got = art.run_func(w, b, x, quant=q)
    np.testing.assert_array_equal(got.final,
                                  jart.run_func(w, b, x, quant=q).final)
    tw, tb, tx, tq = from_reference(w, b, x, q, CPU)
    oracle = ref.run_reference(art.cg, tw, tb, tq, tx)
    last = len(art.cg) - 1
    for s in range(2):
        np.testing.assert_array_equal(got.final[s],
                                      oracle[last][s].reshape(-1).numpy())
    rep = flow.compile("tiny_cnn", default_chip(), flow.CompileOptions(
        fidelity="analytic", batch=2, system=sysc)).evaluate()
    jrep = jflow.compile("tiny_cnn", j_default_chip(), jflow.CompileOptions(
        fidelity="analytic", batch=2, system=jsysc)).evaluate()
    assert rep.degraded and rep.n_failed_chips == 1
    assert rep.throughput_sps > 0
    assert (rep.cycles, rep.comm_cycles, rep.energy, rep.throughput_sps) \
        == (jrep.cycles, jrep.comm_cycles, jrep.energy, jrep.throughput_sps)


def test_failed_link_routes_around():
    sysc = SystemConfig(chips_x=2, chips_y=2, failed_links=((0, 1),))
    assert sysc.hops(0, 1) == 3
    jsysc = JSystemConfig(chips_x=2, chips_y=2, failed_links=((0, 1),))
    assert [sysc.hops(a, b) for a in range(4) for b in range(4)] == \
        [jsysc.hops(a, b) for a in range(4) for b in range(4)]
    assert sysc.to_dict() == jsysc.to_dict()
    with pytest.raises(ValueError):
        SystemConfig(chips_x=1, chips_y=1, failed_chips=(0,))
    # a fault model's failed chips and links degrade a mesh
    fm = FaultModel(failed_chips=(3,), failed_links=((1, 0),))
    deg = SystemConfig.mesh(4).degrade(fm.failed_chips, fm.failed_links)
    assert deg.failed_chips == (3,) and deg.failed_links == ((0, 1),)


# ---------------------------------------------------------------------------
# serving degradation
# ---------------------------------------------------------------------------

# one layer at d_model 128: its analytic table compiles in seconds and
# 300k req/s is still well over its prefill capacity
SERVE_CFG = dict(n_layers=1, d_model=128, n_heads=4, vocab=256)
SERVE_KW = dict(deadline_s=0.002, max_queue=4, max_retries=2,
                retry_backoff_s=0.0005)


@pytest.fixture(scope="module")
def serve_tables():
    table = StepCostTable(ServeModelCfg(**SERVE_CFG), fidelity="analytic")
    jtable = JStepCostTable(JServeModelCfg(**SERVE_CFG),
                            fidelity="analytic")
    assert table.to_dict() == jtable.to_dict()
    return table, jtable


def test_serving_default_path_unchanged(serve_tables):
    table, jtable = serve_tables
    tr = poisson_trace(rate=8.0, n=40, seed=0)
    m = ServeSim(table, make_policy("continuous", 8)).run(tr)
    for k in ("shed_requests", "timeout_requests", "retries",
              "goodput_tok_s"):
        assert k not in m
    m2 = ServeSim(table, make_policy("continuous", 8),
                  deadline_s=1e9, max_queue=10 ** 9).run(tr)
    assert m2["shed_requests"] == 0 and m2["timeout_requests"] == 0
    for k in m:
        assert m[k] == m2[k]
    jm = JServeSim(jtable, j_make_policy("continuous", 8)).run(tr)
    assert metrics_json(m) == j_metrics_json(jm)


def test_serving_degradation_counters_byte_stable(serve_tables):
    table, jtable = serve_tables
    hot = poisson_trace(rate=300000.0, n=200, seed=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        a = ServeSim(table, make_policy("continuous", 8),
                     **SERVE_KW).run(hot)
        b = ServeSim(table, make_policy("continuous", 8),
                     **SERVE_KW).run(hot)
        j = JServeSim(jtable, j_make_policy("continuous", 8),
                      **SERVE_KW).run(hot)
    assert a["shed_requests"] > 0
    assert a["timeout_requests"] > 0
    assert a["retries"] > 0
    assert a["goodput_tok_s"] < a["throughput_tok_s"]
    assert a["requests"] + a["shed_requests"] == len(hot)
    assert metrics_json(a) == metrics_json(b) == j_metrics_json(j)
    json.loads(metrics_json(a))


def test_serving_saturation_warning_and_cap(serve_tables):
    table, jtable = serve_tables
    hot = poisson_trace(rate=300000.0, n=100, seed=2)
    msgs = []
    for sim in (ServeSim(table, make_policy("continuous", 8)),
                JServeSim(jtable, j_make_policy("continuous", 8))):
        with pytest.warns(RuntimeWarning, match="saturated") as rec:
            sim.run(hot)
        with pytest.raises(RuntimeError, match="max_sim_s") as err:
            sim.run(hot, max_sim_s=1e-4)
        msgs.append(([str(r.message) for r in rec], str(err.value)))
    assert msgs[0] == msgs[1]
