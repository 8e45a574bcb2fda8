"""The port's serving simulator (``repro_torch.serve``) against the JAX
package's ``repro.serve``.

* bucketing, percentiles and the trace generators give the reference's
  values; ``VecMT`` is bit-identical to CPython's ``random`` and to the
  reference's; traces round-trip between the two packages;
* the event and array replay engines give byte-identical metrics JSON,
  and that JSON is byte-identical to the reference's for the same trace,
  table and policy (the committed trace, the degradation config, KV
  pressure, batch widths, bursty and tiny traces, the prefill policies,
  streaming percentiles);
* step-cost tables compiled at ``trace`` fidelity equal the reference's
  (``to_dict()`` and table key), and at ``simulate`` with the stage
  decode on the CPU equal the reference's ``vector`` engine, on one chip
  and on a 2-chip pipeline mesh;
* the CLI prints the reference's report and writes its JSON.

Mirrors ``tests/test_serve.py`` and ``tests/test_serve_engines.py`` on
small tables.  Every comparison is exact (tolerance 0).
"""

import contextlib
import io
import json
import os
import random
import warnings

import numpy as np
import pytest
import torch

from repro.serve import ServeModelCfg as JServeModelCfg
from repro.serve import ServeSim as JServeSim
from repro.serve import StepCostTable as JStepCostTable
from repro.serve import VecMT as JVecMT
from repro.serve import bucket_batch_sizes as j_bucket_batch_sizes
from repro.serve import bucket_boundaries as j_bucket_boundaries
from repro.serve import bursty_trace as j_bursty_trace
from repro.serve import load_trace as j_load_trace
from repro.serve import make_policy as j_make_policy
from repro.serve import metrics_json as j_metrics_json
from repro.serve import poisson_trace as j_poisson_trace
from repro.serve import poisson_trace_arrays as j_poisson_trace_arrays
from repro.serve import save_trace as j_save_trace
from repro.serve.__main__ import main as j_main
from repro.system import SystemConfig as JSystemConfig
from repro_torch.serve import (ServeModelCfg, ServeSim, StepCostTable,
                               StreamingPercentiles, VecMT,
                               bucket_batch_sizes, bucket_boundaries,
                               bucket_for, bursty_trace, group_by_bucket,
                               load_trace, make_policy, metrics_json,
                               percentile, poisson_trace,
                               poisson_trace_arrays, save_trace, summarize,
                               summarize_soa)
from repro_torch.serve.__main__ import main
from repro_torch.serve.metrics import RequestRecord
from repro_torch.serve.rng import uniform_randbelow_batch
from repro_torch.serve.trace_replay import (_bursty_trace_scalar,
                                            _poisson_trace_scalar)
from repro_torch.system import SystemConfig

pytestmark = pytest.mark.filterwarnings(
    "ignore:perf-mode lmem overflow:RuntimeWarning")

torch.set_num_threads(1)

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_PATH = os.path.join(ROOT, "benchmarks", "serving_trace.json")
# the degradation config of benchmarks/bench_faults.py serving_overload
FAULT_KW = dict(deadline_s=0.002, max_queue=4, max_retries=2,
                retry_backoff_s=0.0005)
# the small compiled model of tests/test_serve.py
TINY = dict(n_layers=1, d_model=64, n_heads=2, vocab=64, max_prompt=16,
            max_new=16)


def _costs(max_new=64, decode_base=30e-6, decode_per=2e-6):
    """``from_costs`` arguments of tests/test_serve_engines.py's table."""
    pb = [1, 2, 4, 8, 16, 32, 64]
    db, b = [], 1
    while b < 64 + max_new:
        db.append(b)
        b *= 2
    db.append(64 + max_new)
    return dict(
        prefill_s={b: 2e-6 * b for b in pb},
        decode_base_s={b: decode_base + 0.01e-6 * b for b in db},
        decode_per_seq_s={b: decode_per + 0.002e-6 * b for b in db},
        prefill_base_s={b: 1.5e-6 * b for b in pb},
        prefill_per_seq_s={b: 0.5e-6 * b for b in pb})


def _tables(max_new=64, **kw):
    """The same synthetic table in the port and in the reference."""
    costs = _costs(max_new, **kw)
    return (StepCostTable.from_costs(
                ServeModelCfg(max_prompt=64, max_new=max_new), **costs),
            JStepCostTable.from_costs(
                JServeModelCfg(max_prompt=64, max_new=max_new), **costs))


def _run(sim_cls, policy_fn, table, trace, policy="continuous",
         max_batch=8, max_sim_s=None, **kw):
    sim = sim_cls(table, policy_fn(policy, max_batch), **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return sim.run(trace, max_sim_s=max_sim_s)


def _port(table, trace, policy="continuous", **kw):
    return _run(ServeSim, make_policy, table, trace, policy, **kw)


def _ref(table, trace, policy="continuous", **kw):
    return _run(JServeSim, j_make_policy, table, trace, policy, **kw)


def _assert_equiv_and_reference(tables, trace, policy="continuous", **kw):
    """The port's event and array engines and the reference's array
    engine give one metrics JSON (modulo the ``engine`` key)."""
    table, jtable = tables
    out = {}
    for eng in ("event", "array"):
        m = dict(_port(table, trace, policy, engine=eng, **kw))
        assert m.pop("engine") == eng
        out[eng] = metrics_json(m)
    m = dict(_ref(jtable, trace, policy, engine="array", **kw))
    m.pop("engine")
    out["reference"] = j_metrics_json(m)
    assert out["event"] == out["array"] == out["reference"]
    return json.loads(out["array"])


# --------------------------------------------------------------------
# bucketing and percentiles
# --------------------------------------------------------------------

def test_bucket_boundaries_cover_range():
    bs = bucket_boundaries(100, min_length=8, step=1.25)
    assert bs[0] == 8 and bs[-1] == 100
    assert all(b2 > b1 for b1, b2 in zip(bs, bs[1:]))
    for args in ((100, 8, 1.25), (128, 8, 2.0), (4,), (1000, 3, 1.1)):
        assert bucket_boundaries(*args) == j_bucket_boundaries(*args)


def test_bucket_boundaries_small_max():
    assert bucket_boundaries(4) == [4]
    with pytest.raises(ValueError):
        bucket_boundaries(0)
    with pytest.raises(ValueError):
        bucket_boundaries(16, step=1.0)


def test_bucket_for_edges():
    bs = [8, 16, 32]
    assert [bucket_for(n, bs) for n in (0, 8, 9, 32)] == [8, 8, 16, 32]
    for n in (33, -1):
        with pytest.raises(ValueError):
            bucket_for(n, bs)


def test_bucket_batch_sizes_token_budget():
    sizes = bucket_batch_sizes([8, 16, 32], tokens_per_batch=64,
                               max_batch=16)
    assert sizes == {8: 8, 16: 4, 32: 2}
    assert bucket_batch_sizes([128], 64, 16) == {128: 1}
    assert sizes == j_bucket_batch_sizes([8, 16, 32], 64, 16)


def test_group_by_bucket():
    assert group_by_bucket([3, 9, 20, 8], [8, 16, 32]) == \
        {8: [0, 3], 16: [1], 32: [2]}


def test_percentile_interpolation():
    xs = [1.0, 2.0, 3.0, 4.0]
    assert percentile(xs, 0) == 1.0
    assert percentile(xs, 100) == 4.0
    assert percentile(xs, 50) == pytest.approx(2.5)
    assert percentile([], 99) == 0.0


def test_summarize_soa_matches_records():
    rng = random.Random(5)
    recs = []
    for i in range(200):
        ta = rng.random()
        pre = ta + rng.random() * 0.01
        first = pre + rng.random() * 0.01
        gen = rng.randint(1, 64)
        recs.append(RequestRecord(
            rid=i, t_arrive=ta, prompt_len=rng.randint(4, 64),
            gen_len=gen, t_prefill_start=pre, t_first_token=first,
            t_complete=first + (gen - 1) * 2e-5))
    a = summarize(recs, extra={"k": 1})
    b = summarize_soa(
        np.array([r.t_arrive for r in recs]),
        np.array([r.gen_len for r in recs]),
        np.array([r.t_first_token for r in recs]),
        np.array([r.t_complete for r in recs]),
        extra={"k": 1})
    assert metrics_json(a) == metrics_json(b)


def test_streaming_percentiles():
    sp = StreamingPercentiles()
    sp.extend([3.0, 1.0, 2.0])
    assert sp.get(50) == 2.0
    rng = random.Random(0)
    xs = [rng.gauss(10.0, 2.0) for _ in range(20_000)]
    sp = StreamingPercentiles()
    sp.extend(xs)
    for q in (50, 95, 99):
        assert sp.get(q) == pytest.approx(percentile(xs, q), rel=0.02)


# --------------------------------------------------------------------
# trace generators and the MT19937 stream
# --------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_poisson_trace_matches_scalar_and_reference(seed):
    got = poisson_trace(5000.0, 200, seed=seed)
    assert got == _poisson_trace_scalar(5000.0, 200, seed=seed)
    assert [tuple(vars(r).values()) for r in got] == \
        [tuple(vars(r).values()) for r in j_poisson_trace(5000.0, 200,
                                                          seed=seed)]


def test_poisson_trace_committed_params_bitexact():
    vec = poisson_trace(5000.0, 200, seed=0, max_prompt=64, max_new=64)
    assert vec == load_trace(TRACE_PATH)
    t, p, g = poisson_trace_arrays(7000.0, 500, seed=4)
    jt, jp, jg = j_poisson_trace_arrays(7000.0, 500, seed=4)
    for a, b in ((t, jt), (p, jp), (g, jg)):
        np.testing.assert_array_equal(a, b)
    reqs = poisson_trace(7000.0, 500, seed=4)
    assert t.tolist() == [r.t_arrive for r in reqs]
    assert g.tolist() == [r.gen_len for r in reqs]


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_bursty_trace_matches_scalar_and_reference(seed):
    got = bursty_trace(4000.0, 150, seed=seed)
    assert got == _bursty_trace_scalar(4000.0, 150, seed=seed)
    assert [tuple(vars(r).values()) for r in got] == \
        [tuple(vars(r).values()) for r in j_bursty_trace(4000.0, 150,
                                                         seed=seed)]
    # the phase-edge case of the reference suite terminates
    assert bursty_trace(8.0, 100, seed=0, burst=3.0) == \
        _bursty_trace_scalar(8.0, 100, seed=0, burst=3.0)


def test_trace_generators_deterministic_and_roundtrip(tmp_path):
    a = poisson_trace(100.0, 50, seed=7)
    assert a == poisson_trace(100.0, 50, seed=7)
    assert poisson_trace(100.0, 50, seed=8) != a
    assert bursty_trace(100.0, 50, seed=7) == bursty_trace(100.0, 50,
                                                           seed=7)
    path, jpath = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    save_trace(path, a[:20])
    j_save_trace(jpath, j_poisson_trace(100.0, 50, seed=7)[:20])
    assert open(path).read() == open(jpath).read()
    assert load_trace(jpath) == a[:20]
    assert [tuple(vars(r).values()) for r in j_load_trace(path)] == \
        [tuple(vars(r).values()) for r in a[:20]]
    with pytest.raises(ValueError):
        bursty_trace(100.0, 10, duty=0.0)
    with pytest.raises(ValueError):
        bursty_trace(100.0, 10, burst=10.0, duty=0.5)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 33 + 7])
def test_vecmt_bit_identical_to_cpython(seed):
    words = VecMT(seed).peek(2000)
    ref = random.Random(seed)
    assert words.tolist() == [ref.getrandbits(32) for _ in range(2000)]
    np.testing.assert_array_equal(words, JVecMT(seed).peek(2000))


def test_vecmt_consume_splices_with_cpython_stream():
    mt = VecMT(42)
    n = 137
    u, (a, b) = uniform_randbelow_batch(mt, n, (61, 61))
    ref = random.Random(42)
    for _ in range(n):
        ref.random()
        ref.randint(0, 60)
        ref.randint(0, 60)
    assert u[0] != u[-1]
    assert mt.consumed > 0
    assert mt.peek(2)[0] == ref.getrandbits(32)


# --------------------------------------------------------------------
# replay engines: event == array == the reference
# --------------------------------------------------------------------

_CASES = {
    "committed-static": lambda: (load_trace(TRACE_PATH), "static", {}),
    "committed-continuous": lambda: (load_trace(TRACE_PATH), "continuous",
                                     {}),
    "degraded": lambda: (poisson_trace(300000.0, 200, seed=1),
                         "continuous", FAULT_KW),
    "batch-1": lambda: (poisson_trace(50000.0, 300, seed=7), "continuous",
                        {"max_batch": 1}),
    "batch-32": lambda: (poisson_trace(50000.0, 300, seed=7),
                         "continuous", {"max_batch": 32}),
    "bursty-static": lambda: (bursty_trace(20000.0, 300, seed=3), "static",
                              {}),
    "bursty-continuous": lambda: (bursty_trace(20000.0, 300, seed=3),
                                  "continuous", {}),
    "one-request": lambda: (poisson_trace(1000.0, 1, seed=0), "continuous",
                            {}),
    "single-token": lambda: (poisson_trace(1000.0, 20, seed=2, min_new=1,
                                           max_new=1), "continuous", {}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_engines_byte_identical_to_reference(case):
    trace, policy, kw = _CASES[case]()
    m = _assert_equiv_and_reference(_tables(), trace, policy, **kw)
    if case == "degraded":
        assert m["shed_requests"] > 0 and m["timeout_requests"] > 0


@pytest.mark.parametrize("policy", ["static", "continuous"])
def test_kv_pressure_byte_identical_to_reference(policy):
    tables = _tables(max_new=1024)
    cap = tables[0].cfg.kv_bytes(tables[0].cfg.max_seq) * 4
    tr = poisson_trace(3000.0, 400, seed=5, min_prompt=4, max_prompt=64,
                       min_new=16, max_new=1024)
    _assert_equiv_and_reference(tables, tr, policy, kv_capacity_bytes=cap)


def test_overload_diagnostic_parity():
    table, jtable = _tables(max_new=1024)
    tr = poisson_trace(1e6, 2000, seed=3, min_new=16, max_new=1024)
    msgs = []
    for eng in ("event", "array"):
        with pytest.raises(RuntimeError) as ei:
            _port(table, tr, engine=eng, max_sim_s=0.5)
        msgs.append(str(ei.value))
    with pytest.raises(RuntimeError) as ei:
        _ref(jtable, tr, engine="array", max_sim_s=0.5)
    msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] == msgs[2]


@pytest.mark.parametrize("prefill", ["fifo", "batched", "chunked"])
def test_prefill_policies_equal_reference(prefill):
    table, jtable = _tables(max_new=8, decode_base=10e-6, decode_per=1e-6)
    tr = poisson_trace(9000.0, 2000, seed=11, min_prompt=33,
                       max_prompt=64, min_new=2, max_new=8)
    kw = dict(max_batch=16, prefill_policy=prefill, chunk_tokens=64,
              prefill_max_batch=8)
    got = _port(table, tr, **kw)
    assert metrics_json(got) == j_metrics_json(_ref(jtable, tr, **kw))
    if prefill != "fifo":
        fifo = _port(table, tr, max_batch=16)
        assert got["ttft_s"]["p99"] < fifo["ttft_s"]["p99"]
        assert got["tokens"] == fifo["tokens"]


def test_streaming_mode_and_validation_equal_reference():
    table, jtable = _tables()
    tr = poisson_trace(5000.0, 300, seed=6)
    got = _port(table, tr, percentile_mode="streaming")
    assert metrics_json(got) == j_metrics_json(
        _ref(jtable, tr, percentile_mode="streaming"))
    pol = make_policy("continuous", 8)
    with pytest.raises(ValueError, match="event engine"):
        ServeSim(table, pol, engine="event", prefill_policy="batched")
    with pytest.raises(ValueError, match="max_queue"):
        ServeSim(table, pol, max_queue=4, prefill_policy="chunked")
    with pytest.raises(ValueError, match="engine"):
        ServeSim(table, pol, engine="heapq")


# --------------------------------------------------------------------
# compiled step-cost tables
# --------------------------------------------------------------------

def _tiny_trace(table, rate_x, n, seed=0):
    """Trace whose offered token load is rate_x times decode capacity."""
    cfg = table.cfg
    cap = table.fit_batch / table.iteration_s(
        [cfg.max_seq] * table.fit_batch)
    rate = rate_x * cap / ((4 + cfg.max_new) / 2.0)
    return poisson_trace(rate, n, seed=seed, max_prompt=cfg.max_prompt,
                         max_new=cfg.max_new)


@pytest.fixture(scope="module")
def trace_tables():
    return (StepCostTable(ServeModelCfg(**TINY), fidelity="trace"),
            JStepCostTable(JServeModelCfg(**TINY), fidelity="trace"))


def test_trace_table_equals_reference(trace_tables):
    table, jtable = trace_tables
    assert table.to_dict() == jtable.to_dict()
    assert table._table_key() == jtable._table_key()
    # decode marginal cost is flat in the KV length (append-row path)
    per = [table.decode_per_seq_s(b) for b in table.decode_buckets]
    assert max(per) <= 1.5 * min(per)


@pytest.mark.parametrize("policy", ["static", "continuous"])
def test_metrics_json_equals_reference_on_compiled_table(trace_tables,
                                                         policy):
    table, jtable = trace_tables
    trace = _tiny_trace(table, 1.2, n=120)
    got = [metrics_json(_port(table, trace, policy)) for _ in range(2)]
    assert got[0] == got[1]
    assert got[0] == j_metrics_json(_ref(jtable, trace, policy))
    m = json.loads(got[0])
    assert m["tokens"] == sum(r.gen_len for r in trace)
    assert m["requests"] == 120


@pytest.mark.parametrize("chips", [1, 2])
def test_simulate_table_on_cpu_equals_reference(chips):
    """Every bucket decoded by the ``torch`` engine on the CPU: the table
    equals the reference's (numpy engines), one chip and a 2-chip
    pipeline mesh."""
    cfg = ServeModelCfg(n_layers=1, d_model=64, n_heads=2, vocab=64,
                        max_prompt=8, max_new=8)
    sysc = SystemConfig.mesh(chips) if chips > 1 else None
    jsysc = JSystemConfig.mesh(chips) if chips > 1 else None
    table = StepCostTable(cfg, fidelity="simulate", system=sysc,
                          device=CPU)
    jtable = JStepCostTable(JServeModelCfg(**cfg.to_dict()),
                            fidelity="simulate", system=jsysc)
    assert table.to_dict() == jtable.to_dict()
    assert table._table_key() == jtable._table_key()


def test_cli_equals_reference(tmp_path, monkeypatch):
    from repro_torch.flow import diskcache
    monkeypatch.delenv(diskcache.ENV_VAR, raising=False)
    monkeypatch.delenv("REPRO_FLOW_CACHE", raising=False)
    args = ["--fidelity", "trace", "--policy", "both", "--requests", "60",
            "--rate", "5000", "--n-layers", "1", "--d-model", "64",
            "--n-heads", "2", "--vocab", "64", "--max-prompt", "16",
            "--max-new", "16", "--chips", "2"]
    outs = []
    for fn, name in ((main, "port"), (j_main, "ref")):
        path = str(tmp_path / f"{name}.json")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert fn(args + ["--json", path]) == 0
        outs.append((buf.getvalue().replace(path, "OUT"),
                     open(path).read()))
    assert outs[0] == outs[1]
    assert "mesh 2x1 'pcb'" in outs[0][0]
