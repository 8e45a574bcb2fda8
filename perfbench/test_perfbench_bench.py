"""The harness on the CPU: the spec's files found by name, the traffic
repeating from its seed, the trace reduction, the result line's schema,
and no module of JAX or the JAX package loaded by a run."""

import json
import os
import re
import subprocess
import sys
from collections import Counter

import pytest
import torch

from perfbench.bench import runner, spec, trace, traffic, weights
from perfbench.conftest import CELLS, SEED, small_cell

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MIXES = sorted({w["traffic"] for w in BENCH["workloads"]})
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names), names
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_run_fits_the_check():
    """A full check of 24 cells at this window fits its 43,200 s."""
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    c = spec.cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert c.config["name"] == entry["config"]
    assert c.traffic["kind"] in ("train", "prefill")
    assert c.chips == 1 and len(entry["why"]) <= 200
    got = {m["name"] for m in c.end_to_end}
    assert "setup_s" in got and len(got) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in got
    assert set(c.limits) and all("limit" in v for v in c.limits.values())


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    path = spec.ROOT / entry["file"]
    cfg = spec.load_json(path)
    assert entry["file"] == f"perfbench/configs/{entry['name']}.json"
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    from perfbench import reference
    assert hasattr(reference.module(cfg["reference"]), "param_specs")


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_found_by_name(name):
    m = next(x for x in BENCH["per_layer"] if x["name"] == name)
    assert callable(spec.reader(name).read)
    layers = {x["layer"] for x in BENCH["per_layer"]}
    assert m["layer"] in layers
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    for w in m["workloads"]:
        assert w in e2e[m["moves"]].get("workloads", [w])


@pytest.mark.parametrize("mix", MIXES)
def test_traffic_repeats_from_its_seed(mix):
    t = spec.traffic(mix)
    a = traffic.calls(t, SEED, 40)
    assert a == traffic.calls(t, SEED, 40)
    assert a != traffic.calls(t, SEED + 1, 40) or t["kind"] == "train"
    p = traffic.token_pool(dict(t, pool=3), SEED, 50000, "cpu")
    assert torch.equal(p, traffic.token_pool(dict(t, pool=3), SEED, 50000,
                                             "cpu"))
    assert not torch.equal(p, traffic.token_pool(dict(t, pool=3), SEED + 1,
                                                 50000, "cpu"))


@pytest.mark.parametrize("mix", MIXES)
def test_traffic_same_work_on_every_seed(mix):
    """Every seed sends the same shapes, cycle by cycle, in its own
    order."""
    t = spec.traffic(mix)
    n = len(traffic.cycle(t)) * 3
    want = Counter(traffic.cycle(t) * 3)
    for seed in (0, 7, SEED, 2 ** 33 + 5):
        got = Counter((c.batch, c.seq) for c in traffic.calls(t, seed, n))
        assert got == want
    if t["kind"] == "prefill":
        budget = t["tokens_per_call"]
        assert all(b * s == budget for b, s in traffic.shapes(t))
        shares = [round(w * t["cycle_calls"]) for w in t["buckets"]["weight"]]
        assert sum(shares) == t["cycle_calls"]


def test_weights_repeat_from_the_seed():
    from perfbench.reference import mamba2
    m = small_cell(CELLS[0]).config["model"]
    specs = mamba2.param_specs(m)
    a = weights.make(specs, SEED, "cpu", torch.float32)
    b = weights.make(specs, SEED, "cpu", torch.float32)
    c = weights.make(specs, SEED + 1, "cpu", torch.float32)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    served = weights.make(specs, SEED, "cpu", torch.bfloat16)
    assert served["final_norm.w"].dtype == torch.float32
    assert served["blocks.0.ssm0.A_log"].dtype == torch.bfloat16


def test_forbidden_modules_by_whole_top_level_name():
    ok = {"repro_torch": 1, "repro_torch.models": 1, "perfbench": 1,
          "jaxtyping": 1, "reprox": 1}
    assert runner.forbidden_modules(ok) == []
    bad = dict(ok, **{"repro": 1, "repro.models": 1, "jax.numpy": 1,
                      "jaxlib": 1, "flax.linen": 1})
    assert runner.forbidden_modules(bad) == sorted(
        ["repro", "repro.models", "jax.numpy", "jaxlib", "flax.linen"])


_ISOLATED = r"""
import json, sys
sys.path.insert(0, {root!r})
from perfbench.bench import runner
from perfbench.conftest import small_cell
r = runner.run(small_cell({cell!r}), 11, 0.2, False, "cpu")
print(json.dumps(runner.forbidden_modules()))
"""


@pytest.mark.parametrize("name", CELLS)
def test_a_run_loads_nothing_of_jax(name):
    """Each cell's set-up, window and check, run in a fresh interpreter,
    leave no module whose top-level name is ``jax``, ``jaxlib``, ``flax``
    or ``repro``."""
    code = _ISOLATED.format(root=str(spec.ROOT), cell=name)
    env = dict(os.environ, PYTHONPATH=str(spec.ROOT / "src"),
               OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


class _Ev:
    def __init__(self, name, s, e, cuda=False, corr=0, linked=0, tid=1):
        self._v = (name, s, e, cuda, corr, linked, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


def test_trace_reduction():
    """Busy time is the union of device intervals inside the window;
    device time goes to the named op holding the launching op; idle
    gaps are named by the innermost host op at their start."""
    ev = [
        _Ev(trace.WINDOW, 0, 1000, corr=1),
        _Ev(trace.STEP, 0, 600, corr=2),
        _Ev("SSDChunkScan", 100, 300, corr=3),
        _Ev("aten::zeros", 120, 130, corr=4),
        _Ev("RaggedDotBackward", 150, 200, corr=5, tid=2),
        _Ev("cudaLaunchKernel", 140, 145, corr=900, linked=3),
        _Ev("k_scan", 200, 400, cuda=True, corr=900, linked=3),
        _Ev("k_fill", 130, 160, cuda=True, corr=901, linked=4),
        _Ev("k_bwd", 350, 450, cuda=True, corr=902, linked=5),
        _Ev("k_mm", 700, 800, cuda=True, corr=903, linked=2),
        _Ev("k_outside", 1100, 1200, cuda=True, corr=904, linked=2),
        _Ev(trace.WAIT, 600, 1000, corr=6),
    ]
    r = trace.reduce(ev)
    assert r.window_s == pytest.approx(1e-6)
    # [130, 160] + [200, 450] + [700, 800]
    assert r.busy_s == pytest.approx(380e-9)
    assert r.op_device_s["SSDChunkScan"] == pytest.approx(230e-9)
    assert r.op_device_s["RaggedDotBackward"] == pytest.approx(100e-9)
    assert r.device_events == 4
    gaps = dict(r.idle_gaps)
    # [0, 130] and [450, 700] start under the step, [160, 200] under
    # the scan, [800, 1000] under the wait
    assert gaps[trace.STEP] == pytest.approx(380e-9)
    assert gaps["SSDChunkScan"] == pytest.approx(40e-9)
    assert gaps[trace.WAIT] == pytest.approx(200e-9)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("tracing", [False, True])
def test_result_line(name, tracing, few_threads):
    """The last line's keys, the metrics the cell reports under their
    units, and the compared numbers last, each beside its limit."""
    c = small_cell(name)
    r = runner.run(c, SEED, 0.3, tracing, "cpu")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert isinstance(r["correct"], bool) and r["attempted"] > 0
    assert r["failed"] == 0
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    units = {m["name"]: m["unit"] for m in c.end_to_end + c.per_layer}
    if tracing:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(r["metrics"]) <= {m["name"] for m in c.per_layer}
    else:
        assert set(r["metrics"]) == {m["name"] for m in c.end_to_end}
    for k, v in r["metrics"].items():
        assert v["unit"] == units[k] and v["value"] == v["value"]
    assert set(r["checks"]) == set(c.limits)
    for v in r["checks"].values():
        assert set(v) == {"value", "limit"}
    lines = runner.check_lines(r)
    assert len(lines) == len(c.limits) and all("limit" in x for x in lines)
    json.loads(runner.dumps(r))
