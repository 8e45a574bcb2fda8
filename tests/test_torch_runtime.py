"""The port's runtime substrate (``repro_torch.runtime``, host code
copied from ``repro.runtime``): the port's versions of the fault,
elastic and straggler tests of ``tests/test_substrates.py``, and the
copies against the reference on random inputs (exact)."""

import dataclasses

import numpy as np
import pytest

from repro.runtime import (FailureDetector as JFailureDetector,
                           HeartbeatRegistry as JHeartbeatRegistry,
                           StragglerDetector as JStragglerDetector,
                           plan_remesh as jplan_remesh)

from repro_torch.runtime import (FailureDetector, HeartbeatRegistry,
                                 StragglerDetector, plan_remesh)


# ---------------------------------------------------------------------------
# The port's versions of tests/test_substrates.py:185-240
# ---------------------------------------------------------------------------


def test_failure_detector_flags_silent_node():
    clock = [0.0]
    reg = HeartbeatRegistry(clock=lambda: clock[0])
    det = FailureDetector(reg, min_timeout=5.0)
    for t in range(5):
        clock[0] = float(t)
        reg.beat("a")
        reg.beat("b")
    for t in range(5, 12):                # b goes silent
        clock[0] = float(t)
        reg.beat("a")
    assert det.check() == ["b"]
    assert det.alive() == ["a"]
    det.revive("b")
    assert "b" not in det.failed


def test_elastic_remesh_keeps_model_axis():
    plan = plan_remesh(500, model_parallel=16, target_data_parallel=32)
    assert plan.mesh_shape == (31, 16)
    assert plan.chips_idle == 500 - 31 * 16
    assert plan.grad_accum == 2           # 31 dp vs target 32 -> accum 2


def test_elastic_remesh_shrinks_when_needed():
    plan = plan_remesh(12, model_parallel=16, target_data_parallel=8,
                       min_model_parallel=4)
    assert plan.mesh_shape[1] in (4, 8)
    assert plan.chips_used <= 12


def test_elastic_impossible_raises():
    with pytest.raises(ValueError):
        plan_remesh(3, model_parallel=16, target_data_parallel=4,
                    min_model_parallel=8)


def test_straggler_detector_persistent_slow_host():
    det = StragglerDetector(k=4.0, min_hits=3)
    flagged = []
    for step in range(6):
        times = {f"h{i}": 1.0 + 0.01 * i for i in range(8)}
        times["h7"] = 3.0                 # persistently slow
        flagged = det.record_step(times)
    assert flagged == ["h7"]


def test_straggler_one_off_not_flagged():
    det = StragglerDetector(min_hits=3)
    for step in range(6):
        times = {f"h{i}": 1.0 for i in range(8)}
        if step == 2:
            times["h3"] = 9.0             # transient hiccup
        assert det.record_step(times) == []


# ---------------------------------------------------------------------------
# The copies against the reference
# ---------------------------------------------------------------------------


def test_plan_remesh_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(300):
        kw = dict(surviving_chips=int(rng.integers(0, 600)),
                  model_parallel=int(2 ** rng.integers(0, 6)),
                  target_data_parallel=int(rng.integers(1, 64)))
        if rng.random() < 0.5:
            kw["min_model_parallel"] = int(2 ** rng.integers(0, 5))
        try:
            want = jplan_remesh(**kw)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                plan_remesh(**kw)
            continue
        assert dataclasses.asdict(plan_remesh(**kw)) == \
            dataclasses.asdict(want), kw


def test_straggler_detector_matches_reference():
    rng = np.random.default_rng(1)
    for trial in range(20):
        kw = dict(k=float(rng.uniform(2, 6)),
                  min_hits=int(rng.integers(1, 4)))
        det, jdet = StragglerDetector(**kw), JStragglerDetector(**kw)
        hosts = [f"h{i}" for i in range(int(rng.integers(1, 12)))]
        slow = set(rng.choice(hosts, size=len(hosts) // 4, replace=False))
        for _ in range(12):
            times = {h: float(rng.gamma(4.0, 0.25)) * (3 if h in slow
                                                       else 1)
                     for h in hosts}
            assert det.record_step(times) == jdet.record_step(times)
        assert det.chronic() == jdet.chronic()


def test_failure_detector_matches_reference():
    rng = np.random.default_rng(2)
    for trial in range(10):
        clock = [0.0]
        reg = HeartbeatRegistry(clock=lambda: clock[0])
        jreg = JHeartbeatRegistry(clock=lambda: clock[0])
        det = FailureDetector(reg, min_timeout=2.0, k=3.0)
        jdet = JFailureDetector(jreg, min_timeout=2.0, k=3.0)
        nodes = [f"n{i}" for i in range(6)]
        for _ in range(60):
            clock[0] += float(rng.exponential(0.5))
            for n in nodes:
                if rng.random() < (0.9 if n != "n5" else 0.2):
                    reg.beat(n)
                    jreg.beat(n)
            assert det.check() == jdet.check()
        assert det.failed == jdet.failed and det.alive() == jdet.alive()
        assert [reg.gap_stats(n) for n in nodes] == \
            [jreg.gap_stats(n) for n in nodes]
