"""The check that decides ``correct``, driven through a whole run on the
CPU with the look for a chip skipped: sound runs pass the cells' own
limits, and each fault a cell can have, planted in the timed path, and
the lower-precision control come out not correct."""

import pytest
import torch

from perfbench.bench import drivers, runner
from perfbench.conftest import CELLS, SEED, control_cell, small_cell

FAULTED = [(c, f) for c in CELLS
           for f in drivers.FAULTS[small_cell(c).traffic["kind"]]]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, few_threads):
    r = runner.run(small_cell(name), SEED, 0.2, False, "cpu")
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("name,fault", FAULTED)
def test_planted_fault_is_not_correct(name, fault, few_threads):
    r = runner.run(small_cell(name), SEED, 0.2, False, "cpu", fault=fault)
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, few_threads):
    """The reference computed on float8 operands, in the program's
    place."""
    r = runner.run(control_cell(name), SEED, 0.2, False, "cpu",
                   control=True)
    assert not r["correct"], r["checks"]


def test_far_share_sees_a_minority_of_wrong_requests():
    """A tenth of the requests answered with another request's logits
    leaves the median of the per-request error where it was, and moves
    ``far_share`` by that tenth."""
    gen = torch.Generator().manual_seed(SEED)
    want = torch.randn(40, 300, generator=gen)
    got = want + 0.01 * torch.randn(40, 300, generator=gen)
    got[:4] = want[4:8]
    r, per = drivers.prefill_readings(got, want, over=0.3)
    assert r["logit_rms"] < 0.02
    assert r["far_share"] == pytest.approx(0.1)
    assert len(per["rms"]) == len(per["gap"]) == 40
    assert "far_share" not in drivers.prefill_readings(got, want)[0]
