"""Small cells for the CPU tests: each cell of ``BENCHMARK.json`` with
its widths, depth and traffic cut so that a run takes seconds on the
CPU, where the port runs its kernels' plain versions in float32."""

import copy

import pytest
import torch

from perfbench.bench import spec

SEED = 2 ** 31 + 977

_SMALL = {
    "mamba2": dict(
        port={"n_layers": 2, "d_model": 64, "vocab": 256,
              "compute_dtype": "float32",
              "ssm": {"d_state": 16, "head_dim": 16, "chunk": 16}},
        model={"d_model": 64, "n_layers": 2, "vocab": 256, "d_state": 16,
               "head_dim": 16, "chunk": 16}),
    "olmoe": dict(
        port={"n_layers": 2, "d_model": 64, "vocab": 256,
              "compute_dtype": "float32", "n_heads": 4, "n_kv_heads": 4,
              "head_dim": 16, "d_ff": 32,
              "moe": {"n_experts": 8, "experts_per_tok": 2, "d_ff": 32}},
        model={"d_model": 64, "n_layers": 2, "vocab": 256, "n_heads": 4,
               "n_kv_heads": 4, "head_dim": 16, "n_experts": 8,
               "experts_per_tok": 2, "expert_d_ff": 32}),
}
_TRAFFIC = {
    "train": {"batch": 4, "seq": 32, "pool": 4, "reference_rows": 2},
    "prefill": {"tokens_per_call": 64,
                "buckets": {"seq": [16, 32], "weight": [0.5, 0.5]},
                "cycle_calls": 2, "pool": 8, "check_requests": 1000,
                "reference_tokens": 64, "warm_calls": 1},
}

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def small_cell(name: str) -> spec.Cell:
    """The cell ``name`` at the CPU tests' size, in float32, with the
    cell's own limits."""
    c = spec.cell(name)
    c.config = copy.deepcopy(c.config)
    c.traffic = copy.deepcopy(c.traffic)
    small = _SMALL[c.config["reference"]]
    c.config["port"]["overrides"] = copy.deepcopy(small["port"])
    c.config["model"].update(small["model"])
    c.config["dtypes"] = {"train": {"params": "float32"},
                          "prefill": {"weights": "float32"}}
    c.traffic.update(_TRAFFIC[c.traffic["kind"]])
    return c


def control_cell(name: str) -> spec.Cell:
    """:func:`small_cell`, with Mamba-2 at half its published depth and
    a wider d_model: rounding to float8 moves the numbers with depth,
    and at two layers the control stays within the limits the full
    cells were given."""
    c = small_cell(name)
    if c.config["reference"] == "mamba2":
        deep = {"n_layers": 24, "d_model": 128}
        c.config["port"]["overrides"].update(deep)
        c.config["model"].update(deep)
    return c


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
