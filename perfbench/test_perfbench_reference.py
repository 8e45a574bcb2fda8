"""The yardstick on the CPU: the frozen counts reproduce the bounds the
port's chip smoke script printed, the plain references agree with the
port's CPU path at small sizes, and they import nothing of the
program."""

import ast
from pathlib import Path

import pytest
import torch

from perfbench.bench import program, traffic, weights
from perfbench.conftest import CELLS, SEED, small_cell
from perfbench.reference import bounds, mamba2, olmoe
from perfbench.reference import train as ref_train
from perfbench.reference.common import Arith, param_names

REF_DIR = Path(__file__).resolve().parent / "reference"


@pytest.mark.parametrize("case,key,ms", [
    # (label, B, S, nh, hp, g, N, Q, dtype): mamba2-780m at B 4 x S 2048,
    # at B 1 x S 32768, and jamba-1.5's geometry
    (("", 4, 2048, 48, 64, 1, 128, 256, "bfloat16"), "fwd_bwd", 0.0854),
    (("", 4, 2048, 48, 64, 1, 128, 256, "bfloat16"), "fwd", 0.0318),
    (("", 1, 32768, 48, 64, 1, 128, 256, "bfloat16"), "fwd_bwd", 0.342),
    (("", 1, 32768, 48, 64, 1, 128, 256, "bfloat16"), "fwd", 0.127),
    (("", 1, 4096, 128, 128, 8, 128, 256, "bfloat16"), "fwd_bwd", 0.194),
])
def test_ssd_bound_as_recorded(case, key, ms):
    assert bounds.ssd_bound(case)[key][0] == pytest.approx(ms, abs=6e-4)


def test_gg_bound_as_recorded():
    """olmoe's training buffer: 65,536 hits, 2048 -> 1024, forward + dx
    + dw: 0.834 ms, bound by operations."""
    total = 0.0
    for mode in ("fwd", "dx", "dw"):
        ms, by = bounds.gg_bound(mode, 65536, 81920, 2048, 1024, 64, 64, 2,
                                 bounds.PEAK_BF16_OPS)
        assert by == "operations"
        total += ms
    assert total == pytest.approx(0.834, abs=5e-4)


@pytest.mark.parametrize("case,fwd,both", [
    (("", 4, 2048, 2048, 8, 3, 128, 128, True, None, 0, "bfloat16"),
     0.104, 0.365),
    (("", 1, 32768, 32768, 8, 3, 128, 128, True, None, 0, "bfloat16"),
     6.67, 23.35),
])
def test_fa_bound_as_recorded(case, fwd, both):
    b = bounds.fa_bound(case)
    assert b["fwd"][0] == pytest.approx(fwd, rel=3e-3)
    assert b["fwd_bwd"][0] == pytest.approx(both, rel=3e-3)


@pytest.mark.parametrize("path", sorted(REF_DIR.glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    """The references import torch, numpy and the standard library
    only: nothing of the port, JAX or the JAX package."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                continue
            names = [node.module]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "repro",
                                           "repro_torch", "perfbench"), n


def _setup(name):
    c = small_cell(name)
    m = c.config["model"]
    ref = {"mamba2": mamba2, "olmoe": olmoe}[c.config["reference"]]
    a = program.arch(c.config)
    flat = weights.make(ref.param_specs(m), SEED, "cpu", torch.float32)
    tok = torch.randint(0, m["vocab"], (3, 32),
                        generator=torch.Generator().manual_seed(5),
                        dtype=torch.int32)
    return c, m, ref, a, flat, tok


@pytest.mark.parametrize("name", CELLS)
def test_last_logits_match_the_port(name, few_threads):
    c, m, ref, a, flat, tok = _setup(name)
    with program.mesh_context():
        step = program.prefill_step(a, "cpu", *tok.shape)
        got = step(program.served_tree(a, weights.tree(flat)),
                   {"tokens": tok})
    want = ref.last_logits(m, weights.tree(flat), tok, Arith())
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)


def test_mamba2_loss_and_gradients_match_the_port(few_threads):
    from repro_torch.models import transformer as T
    c, m, ref, a, flat, tok = _setup(CELLS[0])
    params = program.train_tree(weights.tree(flat))
    params.requires_grad_(True)
    leaves = program.leaves(params)
    loss = T.loss_fn(a, params, {"tokens": tok})
    g_port = torch.autograd.grad(loss, leaves)
    by_ptr = {p.data_ptr(): g for p, g in zip(leaves, g_port)}
    names = param_names(ref.param_specs(m))
    mine = {k: flat[k].detach().clone().requires_grad_(True) for k in names}
    n = tok.shape[0] * (tok.shape[1] - 1)
    want = ref.loss_sum(m, weights.tree(mine), tok, Arith()) / n
    assert float(loss.detach()) == pytest.approx(float(want.detach()),
                                                 rel=1e-5)
    g_ref = torch.autograd.grad(want, [mine[k] for k in names])
    for k, g in zip(names, g_ref):
        got = by_ptr[flat[k].data_ptr()]
        assert torch.allclose(got, g, atol=1e-5, rtol=1e-3), k


def test_reference_steps_follow_the_port(few_threads):
    """Three AdamW steps of the reference against the port's train step
    on the same weights and batches."""
    c, m, ref, a, flat, _ = _setup(CELLS[0])
    opt = c.traffic["optimizer"]
    pool = traffic.token_pool(c.traffic, SEED, m["vocab"], "cpu")
    b, s = traffic.shapes(c.traffic)[0]
    batches = [pool[i].view(b, s) for i in range(3)]
    names = param_names(ref.param_specs(m))
    W0 = {k: v.clone() for k, v in flat.items()}
    params = program.train_tree(weights.tree(flat))
    step, init = program.train_step(a, "cpu", b, s, opt)
    state = init(params)
    losses = []
    for i, tok in enumerate(batches):
        params, state, met = step(params, state, {"tokens": tok}, i)
        losses.append(float(met["loss"]))
    got = ref_train.steps(ref, m, W0, batches, opt, Arith(), rows=2)
    assert losses == pytest.approx(got["loss"], rel=1e-5)
    for k in names:
        change = float(torch.linalg.vector_norm(flat[k] - W0[k]))
        assert change == pytest.approx(got["change"][k], rel=1e-3,
                                       abs=1e-7), k


def test_control_rounds_to_float8():
    ar = Arith(fp8=True)
    x = torch.linspace(-3.0, 3.0, 1001)
    q = ar.q(x)
    assert not torch.equal(q, x)
    # e4m3 keeps 3 mantissa bits: within 2^-4 of each value, relative
    assert ((q - x).abs() <= x.abs() * 2.0 ** -4 + 1e-3).all()
    y = x.clone().requires_grad_(True)
    (ar.q(y) * 2).sum().backward()
    assert torch.equal(y.grad, torch.full_like(x, 2.0))
