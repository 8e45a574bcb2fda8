"""The port's compile -> evaluate path against the JAX package.

* analytic: ``repro_torch.flow.compile(...).evaluate("analytic")`` gives
  the same cycles and energy ledger as ``repro.flow``, exactly;
* func: ``random_init``/``auto_quant`` draw the same state, and
  ``func:torch`` on ``device="cpu"`` (the kernel's plain version) gives
  the same int8 outputs as ``func:pallas`` (Pallas interpret mode) or
  the numpy oracle ``repro.core.ref.run_reference``, for every group;
* rejections: what the port does not carry yet raises.

All func comparisons are integer equality (tolerance 0).
"""

import numpy as np
import pytest
import torch

from repro import flow as jflow
from repro.core import graph as jgraph
from repro.core import ref as jref
from repro.core.arch import default_chip as j_default_chip
from repro_torch import flow
from repro_torch.convert import from_reference
from repro_torch.core import graph, ref
from repro_torch.core.arch import default_chip
from repro_torch.core.partition import STRATEGIES

SMALL_TF = dict(n_layers=1, d_model=128, n_heads=4, seq=16, vocab=64)


def _opts(mod, **kw):
    return mod.CompileOptions(fidelity="analytic", **kw)


def _both(model, kw, batch=2, strategy="dp"):
    art = flow.compile(model, default_chip(), _opts(
        flow, strategy=strategy, batch=batch, workload_kw=kw))
    jart = jflow.compile(model, j_default_chip(), _opts(
        jflow, strategy=strategy, batch=batch, workload_kw=kw))
    return art, jart


def _assert_outputs_equal(got, want):
    assert sorted(got) == sorted(k for k in want if k != "acc")
    for gid in got:
        assert got[gid].dtype == np.int8
        np.testing.assert_array_equal(got[gid], np.asarray(want[gid]),
                                      err_msg=f"group {gid}")


# ---------------------------------------------------------------------------
# analytic path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("model,kw", [("tiny_cnn", {"res": 8}),
                                      ("resnet18", {"res": 32})])
def test_analytic_identical(model, kw, strategy):
    art, jart = _both(model, kw, batch=4, strategy=strategy)
    rep, jrep = art.evaluate(), jart.evaluate()
    assert rep.backend == jrep.backend == "analytic"
    assert rep.cycles == jrep.cycles
    assert rep.energy == jrep.energy
    assert rep.throughput_sps == jrep.throughput_sps
    assert art.partition.n_stages == jart.partition.n_stages
    assert [s.gids for s in art.partition.stages] == \
        [s.gids for s in jart.partition.stages]


def test_compile_cache_and_many():
    pipe = flow.Pipeline()
    o = _opts(flow, batch=2, workload_kw={"res": 8})
    a = pipe.compile("tiny_cnn", default_chip(), o)
    b = pipe.compile("tiny_cnn", default_chip(), o.replace(
        fidelity="trace"))
    assert not a.pass_record("partition").cached
    assert b.pass_record("partition").cached
    chips = [default_chip(), default_chip(n_macro_groups=8)]
    arts = pipe.compile_many("tiny_cnn", chips, o)
    assert len(arts) == 2 and arts[1].trace[0].cached
    assert "partition:dp" in arts[0].describe()


# ---------------------------------------------------------------------------
# func path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,kw", [("tiny_cnn", {"res": 8}),
                                      ("transformer", SMALL_TF)])
def test_random_init_and_auto_quant_identical(model, kw):
    art, jart = _both(model, kw)
    w, b, x = ref.random_init(art.cg, batch=2, seed=3, device="cpu")
    jw, jb, jx = jref.random_init(jart.cg, batch=2, seed=3)
    assert sorted(w) == sorted(jw) and sorted(b) == sorted(jb)
    for k in jw:
        np.testing.assert_array_equal(w[k].numpy(), jw[k])
    for k in jb:
        np.testing.assert_array_equal(b[k].numpy(), jb[k])
    np.testing.assert_array_equal(x.numpy(), jx)
    q = ref.auto_quant(art.cg, w, b, x)
    jq = jref.auto_quant(jart.cg, jw, jb, jx)
    assert {k: (v.scale, v.shift) for k, v in q.items()} == \
        {k: (v.scale, v.shift) for k, v in jq.items()}


@pytest.mark.parametrize("model,kw", [("tiny_cnn", {"res": 8}),
                                      ("transformer", SMALL_TF)])
def test_func_torch_equals_func_pallas(model, kw):
    art, jart = _both(model, kw, batch=2)
    rep = art.evaluate("func:torch", device="cpu")
    jrep = jart.evaluate("func:pallas")
    assert rep.backend == "func:torch" and rep.cycles == 0.0
    assert rep.batch == jrep.batch == 2
    _assert_outputs_equal(rep.outputs, jrep.outputs)


@pytest.mark.parametrize("model", ["resnet18", "vgg19"])
def test_func_torch_equals_numpy_oracle(model):
    """Quantization from the port's auto_quant (the numpy one takes
    seconds per pass at these sizes; its equality is pinned above)."""
    art, jart = _both(model, {"res": 32}, batch=2)
    w, b, x = jref.random_init(jart.cg, batch=2, seed=1)
    tw, tb, tx, _ = from_reference(w, b, x, None, device="cpu")
    q = ref.auto_quant(art.cg, tw, tb, tx)
    want = jref.run_reference(jart.cg, w, b, {
        k: jref.QuantParams(v.scale, v.shift) for k, v in q.items()}, x)
    rep = art.evaluate("func:torch", weights=w, biases=b, inputs=x,
                       quant=q, device="cpu")
    _assert_outputs_equal(rep.outputs, want)


def _residual(g):
    x = g.input("x", (8, 8, 8))
    c1 = g.conv("c1", x, cout=8, k=3, act="relu", use_bn=False)
    c2 = g.conv("c2", c1, cout=8, k=3, use_bn=False)
    r = g.unary("relu", "relu", g.eltwise("add", "add", c2, c1))
    g.linear("fc", g.globalpool("gap", r), cout=4)


def _depthwise(g):
    x = g.input("x", (8, 8, 16))
    d = g.conv("dw", x, cout=16, k=3, groups=16, act="relu", use_bn=False)
    g.linear("fc", g.globalpool("gap", d), cout=4)


def _strided(g):
    x = g.input("x", (9, 9, 4))
    c = g.conv("c", x, cout=8, k=3, stride=2, act="relu", use_bn=False)
    g.linear("fc", g.globalpool("gap", c), cout=4)


def _maxpool_pad(g):
    x = g.input("x", (8, 8, 4))
    c = g.conv("c", x, cout=8, k=3, act="relu", use_bn=False)
    p = g.pool("p", c, k=3, stride=2, padding=1)
    g.linear("fc", g.globalpool("gap", p), cout=4)


def _flatten_linear(g):
    x = g.input("x", (6, 6, 4))
    c = g.conv("c1", x, cout=4, k=3, act="relu", use_bn=False)
    f = g.unary("flatten", "flatten", c)
    h, w, cc = g.ops[c].out_shape
    g.ops[f].out_shape = (h * w * cc,)
    g.linear("fc", f, cout=8)


@pytest.mark.parametrize("build", [_residual, _depthwise, _strided,
                                   _maxpool_pad, _flatten_linear])
def test_run_reference_small_graphs(build):
    g, jg = graph.Graph("t"), jgraph.Graph("t")
    build(g)
    build(jg)
    cg, jcg = g.condense(), jg.condense()
    w, b, x = jref.random_init(jcg, batch=3, seed=2)
    jq = jref.auto_quant(jcg, w, b, x)
    want = jref.run_reference(jcg, w, b, jq, x, return_acc=True)
    tw, tb, tx, tq = from_reference(w, b, x, jq, device="cpu")
    got = ref.run_reference(cg, tw, tb, tq, tx, return_acc=True)
    _assert_outputs_equal({k: v.numpy() for k, v in got.items()
                           if k != "acc"}, want)
    for gid, acc in got["acc"].items():
        np.testing.assert_array_equal(acc.numpy(), want["acc"][gid])


def test_mvm_count_static_once_dynamic_per_sample():
    """One MVM per static group over the whole batch; one per sample for
    a dynamic-weight group."""
    art = flow.compile("transformer", default_chip(), _opts(
        flow, batch=3, workload_kw=SMALL_TF))
    w, b, x = ref.random_init(art.cg, batch=3, device="cpu")
    q = ref.auto_quant(art.cg, w, b, x)
    calls = []

    def mm(a, m):
        calls.append(tuple(a.shape))
        return ref.mvm_ref(a, m)

    ref.run_reference(art.cg, w, b, q, x, matmul=mm)
    n_dyn = sum(g.dynamic_weights for g in art.cg)
    assert n_dyn > 0
    assert len(calls) == len(art.cg) - n_dyn + 3 * n_dyn


def test_from_reference_round_trip():
    art, jart = _both("tiny_cnn", {"res": 8}, batch=2)
    w, b, x = jref.random_init(jart.cg, batch=2, seed=4)
    jq = jref.auto_quant(jart.cg, w, b, x)
    tw, tb, tx, tq = from_reference(w, b, x, jq, device="cpu")
    assert all(t.dtype == torch.int8 for t in tw.values())
    assert all(t.dtype == torch.int32 for t in tb.values())
    assert tx.dtype == torch.int8 and tuple(tx.shape) == x.shape
    assert tq == {k: ref.QuantParams(v.scale, v.shift)
                  for k, v in jq.items()}
    again = from_reference(tw, tb, tx, tq, device="cpu")
    assert all(torch.equal(again[0][k], tw[k]) for k in tw)
    assert from_reference(w, b, x, None, device="cpu")[3] is None
    a = art.evaluate("func:torch", weights=tw, biases=tb, inputs=tx,
                     quant=tq, device="cpu")
    c = art.evaluate("func:torch", weights=w, biases=b, inputs=x,
                     quant=jq, device="cpu")
    _assert_outputs_equal(a.outputs, c.outputs)


# ---------------------------------------------------------------------------
# rejections
# ---------------------------------------------------------------------------


def _tiny():
    return flow.compile("tiny_cnn", default_chip(), _opts(
        flow, batch=1, workload_kw={"res": 8}))


def test_rejects_partial_tensors():
    with pytest.raises(TypeError):
        _tiny().evaluate("func:torch", device="cpu",
                         inputs=np.zeros((1, 8, 8, 3), dtype=np.int8))


def test_rejects_faults_and_unknown_kwargs():
    with pytest.raises(NotImplementedError):
        _tiny().evaluate("func:torch", device="cpu", faults=object())
    with pytest.raises(TypeError):
        _tiny().evaluate("func:torch", device="cpu", engine="jax")
    with pytest.raises(TypeError):
        _tiny().evaluate("analytic", check=False)


@pytest.mark.parametrize("what", ["simulate-fidelity", "func-fidelity",
                                  "simulate-backend", "trace-backend",
                                  "func:pallas", "codegen", "calibration",
                                  "system", "disk-cache"])
def test_not_ported_raises(what):
    with pytest.raises(NotImplementedError):
        if what.endswith("-fidelity"):
            flow.compile("tiny_cnn", default_chip(), flow.CompileOptions(
                fidelity=what.split("-")[0], workload_kw={"res": 8}))
        elif what.endswith("-backend"):
            _tiny().evaluate(what.split("-")[0])
        elif what == "func:pallas":
            _tiny().evaluate("func:pallas")
        elif what == "codegen":
            _tiny().ensure_model()
        elif what == "calibration":
            flow.CompileOptions(calibration="preset")
        elif what == "system":
            flow.compile("tiny_cnn", default_chip(), flow.CompileOptions(
                system=object(), workload_kw={"res": 8}))
        else:
            flow.Pipeline(disk_cache="cache-dir")


def test_default_pipeline_ignores_reference_cache_env(monkeypatch,
                                                      tmp_path):
    """The JAX package's ``REPRO_FLOW_CACHE`` switch does not reach the
    port: with it set, the port's default pipeline still compiles."""
    from repro_torch.flow import pipeline
    monkeypatch.setenv("REPRO_FLOW_CACHE", str(tmp_path))
    monkeypatch.setattr(pipeline, "_DEFAULT_PIPELINE", None)
    art = flow.compile("tiny_cnn", default_chip(), _opts(
        flow, batch=1, workload_kw={"res": 8}))
    assert art.evaluate("analytic").cycles > 0
    assert not any(tmp_path.iterdir())


def test_unknown_backend_and_strategy():
    with pytest.raises(KeyError):
        _tiny().evaluate("no-such-backend")
    with pytest.raises(KeyError):
        flow.compile("tiny_cnn", default_chip(), flow.CompileOptions(
            strategy="no-such", workload_kw={"res": 8}))


def test_unsupported_fused_op_raises_like_reference():
    """relu6 (mobilenetv2, efficientnetb0) stops both oracles."""
    g, jg = graph.Graph("r6"), jgraph.Graph("r6")
    for gg in (g, jg):
        x = gg.input("x", (6, 6, 4))
        gg.linear("fc", gg.globalpool("gap", gg.conv(
            "c", x, cout=8, k=3, act="relu6", use_bn=False)), cout=4)
    cg, jcg = g.condense(), jg.condense()
    w, b, x = jref.random_init(jcg, batch=1)
    q = {gr.idx: jref.QuantParams(scale=1, shift=8) for gr in jcg}
    with pytest.raises(NotImplementedError, match="relu6"):
        jref.run_reference(jcg, w, b, q, x)
    tw, tb, tx, tq = from_reference(w, b, x, q, device="cpu")
    with pytest.raises(NotImplementedError, match="relu6"):
        ref.run_reference(cg, tw, tb, tq, tx)
