"""The grouped expert GEMM's share of its roofline in prefill: the
frozen ``gg_bound`` of the three forward products of each MoE layer
(``wg`` and ``wi``: d_model to the expert width, ``wo`` back) over the
routed pairs these inputs need (every token's k choices, every expert
holding some), summed over the window's calls, over the device time of
the kernels launched under ``RaggedDot``."""

from perfbench.reference import bounds


def read(run):
    if run.kind != "prefill" or run.reduced is None:
        return None
    dev = run.reduced.op_device_s.get("RaggedDot", 0.0)
    if dev <= 0 or "n_experts" not in run.model:
        return None
    m = run.model
    d, f, e = m["d_model"], m["expert_d_ff"], m["n_experts"]
    ms = 0.0
    for b, s in run.outcome.calls:
        hits = b * s * m["experts_per_tok"]
        held = min(e, hits)
        for k, n in ((d, f), (d, f), (f, d)):
            ms += bounds.gg_bound("fwd", hits, hits, k, n, e, held, 2,
                                  bounds.PEAK_BF16_OPS)[0]
    return 100.0 * 1e-3 * ms * m["n_layers"] / dev
