"""Flash attention's share of its roofline in prefill: the frozen
``fa_bound`` forward over each call's causal pairs, once a layer, summed
over the window's calls, over the device time of the kernels launched
under ``FlashAttention``."""

from perfbench.reference import bounds


def read(run):
    if run.kind != "prefill" or run.reduced is None:
        return None
    dev = run.reduced.op_device_s.get("FlashAttention", 0.0)
    if dev <= 0 or "n_heads" not in run.model:
        return None
    m = run.model
    ms = sum(bounds.fa_bound(run.ref.fa_case(m, b, s))["fwd"][0]
             for b, s in run.outcome.calls) * m["n_layers"]
    return 100.0 * 1e-3 * ms / dev
