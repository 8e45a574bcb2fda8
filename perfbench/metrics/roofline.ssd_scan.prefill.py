"""The SSD chunk scan's share of its roofline in prefill: the frozen
``ssd_bound`` forward, once a layer a call at each call's shape, summed
over the window's calls, over the device time of the kernels launched
under ``SSDChunkScan``."""

from perfbench.reference import bounds


def read(run):
    if run.kind != "prefill" or run.reduced is None:
        return None
    dev = run.reduced.op_device_s.get("SSDChunkScan", 0.0)
    if dev <= 0 or "d_state" not in run.model:
        return None
    m = run.model
    ms = sum(bounds.ssd_bound(run.ref.ssd_case(m, b, s))["fwd"][0]
             for b, s in run.outcome.calls) * m["n_layers"]
    return 100.0 * 1e-3 * ms / dev
