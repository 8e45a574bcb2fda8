"""The SSD chunk scan's share of its roofline in training: the frozen
``ssd_bound`` (forward and backward, once a layer a step, at the cell's
shapes and the bf16 peak), summed over the window's steps, over the
device time of the kernels launched under ``SSDChunkScan`` and its
backward (the recomputed forward included)."""

from perfbench.reference import bounds


def read(run):
    if run.kind != "train" or run.reduced is None:
        return None
    dev = sum(run.reduced.op_device_s.get(n, 0.0)
              for n in ("SSDChunkScan", "SSDChunkScanBackward"))
    if dev <= 0:
        return None
    m = run.model
    ms = sum(bounds.ssd_bound(run.ref.ssd_case(m, b, s))["fwd_bwd"][0]
             for b, s in run.outcome.calls) * m["n_layers"]
    return 100.0 * 1e-3 * ms / dev
