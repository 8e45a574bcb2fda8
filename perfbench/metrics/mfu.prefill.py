"""The whole prefill call's share of the card's bf16 peak: the model
FLOPs of the window's calls (the reference's formula at the
configuration's widths, the head on the last position only) over the
window's seconds times 989e12."""

from perfbench.reference import bounds


def read(run):
    o = run.outcome
    if run.kind != "prefill" or o.window_s <= 0 or not o.calls:
        return None
    f = sum(run.ref.flops(run.model, b, s, False) for b, s in o.calls)
    return 100.0 * f / (o.window_s * bounds.PEAK_BF16_OPS)
