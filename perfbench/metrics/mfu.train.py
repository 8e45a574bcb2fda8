"""The whole training step's share of the card's bf16 peak: the model
FLOPs of the window's steps (the reference's formula at the
configuration's widths: the products three times, the recompute not
counted) over the window's seconds times 989e12."""

from perfbench.reference import bounds


def read(run):
    o = run.outcome
    if run.kind != "train" or o.window_s <= 0 or not o.calls:
        return None
    f = sum(run.ref.flops(run.model, b, s, True) for b, s in o.calls)
    return 100.0 * f / (o.window_s * bounds.PEAK_BF16_OPS)
