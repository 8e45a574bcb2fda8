"""The device's idle share of the traced training window: one minus the
union of its kernel, copy and set intervals over the window."""


def read(run):
    r = run.reduced
    if run.kind != "train" or r is None or r.window_s <= 0 or r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
