"""Host time to issue one prefill call: the harness's span around each
``prefill_step(...)`` call, from the call to its return (not the wait
for its logits), averaged over the window's calls."""

import statistics


def read(run):
    if run.kind != "prefill" or not run.outcome.enqueue_s:
        return None
    return 1e3 * statistics.fmean(run.outcome.enqueue_s)
