"""Cost-probe mode for the roofline analysis.

Copied from :mod:`repro.models.analysis_flags`.  The port's layers read
``naive_attention`` and ``moe_ep`` reads ``balanced_moe``; the port's
dry run (:mod:`repro_torch.launch.dryrun`) sets ``balanced_moe`` alone:
its blocks are a Python loop and its counter walks the blockwise
attention loop, so neither the depth probes nor naive attention are
needed.  What follows is the reference's account.

XLA's ``cost_analysis()`` counts a ``while``-loop body **once** regardless
of trip count (verified empirically — see EXPERIMENTS.md §Roofline
methodology), so lowering the full model under-reports FLOPs/bytes by
~n_layers.  The dry-run therefore compiles **depth-1 and depth-2 probe
variants with fully-unrolled scans** and reconstructs step totals as
``X(1) + (n_blocks - 1) · (X(2) - X(1))``.

Probe mode additionally switches:

* flash attention -> the naive masked-softmax path (its inner block scans
  would otherwise be undercounted the same way; FLOP counts are identical,
  HBM bytes become an S² *upper bound*, noted in the tables);
* EP MoE ragged_dot -> a balanced equal-capacity batched matmul
  (XLA prices ragged_dot as dense over all groups — E_loc x overcount;
  the balanced probe prices exactly the ideal-load-balance FLOPs).
"""

from __future__ import annotations

import contextlib

FLAGS = {
    "naive_attention": False,
    "balanced_moe": False,
    "scan_unroll": 1,
}


@contextlib.contextmanager
def probe_mode(unroll: int, naive_attention: bool = True):
    """``naive_attention=True`` -> exact FLOP counts (S² bytes upper
    bound); ``False`` -> flash path kept, bytes/collectives measured with
    the flash inner scans counted once (the dry-run adds the analytic
    flash streaming traffic back — see launch/analysis.flash_addons)."""
    prev = dict(FLAGS)
    FLAGS.update(naive_attention=naive_attention, balanced_moe=True,
                 scan_unroll=unroll)
    try:
        yield
    finally:
        FLAGS.update(prev)
