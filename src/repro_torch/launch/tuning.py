"""Performance-tuning knobs for the §Perf hillclimb.

Each flag is one hypothesis from EXPERIMENTS.md §Perf; the dry-run probes
re-measure the roofline terms with a knob flipped, and the before/after
goes into the log.  Flags default to the paper-faithful baseline.

* ``attn_seq_parallel`` — replace the head_dim-fallback attention sharding
  (whose score psum scales with S²) by sequence-sharded attention: q/k/v
  are resharded seq-wise (an S-linear all-to-all), attention computes with
  full heads per chip on its sequence slice, and the context reshards
  back for the row-parallel output projection.
* ``fsdp_params`` — ZeRO-3-style: parameters (and their optimizer
  moments) shard over the data axis too; XLA inserts per-layer
  all-gathers / reduce-scatters.  Trades collective time for the capacity
  wall (671B-class configs cannot hold replicated-over-data params).
* ``int8_weights`` — store 2-D+ weights INT8 with per-tensor scales,
  dequantizing at use (the paper's digital-CIM INT8 inference story
  applied to decode bandwidth).
* ``int8_kv_cache`` — INT8 KV cache with dequant-at-attention.
"""

from __future__ import annotations

import contextlib

FLAGS = {
    "attn_seq_parallel": False,
    "fsdp_params": False,
    "int8_weights": False,
    "int8_kv_cache": False,
    "remat_policy": "nothing",      # nothing | dots
}


@contextlib.contextmanager
def tuned(**kw):
    prev = dict(FLAGS)
    FLAGS.update(kw)
    try:
        yield
    finally:
        FLAGS.update(prev)
