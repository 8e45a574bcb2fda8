"""repro_torch.serve: request-level LM serving simulator on the CIM stack.

Host code copied from :mod:`repro.serve` (the JAX package): the same
traces, tables and byte-identical metrics JSON.  A table built at
``fidelity="simulate"`` decodes every bucket's artifact on the card
(``StepCostTable(..., device=)``); the replay engines are numpy.

Replays arrival traces (Poisson / bursty / file) against compiled CIM
artifacts with prefill/decode disaggregation, static or continuous
(iteration-level) batching, and KV-cache admission control.  Step
costs come from the fidelity ladder — the decode path uses the
append-row (``kv_append``) incremental weight staging so a decode
step is O(1) in KV length.

Two replay engines share one semantics: the reference discrete-event
loop (``engine="event"``) and the array-batched engine
(``engine="array"``, the default) that prices whole scheduling
horizons with numpy slice adds and ``cumsum`` clock chains — byte-
identical metrics JSON, orders of magnitude faster, and the only
engine for ``prefill_policy="batched"``/``"chunked"`` (FCFS batched
prefill and Sarathi-style chunked prefill co-scheduled with decode).
Trace generation is vectorized through a CPython-bit-identical
MT19937 (:class:`~repro_torch.serve.rng.VecMT`), so million-request traces
draw in numpy batches without changing a byte of any committed
trace.

Quick start::

    python -m repro_torch.serve --trace poisson --rate 8 --requests 200 \\
        --fidelity trace

or programmatically::

    from repro_torch.serve import (ServeModelCfg, StepCostTable,
                                   ServeSim, make_policy, poisson_trace)
    table = StepCostTable(ServeModelCfg(), fidelity="trace")
    sim = ServeSim(table, make_policy("continuous", max_batch=8))
    metrics = sim.run(poisson_trace(rate=8.0, n=200, seed=0))
"""
from .bucketing import (bucket_batch_sizes, bucket_boundaries,
                        bucket_for, group_by_bucket)
from .engine import run_array
from .metrics import (RequestRecord, StreamingPercentiles, metrics_json,
                      percentile, summarize, summarize_soa)
from .policy import (POLICIES, Batcher, ContinuousBatcher,
                     StaticBatcher, make_policy)
from .rng import VecMT
from .trace_replay import (Request, ServeSim, bursty_trace, load_trace,
                           poisson_trace, poisson_trace_arrays,
                           save_trace)
from .workload import ServeModelCfg, StepCostTable

__all__ = [
    "Request", "ServeSim", "poisson_trace", "poisson_trace_arrays",
    "bursty_trace", "load_trace", "save_trace",
    "ServeModelCfg", "StepCostTable",
    "Batcher", "StaticBatcher", "ContinuousBatcher", "make_policy",
    "POLICIES", "run_array", "VecMT",
    "RequestRecord", "percentile", "summarize", "summarize_soa",
    "StreamingPercentiles", "metrics_json",
    "bucket_boundaries", "bucket_for", "bucket_batch_sizes",
    "group_by_bucket",
]
