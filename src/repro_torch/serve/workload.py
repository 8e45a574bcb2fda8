"""Serving-side cost model: compiled step-latency tables.

The serving simulator never prices a token by running the compiler in
its event loop.  Instead, :class:`StepCostTable` compiles the prefill
workload (``transformer_lm``) and the decode workload
(``transformer_decode``, incremental KV append) once per *length
bucket* on the chosen fidelity rung, and memoises the results:

* prefill: seconds to process a prompt of each bucketed length
  (batch 1 — the prefill engine runs prompts back to back);
* decode: an affine fit ``base + per_seq × batch`` per KV bucket,
  obtained from a batch-1 and a batch-K evaluation of the same
  artifact.  An iteration over a mixed batch is then priced in O(batch)
  as ``base(max bucket) + Σ per_seq(bucket_i)``.

Because the decode workload uses the append-row (``kv_append``)
weight path, ``per_seq`` stays O(1) in the KV length — the property
the regression test in ``tests/test_serve.py`` pins.

Tables are **disk-cacheable**: with a flow pass cache attached
(``flow_cache=`` or the ``REPRO_TORCH_FLOW_CACHE`` environment variable),
the finished bucket tables are stored under a digest of everything
that shaped them — chip, mesh, fidelity, bucket grid, calibration —
so a second ``python -m repro_torch.serve`` run with the same knobs skips
compilation entirely.  A ``system=`` :class:`repro_torch.system.SystemConfig`
prices every bucket on the multi-chip plan instead of one chip.

At ``fidelity="simulate"`` every bucket's evaluation decodes its stages
on ``device`` (the simulator's ``torch`` engine; CUDA unless named,
raising without a card).  The device is not part of the table's key:
the engines are bit-identical, so the same table has the key the JAX
package gives it.  The whole-table cache lives in the port's own disk
tier (``REPRO_TORCH_FLOW_CACHE``, ``*.repro_torch.pkl``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Union

from ..core.arch import ChipConfig, default_chip
from ..core.machine import Calibration
from ..flow import (CompileOptions, PassDiskCache, compile as flow_compile,
                    default_pipeline, load_calibration)
from ..flow.diskcache import ENV_VAR as _FLOW_CACHE_ENV
from .bucketing import bucket_boundaries, bucket_for

__all__ = ["ServeModelCfg", "StepCostTable"]

_TABLE_VERSION = 2


@dataclass(frozen=True)
class ServeModelCfg:
    """Model served by the simulator (mirrors the workload builders)."""
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    d_ff: Optional[int] = None
    vocab: int = 256
    max_prompt: int = 64
    max_new: int = 64

    @property
    def max_seq(self) -> int:
        return self.max_prompt + self.max_new

    def kv_bytes(self, kv_len: int) -> int:
        """Resident KV-cache footprint at ``kv_len`` tokens (int8 K+V)."""
        return 2 * self.n_layers * kv_len * self.d_model

    def to_dict(self) -> Dict[str, Any]:
        return {
            "n_layers": self.n_layers, "d_model": self.d_model,
            "n_heads": self.n_heads, "d_ff": self.d_ff,
            "vocab": self.vocab, "max_prompt": self.max_prompt,
            "max_new": self.max_new,
        }


class StepCostTable:
    """Bucketed prefill/decode step costs from compiled artifacts."""

    def __init__(self, cfg: ServeModelCfg,
                 chip: Optional[ChipConfig] = None,
                 fidelity: str = "trace",
                 bucket_step: float = 2.0,
                 fit_batch: int = 8,
                 incremental: bool = True,
                 system: Optional[Any] = None,
                 calibration: Union[Calibration, str, None] = None,
                 flow_cache: Optional[str] = None,
                 device: Any = None) -> None:
        if fit_batch < 2:
            raise ValueError("fit_batch must be >= 2 for an affine fit")
        self.cfg = cfg
        self.chip = chip if chip is not None else default_chip()
        self.fidelity = fidelity
        self.fit_batch = fit_batch
        self.incremental = incremental
        self.system = system
        self.device = device
        if isinstance(calibration, str):
            calibration = load_calibration(calibration)
        self.calibration = calibration
        self._hz = self.chip.clock_ghz * 1e9
        self.prefill_buckets = bucket_boundaries(
            cfg.max_prompt, step=bucket_step)
        self.decode_buckets = bucket_boundaries(
            cfg.max_seq, step=bucket_step)
        self._prefill_s: Dict[int, float] = {}
        self._prefill_base_s: Dict[int, float] = {}
        self._prefill_per_seq_s: Dict[int, float] = {}
        self._decode_base_s: Dict[int, float] = {}
        self._decode_per_seq_s: Dict[int, float] = {}
        self.cache_hit = False
        disk = self._attach_flow_cache(flow_cache)
        key = self._table_key() if disk is not None else None
        if disk is not None:
            hit, val = disk.get(key)
            if hit and isinstance(val, dict) \
                    and val.get("v") == _TABLE_VERSION:
                for name in ("prefill_s", "prefill_base_s",
                             "prefill_per_seq_s", "decode_base_s",
                             "decode_per_seq_s"):
                    setattr(self, "_" + name,
                            {int(k): float(v)
                             for k, v in val[name].items()})
                self.cache_hit = True
        if not self.cache_hit:
            self._build()
            if disk is not None:
                disk.put(key, {
                    "v": _TABLE_VERSION,
                    "prefill_s": dict(self._prefill_s),
                    "prefill_base_s": dict(self._prefill_base_s),
                    "prefill_per_seq_s": dict(self._prefill_per_seq_s),
                    "decode_base_s": dict(self._decode_base_s),
                    "decode_per_seq_s": dict(self._decode_per_seq_s)})

    # -- construction -------------------------------------------------

    @staticmethod
    def _attach_flow_cache(flow_cache: Optional[str]
                           ) -> Optional[PassDiskCache]:
        """Bind the flow pass disk cache (same discipline as
        ``explore.ExplorationEngine``) and return whichever disk tier
        ends up active — the whole-table cache rides in it too, so one
        directory serves both pass outputs and finished tables."""
        if flow_cache:
            os.environ[_FLOW_CACHE_ENV] = flow_cache
            pipe = default_pipeline()
            if pipe.disk is None or pipe.disk.root != flow_cache:
                pipe.disk = PassDiskCache(flow_cache)
        return default_pipeline().disk

    def _table_key(self) -> str:
        payload = {
            "v": _TABLE_VERSION,
            "chip": dataclasses.asdict(self.chip),
            "fidelity": self.fidelity,
            "fit_batch": self.fit_batch,
            "incremental": self.incremental,
            "model": self.cfg.to_dict(),
            "prefill_buckets": list(self.prefill_buckets),
            "decode_buckets": list(self.decode_buckets),
            "system": (self.system.to_dict()
                       if self.system is not None else None),
            "calibration": (self.calibration.to_dict()
                            if self.calibration is not None else None),
        }
        blob = json.dumps(payload, sort_keys=True, default=str)
        return ("servetable-"
                + hashlib.sha256(blob.encode("utf-8")).hexdigest())

    def _compile(self, workload: str, kw: Dict[str, Any]):
        return flow_compile(workload, self.chip, CompileOptions(
            workload_kw=kw, fidelity=self.fidelity, batch=1,
            system=self.system, calibration=self.calibration))

    def _evaluate(self, art: Any) -> float:
        """Cycles of one evaluation; only the simulator takes a device."""
        kw = {"device": self.device} if self.fidelity == "simulate" else {}
        return float(art.evaluate(**kw).cycles)

    def _build(self) -> None:
        c = self.cfg
        k = self.fit_batch
        for b in self.prefill_buckets:
            kw = dict(n_layers=c.n_layers, d_model=c.d_model,
                      n_heads=c.n_heads, d_ff=c.d_ff, seq=b,
                      vocab=c.vocab)
            art = self._compile("transformer", kw)
            c1 = self._evaluate(art)
            # batch-1 cost stays the FIFO path's price verbatim: the
            # affine fit is for *batched* prefill, and base + per_seq
            # does not round-trip to c1 in float
            self._prefill_s[b] = c1 / self._hz
            ck = self._evaluate(art.replace_options(batch=k))
            per = max((ck - c1) / (k - 1), 0.0)
            self._prefill_per_seq_s[b] = per / self._hz
            self._prefill_base_s[b] = max(c1 - per, 0.0) / self._hz
        for b in self.decode_buckets:
            kw = dict(n_layers=c.n_layers, d_model=c.d_model,
                      n_heads=c.n_heads, d_ff=c.d_ff, kv_len=b,
                      vocab=c.vocab, incremental=self.incremental)
            art = self._compile("transformer_decode", kw)
            c1 = self._evaluate(art)
            # batch-K rides the same partition: replace_options keeps
            # the compiled plan and only re-prices the sample loop
            ck = self._evaluate(art.replace_options(batch=k))
            per = max((ck - c1) / (k - 1), 0.0)
            self._decode_per_seq_s[b] = per / self._hz
            self._decode_base_s[b] = max(c1 - per, 0.0) / self._hz

    # -- queries ------------------------------------------------------

    def prefill_s(self, prompt_len: int) -> float:
        return self._prefill_s[bucket_for(prompt_len,
                                          self.prefill_buckets)]

    def prefill_base_s(self, prompt_len: int) -> float:
        return self._prefill_base_s[bucket_for(prompt_len,
                                               self.prefill_buckets)]

    def prefill_per_seq_s(self, prompt_len: int) -> float:
        return self._prefill_per_seq_s[bucket_for(prompt_len,
                                                  self.prefill_buckets)]

    def prefill_batch_s(self, prompt_lens: Sequence[int]) -> float:
        """Price one batched prefill over mixed prompts, O(batch) —
        the same affine shape as :meth:`iteration_s`."""
        if not prompt_lens:
            return 0.0
        return (self.prefill_base_s(max(prompt_lens))
                + sum(self.prefill_per_seq_s(n) for n in prompt_lens))

    def decode_base_s(self, kv_len: int) -> float:
        return self._decode_base_s[bucket_for(kv_len,
                                              self.decode_buckets)]

    def decode_per_seq_s(self, kv_len: int) -> float:
        return self._decode_per_seq_s[bucket_for(kv_len,
                                                 self.decode_buckets)]

    def iteration_s(self, kv_lens: Sequence[int]) -> float:
        """Price one decode iteration over a mixed batch, O(batch)."""
        if not kv_lens:
            return 0.0
        return (self.decode_base_s(max(kv_lens))
                + sum(self.decode_per_seq_s(n) for n in kv_lens))

    def kv_bytes(self, kv_len: int) -> int:
        return self.cfg.kv_bytes(kv_len)

    # -- synthetic tables / dense views -------------------------------

    @classmethod
    def from_costs(cls, cfg: ServeModelCfg,
                   prefill_s: Dict[int, float],
                   decode_base_s: Dict[int, float],
                   decode_per_seq_s: Dict[int, float],
                   prefill_base_s: Optional[Dict[int, float]] = None,
                   prefill_per_seq_s: Optional[Dict[int, float]] = None,
                   fit_batch: int = 8) -> "StepCostTable":
        """Build a table from explicit per-bucket costs, skipping the
        compiler entirely — for tests and benchmarks that need a cheap
        deterministic table (e.g. million-request replays where the
        analytic build would dominate).  Bucket grids are taken from
        the dict keys.  Without an explicit prefill fit, batched
        prefill degenerates to ``base = batch-1 cost, per_seq = 0``.
        """
        t = cls.__new__(cls)
        t.cfg = cfg
        t.chip = default_chip()
        t.fidelity = "synthetic"
        t.fit_batch = fit_batch
        t.incremental = True
        t.system = None
        t.device = None
        t.calibration = None
        t._hz = t.chip.clock_ghz * 1e9
        t.prefill_buckets = sorted(int(k) for k in prefill_s)
        t.decode_buckets = sorted(int(k) for k in decode_base_s)
        if sorted(int(k) for k in decode_per_seq_s) != t.decode_buckets:
            raise ValueError("decode cost dicts must share buckets")
        t._prefill_s = {int(k): float(v) for k, v in prefill_s.items()}
        t._prefill_base_s = (
            {int(k): float(v) for k, v in prefill_base_s.items()}
            if prefill_base_s is not None else dict(t._prefill_s))
        t._prefill_per_seq_s = (
            {int(k): float(v) for k, v in prefill_per_seq_s.items()}
            if prefill_per_seq_s is not None
            else {b: 0.0 for b in t.prefill_buckets})
        t._decode_base_s = {int(k): float(v)
                            for k, v in decode_base_s.items()}
        t._decode_per_seq_s = {int(k): float(v)
                               for k, v in decode_per_seq_s.items()}
        t.cache_hit = False
        return t

    def dense_decode(self):
        """``(base_s, per_seq_s)`` numpy arrays indexed by KV length
        (0..max bucket) — the array engine's O(1) bucket lookup."""
        import numpy as np
        hi = self.decode_buckets[-1]
        base = np.empty(hi + 1, dtype=np.float64)
        per = np.empty(hi + 1, dtype=np.float64)
        for n in range(hi + 1):
            b = bucket_for(n, self.decode_buckets)
            base[n] = self._decode_base_s[b]
            per[n] = self._decode_per_seq_s[b]
        return base, per

    def dense_prefill(self):
        """``(batch1_s, base_s, per_seq_s)`` numpy arrays indexed by
        prompt length (0..max bucket)."""
        import numpy as np
        hi = self.prefill_buckets[-1]
        c1 = np.empty(hi + 1, dtype=np.float64)
        base = np.empty(hi + 1, dtype=np.float64)
        per = np.empty(hi + 1, dtype=np.float64)
        for n in range(hi + 1):
            b = bucket_for(n, self.prefill_buckets)
            c1[n] = self._prefill_s[b]
            base[n] = self._prefill_base_s[b]
            per[n] = self._prefill_per_seq_s[b]
        return c1, base, per

    def to_dict(self) -> Dict[str, Any]:
        return {
            "fidelity": self.fidelity,
            "fit_batch": self.fit_batch,
            "incremental": self.incremental,
            "system": (self.system.to_dict()
                       if self.system is not None else None),
            "model": self.cfg.to_dict(),
            "prefill_s": {str(k): v
                          for k, v in sorted(self._prefill_s.items())},
            "prefill_base_s": {
                str(k): v
                for k, v in sorted(self._prefill_base_s.items())},
            "prefill_per_seq_s": {
                str(k): v
                for k, v in sorted(self._prefill_per_seq_s.items())},
            "decode_base_s": {
                str(k): v
                for k, v in sorted(self._decode_base_s.items())},
            "decode_per_seq_s": {
                str(k): v
                for k, v in sorted(self._decode_per_seq_s.items())},
        }
