"""Synthetic-but-structured token stream (deterministic, resumable)."""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from ..configs.base import ArchConfig

__all__ = ["make_batch", "SyntheticStream"]


def _rng_for(seed: int, step: int, shard: int) -> np.random.Generator:
    # Philox counter-style determinism: independent of visit order
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, shard]))


def make_batch(cfg: ArchConfig, batch: int, seq: int, *, seed: int,
               step: int, shard: int = 0,
               n_shards: int = 1) -> Dict[str, np.ndarray]:
    """One (host-)shard of the global batch for a given step.

    Tokens follow a Zipfian-ish distribution with short-range structure
    (repeated n-grams) so losses behave like language data rather than
    white noise.
    """
    rng = _rng_for(seed, step, shard)
    b = batch // n_shards
    zipf = rng.zipf(1.3, size=(b, seq)).astype(np.int64)
    tokens = (zipf % (cfg.vocab - 2)) + 1
    # inject short-range structure: repeat the previous token with p=0.15
    rep = rng.random((b, seq)) < 0.15
    tokens[:, 1:] = np.where(rep[:, 1:], tokens[:, :-1], tokens[:, 1:])
    out: Dict[str, np.ndarray] = {"tokens": tokens.astype(np.int32)}
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.02
    if cfg.vision_tokens:
        out["patches"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32) * 0.02
    return out


class SyntheticStream:
    """Resumable iterator with a background prefetch thread."""

    def __init__(self, cfg: ArchConfig, batch: int, seq: int, *,
                 seed: int = 0, start_step: int = 0, shard: int = 0,
                 n_shards: int = 1, prefetch: int = 2) -> None:
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.step = start_step
        self.shard = shard
        self.n_shards = n_shards
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._next_produce = start_step
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        while not self._stop.is_set():
            b = make_batch(self.cfg, self.batch, self.seq, seed=self.seed,
                           step=self._next_produce, shard=self.shard,
                           n_shards=self.n_shards)
            self._q.put((self._next_produce, b))
            self._next_produce += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        step, b = self._q.get()
        self.step = step + 1
        return b

    # -- checkpoint integration ----------------------------------------------

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.seed}

    @classmethod
    def restore(cls, cfg: ArchConfig, batch: int, seq: int,
                state: Dict[str, int], **kw) -> "SyntheticStream":
        return cls(cfg, batch, seq, seed=state["seed"],
                   start_step=state["step"], **kw)

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
