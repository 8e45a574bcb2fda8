"""The one traffic generator: a mix file's parameters and a seed in, the
calls of a run out.

Every seed gives the same multiset of call shapes: each cycle of
``cycle_calls`` calls holds each bucket ``round(weight * cycle_calls)``
times, in an order drawn from the seed.  Token ids are drawn from the
seed on the device, in one call, for a pool of ``pool`` distinct calls
that the window cycles through.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

# the generators of weights and of data are seeded apart
DATA_SALT = 0x5EED_DA7A
_MASK = (1 << 63) - 1


def data_seed(seed: int) -> int:
    return (int(seed) * 2654435761 + DATA_SALT) & _MASK


@dataclass(frozen=True)
class Call:
    """One call of a window: ``batch`` rows of ``seq`` tokens, its ids
    ``pool_index`` in the pool."""

    index: int
    batch: int
    seq: int
    pool_index: int

    @property
    def tokens(self) -> int:
        return self.batch * self.seq


def shapes(mix: Dict[str, Any]) -> List[Tuple[int, int]]:
    """The ``(batch, seq)`` shapes the mix uses, longest sequence last."""
    if mix["kind"] == "train":
        return [(int(mix["batch"]), int(mix["seq"]))]
    budget = int(mix["tokens_per_call"])
    out = []
    for s in mix["buckets"]["seq"]:
        if budget % int(s):
            raise ValueError(f"seq {s} does not divide the call's "
                             f"{budget} tokens")
        out.append((budget // int(s), int(s)))
    return sorted(out, key=lambda bs: bs[1])


def cycle(mix: Dict[str, Any]) -> List[Tuple[int, int]]:
    """One cycle's shapes, in bucket order."""
    if mix["kind"] == "train":
        return shapes(mix)
    n = int(mix["cycle_calls"])
    counts = [round(float(w) * n) for w in mix["buckets"]["weight"]]
    if sum(counts) != n or min(counts) < 1:
        raise ValueError(f"weights {mix['buckets']['weight']} do not "
                         f"split {n} calls")
    budget = int(mix["tokens_per_call"])
    out = []
    for s, c in zip(mix["buckets"]["seq"], counts):
        out += [(budget // int(s), int(s))] * c
    return out


def calls(mix: Dict[str, Any], seed: int, n: int) -> List[Call]:
    """The first ``n`` calls of a run with ``seed``: whole cycles, each
    shuffled by the seed's generator."""
    rng = random.Random(data_seed(seed))
    one = cycle(mix)
    pool = int(mix["pool"])
    out: List[Call] = []
    while len(out) < n:
        order = list(one)
        rng.shuffle(order)
        for b, s in order:
            if len(out) == n:
                break
            out.append(Call(len(out), b, s, len(out) % pool))
    return out


def token_pool(mix: Dict[str, Any], seed: int, vocab: int,
               device) -> torch.Tensor:
    """``(pool, tokens a call)`` int32 ids drawn from the seed on
    ``device``; a call takes its row of the pool as ``(batch, seq)``."""
    per_call = max(b * s for b, s in shapes(mix))
    gen = torch.Generator(device).manual_seed(data_seed(seed))
    return torch.randint(0, vocab, (int(mix["pool"]), per_call),
                         generator=gen, dtype=torch.int32, device=device)


def call_tokens(pool: torch.Tensor, call: Call) -> torch.Tensor:
    """The ``(batch, seq)`` ids of ``call`` (a view of its pool row)."""
    return pool[call.pool_index, :call.tokens].view(call.batch, call.seq)
