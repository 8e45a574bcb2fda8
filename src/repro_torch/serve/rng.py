"""Vectorized, CPython-compatible MT19937 word stream.

``random.Random`` is the committed definition of every serving trace
(the 200-request golden trace was drawn from it), so the vectorized
trace generators cannot switch RNGs without changing bytes.  Instead
:class:`VecMT` reproduces CPython's Mersenne Twister *exactly* — it
seeds itself from ``random.Random(seed).getstate()`` (so seeding
semantics are CPython's by construction) and then regenerates the
624-word state blocks with numpy array ops instead of one C call per
draw.

The in-place twist reads a mix of old and already-updated state words,
which vectorizes as four slice passes (the classic reference loop's
``mt[kk+(M-N)]`` reads new words, so the middle section is split where
its reads would overlap its own writes):

* ``kk in [0, N-M)``      — sources entirely old state;
* ``kk in [N-M, 2(N-M))`` — sources pass-1 output;
* ``kk in [2(N-M), N-1)`` — sources pass-2 output;
* ``kk = N-1``            — reads the *new* ``mt[0]``.

Tempering is elementwise.  The result is a bit-identical uint32 stream
to ``Random.getrandbits(32)`` at ~10x the throughput, and — more
importantly — a stream the trace generators can slice into arrays.

Consumption helpers mirror the two CPython primitives the trace
generators use:

* ``random()``  — two words: ``(a >> 5) * 2**26 + (b >> 6)`` scaled by
  ``2**-53``;
* ``_randbelow(n)`` — ``getrandbits(k)`` (= one word ``>> (32 - k)``
  for ``k <= 32``) redrawn while the value is ``>= n``.

The rejection loop makes word consumption data-dependent, so batch
extraction first walks the op layout over a prefetched word buffer
(cheap integer scan), then gathers all values with numpy fancy
indexing.
"""
from __future__ import annotations

import bisect
import random
from typing import List, Tuple

import numpy as np

__all__ = ["VecMT", "uniform_randbelow_batch", "uniform_at"]

_N, _M = 624, 397
_UPPER = np.uint32(0x80000000)
_LOWER = np.uint32(0x7FFFFFFF)
_MAG = np.uint32(0x9908B0DF)
_ZERO = np.uint32(0)


class VecMT:
    """CPython-bit-identical MT19937 emitting numpy word blocks."""

    def __init__(self, seed: int) -> None:
        state = random.Random(seed).getstate()[1]
        # a freshly seeded Random has consumed nothing: index == N
        assert state[_N] == _N, "VecMT requires a fresh seed state"
        self._mt = np.array(state[:_N], dtype=np.uint32)
        self._buf = np.empty(0, dtype=np.uint32)
        self._consumed = 0

    # -- block generation ---------------------------------------------

    def _twist(self) -> np.ndarray:
        mt = self._mt
        nxt = np.empty(_N, dtype=np.uint32)
        one = np.uint32(1)

        def tw(y: np.ndarray, src: np.ndarray) -> np.ndarray:
            return src ^ (y >> one) ^ np.where(y & one, _MAG, _ZERO)

        k = _N - _M                                      # 227
        y = (mt[0:k] & _UPPER) | (mt[1:k + 1] & _LOWER)
        nxt[0:k] = tw(y, mt[_M:_N])
        y = (mt[k:2 * k] & _UPPER) | (mt[k + 1:2 * k + 1] & _LOWER)
        nxt[k:2 * k] = tw(y, nxt[0:k])
        y = (mt[2 * k:_N - 1] & _UPPER) | (mt[2 * k + 1:_N] & _LOWER)
        nxt[2 * k:_N - 1] = tw(y, nxt[k:_M - 1])
        y = (mt[_N - 1] & _UPPER) | (nxt[0] & _LOWER)    # new mt[0]
        nxt[_N - 1] = tw(y, nxt[_M - 1])

        self._mt = nxt
        x = nxt.copy()
        x ^= x >> np.uint32(11)
        x ^= (x << np.uint32(7)) & np.uint32(0x9D2C5680)
        x ^= (x << np.uint32(15)) & np.uint32(0xEFC60000)
        x ^= x >> np.uint32(18)
        return x

    # -- stream access ------------------------------------------------

    def peek(self, n: int) -> np.ndarray:
        """First ``n`` unconsumed words, without consuming them."""
        if len(self._buf) < n:
            blocks = [self._buf]
            have = len(self._buf)
            while have < n:
                blocks.append(self._twist())
                have += _N
            self._buf = np.concatenate(blocks)
        return self._buf[:n]

    def consume(self, n: int) -> None:
        assert n <= len(self._buf), "consume past peeked buffer"
        self._buf = self._buf[n:]
        self._consumed += n

    @property
    def consumed(self) -> int:
        """Total words consumed — equals ``getrandbits(32)`` calls."""
        return self._consumed


_INV53 = 1.0 / 9007199254740992.0     # CPython's random() scaling


def uniform_randbelow_batch(
        mt: VecMT, n: int,
        spans: Tuple[int, ...]) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Draw ``n`` repetitions of one ``random()`` double followed by
    one ``_randbelow(span)`` per span, mirroring CPython's word
    consumption order exactly (each rejected ``getrandbits`` draw
    burns one word).

    Returns ``(uniforms, [randbelow values per span])`` as numpy
    arrays.  The layout walk is an integer pointer chase over a
    prefetched accept mask (rejection makes consumption
    data-dependent); all values are then gathered with vectorized
    fancy indexing.
    """
    if n == 0:
        return (np.empty(0, dtype=np.float64),
                [np.empty(0, dtype=np.int64) for _ in spans])
    # _randbelow(s) draws k = s.bit_length() bits, i.e. one word
    # shifted right by 32-k, and redraws while the value is >= s.
    shifts = [np.uint32(32 - s.bit_length()) for s in spans]
    nspan = len(spans)
    stride = 2 + nspan                # words/request with zero rejects

    def masks(w: np.ndarray):
        return [(w >> sh) < s for sh, s in zip(shifts, spans)]

    # expected words per _randbelow(s) is 2^k / s (geometric redraw);
    # provision the expectation plus slack so re-peeking stays rare
    exp_words = 2.0 + sum((1 << s.bit_length()) / s for s in spans)
    words = mt.peek(int(n * exp_words) + 4096)
    accept = masks(words)

    # A request starting at w is "clean" (consumes exactly `stride`
    # words, span j accepted at w+2+j) iff every span's first draw
    # accepts.  Rejects are sparse (k-bit acceptance > 1/2, typically
    # ~0.95), so the walk is a run-jump scan: bisect to the next dirty
    # start in this residue class mod `stride`, emit the clean run as
    # one segment, resolve the single dirty request scalar.
    def dirty_lists(lo: int, hi: int):
        w = hi - (stride - 1)
        clean = accept[0][lo + 2:w + 2].copy()
        for j in range(1, nspan):
            clean &= accept[j][lo + 2 + j:w + 2 + j]
        bad = np.flatnonzero(~clean) + lo
        return [bad[bad % stride == r].tolist() for r in range(stride)]

    dirty = dirty_lists(0, len(words))

    def extend() -> None:
        nonlocal words, accept, dirty
        old = len(words)
        words = mt.peek(old + max(4096, old >> 1))
        tail = masks(words[old:])
        accept = [np.concatenate([a, t]) for a, t in zip(accept, tail)]
        seam = old - (stride - 1)     # clean[] near the seam was cut off
        for r, lst in zip(range(stride), dirty_lists(seam, len(words))):
            dirty[r].extend(x for x in lst if x >= seam)

    seg_i: List[int] = []             # first request index of segment
    seg_cnt: List[int] = []           # requests in segment
    seg_s: List[int] = []             # word position of first request
    fix_i = [[] for _ in spans]       # dirty request -> true position
    fix_p = [[] for _ in spans]
    s = 0
    i = 0
    while i < n:
        lst = dirty[s % stride]
        k = bisect.bisect_left(lst, s)
        b = lst[k] if k < len(lst) else None
        if b is None or (b - s) // stride >= n - i:
            seg_i.append(i)
            seg_cnt.append(n - i)
            seg_s.append(s)
            s += stride * (n - i)
            i = n
            break
        run = (b - s) // stride       # clean requests before the dirty
        seg_i.append(i)
        seg_cnt.append(run + 1)
        seg_s.append(s)
        i += run + 1
        pos = b + 2
        for j in range(nspan):
            while pos + 1 >= len(words) or not accept[j][pos]:
                if pos + 1 >= len(words):
                    extend()
                    continue
                pos += 1
            fix_i[j].append(i - 1)
            fix_p[j].append(pos)
            pos += 1
        s = pos
    while s + 64 > len(words):
        extend()

    base = np.array(seg_s, dtype=np.int64) - \
        np.array(seg_i, dtype=np.int64) * stride
    u_pos = np.repeat(base, seg_cnt) + \
        np.arange(n, dtype=np.int64) * stride
    rb_pos = [u_pos + (2 + j) for j in range(nspan)]
    for j in range(nspan):
        if fix_i[j]:
            rb_pos[j][np.array(fix_i[j])] = np.array(fix_p[j])

    a = (words[u_pos] >> np.uint32(5)).astype(np.float64)
    b = (words[u_pos + 1] >> np.uint32(6)).astype(np.float64)
    uniforms = (a * 67108864.0 + b) * _INV53
    values = [(words[p] >> sh).astype(np.int64)
              for p, sh in zip(rb_pos, shifts)]
    mt.consume(s)
    return uniforms, values


def uniform_at(words: np.ndarray, pos: int) -> float:
    """CPython ``random()`` double from two stream words at ``pos``."""
    return (float(words[pos] >> np.uint32(5)) * 67108864.0
            + float(words[pos + 1] >> np.uint32(6))) * _INV53
