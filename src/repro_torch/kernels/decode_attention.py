"""GQA decode attention over a KV cache: the CUDA kernel's wrapper, its
split planner and its plain PyTorch versions.

Counterpart of the scores/mask/softmax/context core of
:func:`repro.models.layers.attention_decode` (layers.py:305-325, with
``_kv_load`` :278).  :func:`gqa_decode_attention` dispatches on the
tensors' device: CUDA tensors launch the kernel
(``csrc/gqa_decode_attention.cu``, built by ``nvcc`` at first use; a
build or launch failure raises), CPU tensors run
:func:`gqa_decode_attention_ref`, which follows the reference's dtypes
step by step.  :func:`attention_splits` plans the kernel's grid and
:func:`gqa_decode_attention_splits_ref` is the kernel's algorithm (split
partials and their combine) as plain tensor code.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Dict, Optional, Tuple

import torch

from . import nvcc

__all__ = ["gqa_decode_attention", "gqa_decode_attention_ref",
           "gqa_decode_attention_splits_ref", "gqa_decode_attention_cuda",
           "kv_load", "ring_valid", "attention_splits", "row_boxes",
           "stage_slots", "build_library", "SOURCE", "MAX_BKV"]

KV_SCALE = 1.0 / 64          # the INT8 cache's fixed scale (_kv_store)
SOURCE = nvcc.CSRC / "gqa_decode_attention.cu"
# must match the .cu: a row is staged in boxes of BOX bytes, a stage holds
# STAGE_BYTES of K and V rows
BOX = 128
STAGE_BYTES = 32768
# a split reads at least this many bytes of K and V (rows as staged)
MIN_SPLIT_BYTES = 65536
# kernel kinds by (q dtype, cache dtype)
_KINDS = {(torch.bfloat16, torch.bfloat16): 0, (torch.bfloat16, torch.int8): 1,
          (torch.float32, torch.float32): 2, (torch.float32, torch.int8): 3}

_LIB: Optional[ctypes.CDLL] = None
# per device: int32 tickets of the split combine, one per (b, kv), zero
# between launches (the kernel puts each back); allocated once at
# MAX_BKV and never replaced, since a captured CUDA graph keeps their
# address
MAX_BKV = 1 << 16
_COUNTERS: Dict[int, torch.Tensor] = {}


def kv_load(c: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The cache in the compute dtype; INT8 entries times 1/64."""
    if c.dtype == torch.int8:
        return c.to(dtype) * KV_SCALE      # exact: a power of two
    return c.to(dtype)


def ring_valid(pos: int, s_cache: int, window: Optional[int],
               device) -> torch.Tensor:
    """``(s_cache,)`` bool: which ring slots hold positions the token at
    ``pos`` attends to (layers.py:313-318)."""
    idx = torch.arange(s_cache, device=device)
    slot = pos % s_cache
    wraps = (pos // s_cache) * s_cache
    abs_pos = torch.where(idx <= slot, wraps + idx, wraps - s_cache + idx)
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if window is not None:
        valid &= abs_pos > pos - window
    return valid


def gqa_decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, pos: int,
                             window: Optional[int] = None) -> torch.Tensor:
    """Plain version: ``q`` (B, KV, G, D) in the compute dtype, caches
    (B, S, KV, D) in it or INT8 -> context (B, KV, G, D).  Scores in the
    compute dtype, the mask and softmax in fp32, probabilities cast back
    before the context product, as the reference does."""
    s_cache = k_cache.shape[1]
    valid = ring_valid(pos, s_cache, window, q.device)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bkgd,bskd->bkgs", q,
                          kv_load(k_cache, q.dtype)) * scale
    scores = scores.to(torch.float32).masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgs,bskd->bkgd", probs, kv_load(v_cache, q.dtype))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def row_boxes(kv: int, d: int, elem: int) -> int:
    """``BOX``-byte boxes the kernel stages a head's row in: ``d``
    columns of ``elem`` bytes from the 16-byte unit that holds the first
    (TMA reads from 16-byte aligned columns only), the widest of the
    ``kv`` heads."""
    lead = max((h * d * elem) & 15 for h in range(kv))
    return _cdiv(lead + d * elem, BOX)


def stage_slots(boxes: int) -> int:
    """Cache slots per stage of the kernel's ring for rows of ``boxes``
    boxes: a stage holds ``STAGE_BYTES`` of K and V rows (a multiple of
    8 slots)."""
    return STAGE_BYTES // (2 * BOX * boxes) // 8 * 8


def attention_splits(bkv: int, s_end: int, boxes: int,
                     sms: int) -> Tuple[int, int]:
    """``(splits, slots per split)`` of the kernel's grid: ``bkv`` (b, kv)
    pairs, each reading slots ``[0, s_end)`` of rows staged in ``boxes``
    boxes (:func:`row_boxes`), on a card of ``sms`` SMs.

    A split is a whole number of stages and reads at least
    ``MIN_SPLIT_BYTES`` (one split when the pair has less), and none is
    empty.  The grid aims at one balanced wave of one block per SM, for
    every cache dtype: each block pays a fixed start and a combine, so
    fewer, longer blocks win (``chip_smoke.py`` 10a; PERF.md).  From the
    fewest splits that fill 95% of that wave, up to
    twice as many, the first whose blocks spread over the SMs within 5%
    (a whole number of blocks per SM less than a twentieth short), else
    the best spread.
    """
    per_stage = stage_slots(boxes)
    stages = _cdiv(s_end, per_stage)
    row = 2 * boxes * BOX                         # K and V bytes a slot
    cap = max(1, min(stages, s_end * row // MIN_SPLIT_BYTES))
    want = _cdiv(int(0.95 * sms), bkv)
    best = None
    for n in range(min(want, cap), min(2 * want, cap) + 1):
        per = _cdiv(stages, n)                    # stages per split
        nsp = _cdiv(stages, per)
        blocks = bkv * nsp
        spread = blocks / (sms * _cdiv(blocks, sms))
        if best is None or spread > best[0] + 1e-9:
            best = (spread, nsp, per * per_stage)
        if spread >= 0.95:
            break
    return best[1], best[2]


def gqa_decode_attention_splits_ref(q: torch.Tensor, k_cache: torch.Tensor,
                                    v_cache: torch.Tensor, pos: int,
                                    window: Optional[int],
                                    chunk: int) -> torch.Tensor:
    """The kernel's algorithm as plain tensor code: the slots to read,
    ``[0, min(S, pos + 1))``, cut every ``chunk`` slots; each split's
    (m, l, acc) with fp32 scores, its probabilities rounded to q's dtype
    before P.V; the splits combined as the last block combines them."""
    s_cache = k_cache.shape[1]
    s_end = min(s_cache, pos + 1)
    valid = ring_valid(pos, s_cache, window, q.device)
    scale = 1.0 / math.sqrt(q.shape[-1])
    q32 = q.float()
    k32 = kv_load(k_cache, torch.float32)
    vc = kv_load(v_cache, q.dtype)
    parts = []
    for lo in range(0, s_end, chunk):
        hi = min(lo + chunk, s_end)
        sc = torch.einsum("bkgd,bskd->bkgs", q32, k32[:, lo:hi]) * scale
        sc = sc.masked_fill(~valid[lo:hi], -math.inf)
        m = sc.amax(-1, keepdim=True)                       # (B, KV, G, 1)
        p = torch.exp(sc - torch.where(m == -math.inf, 0.0, m))
        acc = torch.einsum("bkgs,bskd->bkgd", p.to(q.dtype),
                           vc[:, lo:hi]).float()
        parts.append((m, p.sum(-1, keepdim=True), acc))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        w = torch.where(m == -math.inf, 0.0, torch.exp(m - big))
        num += w * acc
        den += w * l
    return (num / den).to(q.dtype)


def _check(q, k_cache, v_cache):
    if q.dim() != 4 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"need q (B,KV,G,D) and caches (B,S,KV,D), got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, kv, _, d = q.shape
    if (k_cache.shape[0], k_cache.shape[2], k_cache.shape[3]) != (b, kv, d):
        raise ValueError(f"cache {tuple(k_cache.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if k_cache.dtype != v_cache.dtype or (
            k_cache.dtype != torch.int8 and k_cache.dtype != q.dtype):
        raise TypeError(f"caches {k_cache.dtype}/{v_cache.dtype} with q "
                        f"{q.dtype}")
    if not q.is_floating_point():
        raise TypeError(f"q must be floating point, got {q.dtype}")


def build_library():
    """Compile ``csrc/gqa_decode_attention.cu`` (if not built yet);
    return the shared library's path."""
    return nvcc.build_library(SOURCE)


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        c_int, c_ll, c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.gqa_decode_attention_launch.argtypes = (
            [c_ptr] * 6 + [c_int] * 6 + [c_ll, c_int, c_ll]
            + [c_int] * 3 + [c_ptr])
        lib.gqa_decode_attention_launch.restype = c_int
        lib.gqa_decode_attention_error_string.argtypes = [c_int]
        lib.gqa_decode_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


@lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _counters(device: torch.device) -> torch.Tensor:
    """The ``MAX_BKV`` ticket counters of ``device``, zeroed at the
    first call on it.  That call must not be captured: the zeroing would
    run only when the graph is replayed."""
    cnt = _COUNTERS.get(device.index)
    if cnt is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "gqa_decode_attention: the first call on a device allocates "
                "its ticket counters and cannot be captured; make one call "
                "outside the CUDA graph first")
        cnt = torch.zeros(MAX_BKV, dtype=torch.int32, device=device)
        _COUNTERS[device.index] = cnt
    return cnt


def gqa_decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, pos: int,
                              window: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: one launch per call."""
    _check(q, k_cache, v_cache)
    if not (q.is_cuda and k_cache.device == q.device
            and v_cache.device == q.device):
        raise ValueError(f"no decode-attention kernel for {q.device}, "
                         f"{k_cache.device}")
    kind = _KINDS.get((q.dtype, k_cache.dtype))
    if kind is None:
        raise TypeError(f"no decode-attention kernel for q {q.dtype}, "
                        f"cache {k_cache.dtype}")
    b, kv, g, d = q.shape
    s_cache = k_cache.shape[1]
    elem = k_cache.element_size()
    if not (1 <= g <= 8 and 1 <= d <= 128 and d % 4 == 0
            and kv * d * elem % 16 == 0):
        raise ValueError(f"no decode-attention kernel for G {g}, D {d}, KV "
                         f"{kv} (needs G <= 8, D <= 128 a multiple of 4, "
                         f"16-byte cache rows)")
    if not 0 <= pos < 1 << 31:
        raise ValueError(f"pos {pos} out of range")
    if b * kv > MAX_BKV:
        raise ValueError(f"B * KV = {b * kv} over the kernel's {MAX_BKV}")
    q = q.contiguous()
    k_cache = k_cache.contiguous()
    v_cache = v_cache.contiguous()
    index = q.get_device()
    s_end = min(s_cache, pos + 1)
    nsp, chunk = attention_splits(b * kv, s_end, row_boxes(kv, d, elem),
                                  _sms(index))
    cnt = _counters(q.device)
    out = torch.empty_like(q)
    ws = None
    if nsp > 1:
        ws = torch.empty(b * kv * nsp * g * (d + 2), dtype=torch.float32,
                         device=q.device)
    lib = _LIB or _library()
    stream = torch._C._cuda_getCurrentRawStream(index)
    args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(),
            cnt.data_ptr(), b, s_cache, kv, g, d,
            kind, pos, int(window is not None),
            0 if window is None else window, s_end, chunk, nsp, stream)
    if index == torch.cuda.current_device():
        err = lib.gqa_decode_attention_launch(*args)
    else:
        with torch.cuda.device(index):
            err = lib.gqa_decode_attention_launch(*args)
    if err:
        raise RuntimeError(
            "gqa_decode_attention_launch failed: "
            f"{lib.gqa_decode_attention_error_string(err).decode()}")
    gqa_decode_attention.launches += 1
    return out


def gqa_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: int,
                         window: Optional[int] = None) -> torch.Tensor:
    """Attention of one token at absolute position ``pos`` (a host int)
    over ring caches that already hold it: ``q`` (B, KV, G, D), caches
    (B, S, KV, D) in q's dtype or INT8 (scale 1/64) -> (B, KV, G, D) in
    q's dtype.  CUDA: the kernel; CPU: the plain version."""
    if q.device.type in ("cpu", "meta"):  # meta: the dry run
        _check(q, k_cache, v_cache)
        return gqa_decode_attention_ref(q, k_cache, v_cache, pos, window)
    return gqa_decode_attention_cuda(q, k_cache, v_cache, pos, window)


# kernel launches since the last reset, one per call (CPU calls excluded)
gqa_decode_attention.launches = 0
