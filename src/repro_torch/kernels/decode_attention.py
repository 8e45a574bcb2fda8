"""GQA decode attention over a KV cache: the Triton kernel's wrapper and
its plain PyTorch version.

Counterpart of the scores/mask/softmax/context core of
:func:`repro.models.layers.attention_decode` (layers.py:305-325, with
``_kv_load`` :278).  :func:`gqa_decode_attention` dispatches on the
tensors' device: CUDA tensors launch the kernel
(``csrc/gqa_decode_attention.py``; a build or launch failure raises),
CPU tensors run :func:`gqa_decode_attention_ref`, which follows the
reference's dtypes step by step.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import triton_source

__all__ = ["gqa_decode_attention", "gqa_decode_attention_ref",
           "gqa_decode_attention_cuda", "kv_load", "ring_valid",
           "splits_for", "BLOCK_S"]

KV_SCALE = 1.0 / 64          # the INT8 cache's fixed scale (_kv_store)
BLOCK_S = 64                 # cache slots per step of one program


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


def splits_for(bkv: int, s_end: int, sms: int) -> Tuple[int, int]:
    """``(splits, slots per split)``: programs per (b, kv) over the
    ``s_end`` slots to read, enough for about two per SM of a card with
    ``sms`` of them, each at least one block of slots (a multiple of
    ``BLOCK_S``), none empty."""
    blocks = -(-s_end // BLOCK_S)
    want = max(1, -(-2 * sms // bkv))
    per = -(-blocks // min(blocks, want)) * BLOCK_S
    return -(-s_end // per), per


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


def gqa_decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, pos: int,
                              window: Optional[int] = None) -> torch.Tensor:
    """Launch the split kernel and its combine pass on CUDA tensors."""
    _check(q, k_cache, v_cache)
    if not (q.is_cuda and k_cache.device == q.device
            and v_cache.device == q.device):
        raise ValueError(f"no decode-attention kernel for {q.device}, "
                         f"{k_cache.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"no decode-attention kernel for {q.dtype}")
    b, kv, g, d = q.shape
    s_cache = k_cache.shape[1]
    if not 0 <= pos < 1 << 31:
        raise ValueError(f"pos {pos} out of range")
    q = q.contiguous()
    k_cache = k_cache.contiguous()
    v_cache = v_cache.contiguous()
    mod = triton_source.load("gqa_decode_attention")
    gp = max(16, 1 << (g - 1).bit_length())
    bd = max(16, 1 << (d - 1).bit_length())
    s_end = min(s_cache, pos + 1)
    index = q.get_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    nsp, chunk = splits_for(b * kv, s_end, sms)
    m = torch.empty((b * kv, nsp, gp), dtype=torch.float32, device=q.device)
    den = torch.empty_like(m)
    acc = torch.empty((b * kv, nsp, gp, bd), dtype=torch.float32,
                      device=q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(index):
        mod.gqa_decode_split_kernel[(b * kv, nsp)](
            q, k_cache, v_cache, m, den, acc, pos,
            0 if window is None else window, s_cache, chunk, s_end,
            1.0 / math.sqrt(d), KV=kv, G=g, D=d, GP=gp, BLOCK_D=bd,
            BLOCK_S=BLOCK_S, INT8=k_cache.dtype == torch.int8,
            HAS_WINDOW=window is not None,
            IEEE=q.dtype == torch.float32, num_warps=4, num_stages=3)
        mod.gqa_decode_combine_kernel[(b * kv,)](
            m, den, acc, out, nsp, G=g, D=d, GP=gp, BLOCK_D=bd,
            num_warps=4)
    gqa_decode_attention.launches += 1
    return out


def gqa_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: int,
                         window: Optional[int] = None) -> torch.Tensor:
    """Attention of one token at absolute position ``pos`` (a host int)
    over ring caches that already hold it: ``q`` (B, KV, G, D), caches
    (B, S, KV, D) in q's dtype or INT8 (scale 1/64) -> (B, KV, G, D) in
    q's dtype.  CUDA: the Triton kernel; CPU: the plain version."""
    if q.device.type == "cpu":
        _check(q, k_cache, v_cache)
        return gqa_decode_attention_ref(q, k_cache, v_cache, pos, window)
    return gqa_decode_attention_cuda(q, k_cache, v_cache, pos, window)


# kernel launches (split + combine, counted once) since the last reset;
# CPU calls excluded
gqa_decode_attention.launches = 0
