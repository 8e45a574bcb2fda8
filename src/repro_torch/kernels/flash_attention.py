"""Masked softmax attention on the GQA layout, forward and backward: the
CUDA kernel's wrapper, its autograd, its block planner and its plain
PyTorch versions.

Counterpart of the attention core of training and prefill in
:mod:`repro.models.layers`: ``_gqa_scores_ctx`` (layers.py:117) and
``flash_attention`` (:130, XLA compute, not a Pallas kernel), with the
mask of ``_mask_fn`` (:194).  ``q`` (B, Sq, KV, G, D), ``k`` (B, Sk, KV,
D), ``v`` (B, Sk, KV, Dv) -> (B, Sq, KV, G, Dv); scale 1/sqrt(D); query
row i sits at absolute position ``q_pos0 + i`` and sees key j when
``j <= q_pos0 + i`` (``causal``) and ``j > q_pos0 + i - window``
(``window``, under either).

:func:`flash_attention_cuda` launches the kernel that :func:`route`
plans (CUDA C++ for ``sm_90a``, built by ``nvcc`` at first use; a build
or launch failure raises) through :class:`FlashAttention`: one forward
launch that also writes the fp32 log-sum-exp, and in the backward three
launches (``delta``, then dK and dV, then dQ).  bf16 takes the ``sm90``
route, ``csrc/flash_attention_sm90.cu`` (``wgmma`` fed by TMA, a producer
warp and two consumer warpgroups, at :data:`SM90_BLOCKS`); fp32 the
``mma`` route, ``csrc/flash_attention.cu`` (``mma.sync``, FMA for fp32,
at :data:`BLOCK_Q` / :data:`BLOCK_K`).  It takes CUDA tensors only: on
the CPU and ``meta`` tensors :mod:`repro_torch.models.layers` keeps the
reference's own switch between its two plain versions.

:func:`kv_block_range` and :func:`q_block_range` plan which key blocks
each query block visits (both routes compute the same formulas at their
own blocks: on the ``mma`` route 64-row query blocks, 128 in the bf16
forward up to head dim 128, and 64-key blocks);
:func:`flash_attention_fwd_ref` and :func:`flash_attention_bwd_ref` are
the kernel's algorithm as plain tensor code over those blocks (fp32
scores and running statistics; the probabilities, and in the backward
dS, rounded to the input dtype before each second product, as the
kernel rounds them for the tensor cores).  A row that no key may see
comes out 0 with lse ``-inf``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import nvcc

__all__ = ["flash_attention_cuda", "flash_attention_fwd_cuda",
           "flash_attention_bwd_cuda", "flash_attention_fwd_ref",
           "flash_attention_bwd_ref", "FlashAttention", "kv_block_range",
           "q_block_range", "padded_dims", "build_library", "SOURCE",
           "BLOCK_Q", "BLOCK_K", "launches_by_pass", "reset_launches",
           "route", "ROUTES", "SOURCE_SM90", "SM90_BLOCKS", "load_sm90",
           "launches_by_route"]

# the mma route's source
SOURCE = nvcc.CSRC / "flash_attention.cu"
# must match the .cu (kBQ, kBK): query rows and keys of a block (the bf16
# forward up to head dim 128 takes two query blocks at once)
BLOCK_Q = 64
BLOCK_K = 64
# the kernel's dtypes and their codes
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# the sm90 route's source and its blocks by padded head dim, (query rows,
# keys): must match flash_attention_sm90.cu (kFwdBQ, kFwdBK; kBwdBQ, or
# kBwdBQWide at 192, and kBwdBK; kDqBQ, kDqBK)
SOURCE_SM90 = nvcc.CSRC / "flash_attention_sm90.cu"
SM90_BLOCKS = {dp: {"fwd": (128, 128),
                    "dkdv": (32 if dp == 192 else 64, 128),
                    "dq": (128, 64)} for dp in (64, 128, 192)}
ROUTES = ("sm90", "mma")

_LIB: Optional[ctypes.CDLL] = None
_SM90_LIB: Optional[ctypes.CDLL] = None
# calls since the last reset (CPU calls excluded): "fwd" one launch each,
# "bwd" three (delta, dK and dV, dQ)
launches_by_pass: Dict[str, int] = {"fwd": 0, "bwd": 0}
# kernel launches since the last reset by route (a forward one, a
# backward three)
launches_by_route: Dict[str, int] = {r: 0 for r in ROUTES}


def route(dtype: torch.dtype, d: int, dv: int) -> str:
    """The planned kernel: ``"sm90"`` (``wgmma`` fed by TMA) for bf16,
    ``"mma"`` (``mma.sync``; FMA in fp32) for fp32.  Raises on a dtype or
    head dims that neither takes."""
    if padded_dims(d, dv) is None:
        raise ValueError(f"no flash-attention kernel for head dims D {d}, "
                         f"Dv {dv}")
    if dtype == torch.bfloat16:
        return "sm90"
    if dtype == torch.float32:
        return "mma"
    raise TypeError(f"no flash-attention kernel for {dtype}")


def padded_dims(d: int, dv: int) -> Optional[int]:
    """The head dim the kernel pads q and k to (v to 64 or 128): 64 when
    both fit, 128, or 192 for MLA's (192, 128); ``None`` past those."""
    if d <= 64 and dv <= 64:
        return 64
    if d <= 128 and dv <= 128:
        return 128
    if d <= 192 and dv <= 128:
        return 192
    return None


def kv_block_range(q_block: int, sq: int, sk: int, block_q: int,
                   block_k: int, causal: bool, window: Optional[int],
                   q_pos0: int = 0) -> Tuple[int, int]:
    """``[lo, hi)``: the key blocks that query block ``q_block`` visits,
    those holding a key that some row of the block may see (empty when
    none).  Every block outside is masked for every row of the block."""
    p0 = q_pos0 + q_block * block_q
    p1 = q_pos0 + min(q_block * block_q + block_q, sq) - 1
    kmin, kmax = 0, sk - 1
    if window is not None:
        kmin = max(kmin, p0 - window + 1)
    if causal:
        kmax = min(kmax, p1)
    if kmin > kmax:
        return 0, 0
    return kmin // block_k, kmax // block_k + 1


def q_block_range(k_block: int, sq: int, sk: int, block_q: int,
                  block_k: int, causal: bool, window: Optional[int],
                  q_pos0: int = 0) -> Tuple[int, int]:
    """``[lo, hi)``: the query blocks that visit key block ``k_block``
    (the backward's dK and dV walk); the same block pairs as
    :func:`kv_block_range`."""
    k0 = k_block * block_k
    k1 = min(k0 + block_k, sk) - 1
    rmin, rmax = 0, sq - 1
    if causal:
        rmin = max(rmin, k0 - q_pos0)
    if window is not None:
        rmax = min(rmax, k1 + window - 1 - q_pos0)
    if rmin > rmax:
        return 0, 0
    return rmin // block_q, rmax // block_q + 1


def _visible(qpos, kpos, sk: int, causal: bool, window: Optional[int]):
    ok = kpos < sk
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    return ok


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def flash_attention_fwd_ref(q, k, v, causal: bool = True,
                            window: Optional[int] = None, q_pos0: int = 0,
                            block_q: int = BLOCK_Q, block_k: int = BLOCK_K):
    """The kernel's forward as plain tensor code: ``(O, lse)``, O in q's
    dtype, lse (B, KV, G, Sq) fp32 (natural log).  Each query block walks
    :func:`kv_block_range`'s key blocks with an online softmax."""
    b, sq, kvh, g, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    out = torch.zeros((b, sq, kvh, g, dv), dtype=torch.float32, device=dev)
    lse = torch.full((b, kvh, g, sq), -math.inf, dtype=torch.float32,
                     device=dev)
    for i in range(_cdiv(sq, block_q)):
        r0, r1 = i * block_q, min(sq, (i + 1) * block_q)
        qb = q[:, r0:r1].float()
        qpos = (q_pos0 + torch.arange(r0, r1, device=dev))[:, None]
        m = torch.full((b, kvh, g, r1 - r0), -math.inf, device=dev)
        l = torch.zeros((b, kvh, g, r1 - r0), device=dev)
        acc = torch.zeros((b, kvh, g, r1 - r0, dv), device=dev)
        lo, hi = kv_block_range(i, sq, sk, block_q, block_k, causal, window,
                                q_pos0)
        for j in range(lo, hi):
            c0, c1 = j * block_k, min(sk, (j + 1) * block_k)
            s = torch.einsum("bqkgd,bskd->bkgqs", qb,
                             k[:, c0:c1].float()) * scale
            kpos = torch.arange(c0, c1, device=dev)[None, :]
            s = s.masked_fill(~_visible(qpos, kpos, sk, causal, window),
                              -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            base = torch.where(m_new == -math.inf, 0.0, m_new)
            p = torch.exp(s - base[..., None])
            corr = torch.exp(m - base)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(q.dtype).float(),
                v[:, c0:c1].float())
            m = m_new
        seen = l > 0
        o = torch.where(seen[..., None], acc / torch.where(seen, l, 1.0)
                        [..., None], 0.0)
        out[:, r0:r1] = o.permute(0, 3, 1, 2, 4)
        lse[..., r0:r1] = torch.where(seen, m + torch.log(l), -math.inf)
    return out.to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True,
                            window: Optional[int] = None, q_pos0: int = 0,
                            block_q: int = BLOCK_Q, block_k: int = BLOCK_K):
    """The kernel's backward as plain tensor code: ``(dq, dk, dv)`` in the
    inputs' dtypes from q, k, v, the forward's O and lse and O's
    gradient ``do``: ``delta = rowsum(do * O)``, then over the same block
    pairs P = exp(S - lse), dV += P^T dO, dP = dO V^T,
    dS = P (dP - delta), dQ += dS K, dK += dS^T Q (dQ and dK scaled
    once at the end)."""
    b, sq, kvh, g, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    dev = q.device

    def rnd(x):                 # the kernel's operand rounding
        return x.to(q.dtype).float()

    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 3, 1)
    lse_used = torch.where(lse == -math.inf, math.inf, lse)
    dq = torch.zeros(q.shape, device=dev)
    dk = torch.zeros(k.shape, device=dev)
    dv = torch.zeros(v.shape, device=dev)
    for i in range(_cdiv(sq, block_q)):
        r0, r1 = i * block_q, min(sq, (i + 1) * block_q)
        qb, dob = q[:, r0:r1].float(), do[:, r0:r1].float()
        qpos = (q_pos0 + torch.arange(r0, r1, device=dev))[:, None]
        lo, hi = kv_block_range(i, sq, sk, block_q, block_k, causal, window,
                                q_pos0)
        for j in range(lo, hi):
            c0, c1 = j * block_k, min(sk, (j + 1) * block_k)
            kb, vb = k[:, c0:c1].float(), v[:, c0:c1].float()
            kpos = torch.arange(c0, c1, device=dev)[None, :]
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb) * scale
            p = torch.exp(s - lse_used[..., r0:r1, None]).masked_fill(
                ~_visible(qpos, kpos, sk, causal, window), 0.0)
            dv[:, c0:c1] += torch.einsum("bkgqs,bqkgd->bskd", rnd(p), dob)
            dp = torch.einsum("bqkgd,bskd->bkgqs", dob, vb)
            ds = rnd(p * (dp - delta[..., r0:r1, None]))
            dq[:, r0:r1] += torch.einsum("bkgqs,bskd->bqkgd", ds, kb)
            dk[:, c0:c1] += torch.einsum("bkgqs,bqkgd->bskd", ds, qb)
    return ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))


def _layout_ok(t: torch.Tensor) -> bool:
    """The last dim contiguous, every other stride (of a dim wider than
    1) a multiple of 16 bytes, the data 16-byte aligned."""
    elem = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * elem % 16 == 0
                    for n, st in zip(t.shape[:-1], t.stride()[:-1])
                    if n > 1))


def _check(q, k, v, window: Optional[int] = None) -> None:
    """The kernel's contract, on any device (``meta`` included): raises
    on a shape, dtype, head dim, window or stride it does not take."""
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"need q (B,Sq,KV,G,D), k (B,Sk,KV,D) and v "
                         f"(B,Sk,KV,Dv), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, kvh, g, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, kvh, d) \
            or tuple(v.shape[:3]) != tuple(k.shape[:3]):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"no flash-attention kernel for q {q.dtype}, k "
                        f"{k.dtype}, v {v.dtype} (bf16 or fp32, all alike)")
    elem = q.element_size()
    if padded_dims(d, dv) is None or d * elem % 16 or dv * elem % 16:
        raise ValueError(f"no flash-attention kernel for head dims D {d}, "
                         f"Dv {dv} (multiples of 16 bytes; D, Dv <= 128, or "
                         f"D <= 192 with Dv <= 128)")
    if min(b, sq, sk, kvh, g) < 1 or b * kvh * g > 65535:
        raise ValueError(f"no flash-attention kernel for B {b}, Sq {sq}, "
                         f"Sk {sk}, KV {kvh}, G {g}")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be at least 1")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _layout_ok(t):
            raise ValueError(f"{name} strides {t.stride()}: the last dim "
                             f"must be contiguous and the others multiples "
                             f"of 16 bytes, 16-byte aligned")


def build_library(source=SOURCE):
    """Compile ``source`` (the ``mma`` route's by default; if not built
    yet); return the shared library's path."""
    return nvcc.build_library(source)


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.flash_attention_fwd.argtypes = (
            [c_int] + [c_ptr] * 5 + [strides] + [c_int] * 10 + [c_ptr])
        lib.flash_attention_fwd.restype = c_int
        lib.flash_attention_bwd.argtypes = (
            [c_int] + [c_ptr] * 10 + [strides] + [c_int] * 10 + [c_ptr])
        lib.flash_attention_bwd.restype = c_int
        lib.flash_attention_error_string.argtypes = [c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def load_sm90(path) -> ctypes.CDLL:
    """The ``sm90`` route's shared library at ``path`` (built from
    ``SOURCE_SM90`` or a variant of it), its entry points typed."""
    lib = ctypes.CDLL(str(path))
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.flash_attention_sm90_fwd.argtypes = (
        [c_ptr] * 5 + [strides] + [c_int] * 10 + [c_ptr])
    lib.flash_attention_sm90_fwd.restype = c_int
    lib.flash_attention_sm90_bwd.argtypes = (
        [c_ptr] * 10 + [strides] + [c_int] * 10 + [c_ptr])
    lib.flash_attention_sm90_bwd.restype = c_int
    lib.flash_attention_sm90_error_string.argtypes = [c_int]
    lib.flash_attention_sm90_error_string.restype = ctypes.c_char_p
    return lib


def _sm90_library() -> ctypes.CDLL:
    global _SM90_LIB
    if _SM90_LIB is None:
        _SM90_LIB = load_sm90(build_library(SOURCE_SM90))
    return _SM90_LIB


def _strides(*ts) -> ctypes.Array:
    """The strides the kernel reads, in elements, all but the last dim's
    of each tensor in turn (0 for a dim of size 1), as a C array of 14."""
    vals = [0 if n == 1 else st for t in ts
            for n, st in zip(t.shape[:-1], t.stride()[:-1])]
    vals += [0] * (14 - len(vals))
    return (ctypes.c_longlong * 14)(*vals)


def _launch(lib, fn, args, index: int, what: str) -> None:
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err:
        msg = (lib.flash_attention_sm90_error_string if lib is _SM90_LIB
               else lib.flash_attention_error_string)(err).decode()
        raise RuntimeError(f"flash_attention_{what} failed: {msg}")


def _route(q, d: int, dv: int, chosen: Optional[str]) -> str:
    """The planned route, or ``chosen`` where it takes q's dtype (the
    ``mma`` route takes both; ``sm90`` bf16 only)."""
    planned = route(q.dtype, d, dv)
    if chosen is None:
        return planned
    if chosen not in ROUTES:
        raise ValueError(f"route {chosen!r} is not one of {ROUTES}")
    if chosen == "sm90" and planned != "sm90":
        raise ValueError(f"the sm90 route takes no {q.dtype} inputs")
    return chosen


def _on_card(*ts) -> int:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"no flash-attention kernel for tensors on "
                         f"{[str(t.device) for t in ts]}")
    return ts[0].get_device()


def _mask_args(causal: bool, window: Optional[int], q_pos0: int) -> tuple:
    if not -(1 << 31) <= q_pos0 < 1 << 31:
        raise ValueError(f"q_pos0 {q_pos0} out of range")
    return int(bool(causal)), 0 if window is None else int(window), q_pos0


def flash_attention_fwd_cuda(q, k, v, causal: bool = True,
                             window: Optional[int] = None,
                             q_pos0: int = 0, route: Optional[str] = None):
    """One forward launch on CUDA tensors: ``(O, lse)``, O (B, Sq, KV, G,
    Dv) contiguous in q's dtype, lse (B, KV, G, Sq) fp32.  ``route``:
    the planned one (:func:`route`) when ``None``; ``"mma"`` runs a bf16
    call on the ``mma.sync`` kernel (a yardstick)."""
    _check(q, k, v, window)
    index = _on_card(q, k, v)
    mask = _mask_args(causal, window, q_pos0)
    b, sq, kvh, g, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    rt = _route(q, d, dv, route)
    out = torch.empty((b, sq, kvh, g, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    stream = torch._C._cuda_getCurrentRawStream(index)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _strides(q, k, v), b, sq, sk, kvh, g, d, dv,
            *mask, stream)
    if rt == "sm90":
        lib = _SM90_LIB or _sm90_library()
        _launch(lib, lib.flash_attention_sm90_fwd, ptrs, index, "fwd")
    else:
        lib = _LIB or _library()
        _launch(lib, lib.flash_attention_fwd, (_DTYPES[q.dtype],) + ptrs,
                index, "fwd")
    flash_attention_cuda.launches += 1
    launches_by_pass["fwd"] += 1
    launches_by_route[rt] += 1
    return out, lse


def flash_attention_bwd_cuda(q, k, v, o, lse, do, causal: bool = True,
                             window: Optional[int] = None,
                             q_pos0: int = 0, route: Optional[str] = None):
    """The backward's three launches on CUDA tensors: ``(dq, dk, dv)``,
    contiguous in the inputs' dtype, from :func:`flash_attention_fwd_cuda`'s
    ``o`` and ``lse`` and O's gradient ``do`` (strided like q), on
    ``route`` (the planned one when ``None``)."""
    _check(q, k, v, window)
    index = _on_card(q, k, v, o, lse, do)
    mask = _mask_args(causal, window, q_pos0)
    b, sq, kvh, g, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    rt = _route(q, d, dv, route)
    if tuple(o.shape) != (b, sq, kvh, g, dv) or do.shape != o.shape \
            or o.dtype != q.dtype or do.dtype != q.dtype \
            or not o.is_contiguous() or not _layout_ok(do) \
            or tuple(lse.shape) != (b, kvh, g, sq) \
            or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"o {tuple(o.shape)} {o.dtype}, do "
                         f"{tuple(do.shape)} {do.stride()} {do.dtype}, lse "
                         f"{tuple(lse.shape)} {lse.dtype} do not fit q "
                         f"{tuple(q.shape)}")
    dq = torch.empty((b, sq, kvh, g, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, kvh, d), dtype=q.dtype, device=q.device)
    dvv = torch.empty((b, sk, kvh, dv), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, kvh, g, sq), dtype=torch.float32,
                        device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dvv.data_ptr(), _strides(q, k, v, do), b, sq, sk,
            kvh, g, d, dv, *mask, torch._C._cuda_getCurrentRawStream(index))
    if rt == "sm90":
        lib = _SM90_LIB or _sm90_library()
        _launch(lib, lib.flash_attention_sm90_bwd, ptrs, index, "bwd")
    else:
        lib = _LIB or _library()
        _launch(lib, lib.flash_attention_bwd, (_DTYPES[q.dtype],) + ptrs,
                index, "bwd")
    flash_attention_cuda.launches += 3
    launches_by_pass["bwd"] += 1
    launches_by_route[rt] += 3
    return dq, dk, dvv


class FlashAttention(torch.autograd.Function):
    """The kernel with its backward: one forward launch, saving (q, k, v,
    O, lse); three backward launches."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_pos0):
        out, lse = flash_attention_fwd_cuda(q, k, v, causal, window, q_pos0)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_pos0)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if not _layout_ok(do):          # a broadcast gradient, say
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                              *ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention_cuda(q, k, v, causal: bool = True,
                         window: Optional[int] = None,
                         q_pos0: int = 0) -> torch.Tensor:
    """Attention of ``q`` (B, Sq, KV, G, D) over ``k`` (B, Sk, KV, D) and
    ``v`` (B, Sk, KV, Dv), CUDA tensors in bf16 or fp32, under the causal
    and window mask with query positions from ``q_pos0`` -> (B, Sq, KV, G,
    Dv) in q's dtype, differentiable in q, k and v.  Raises on what the
    kernel does not take (:func:`_check`)."""
    return FlashAttention.apply(q, k, v, causal, window, q_pos0)


# kernel launches since the last reset (a forward one, a backward three;
# CPU calls excluded); calls by pass in launches_by_pass
flash_attention_cuda.launches = 0


def reset_launches() -> None:
    """Set :attr:`flash_attention_cuda.launches`, each pass's count and
    each route's to 0."""
    flash_attention_cuda.launches = 0
    for k in launches_by_pass:
        launches_by_pass[k] = 0
    for k in launches_by_route:
        launches_by_route[k] = 0
