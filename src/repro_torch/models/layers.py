"""Shared neural building blocks on tensors, over explicit parameters.

Counterpart of :mod:`repro.models.layers`.  Every ``*_init`` returns a
plain dict of tensors and every ``*_apply`` reads its parameters by name
(``p["wq"]``), so the same functions run on those dicts and on the
model's :class:`ParamTree` modules.  Attention supports GQA,
causal/sliding-window masks, KV caches (ring-buffered under sliding
windows, optionally INT8), cross-attention, MLA (DeepSeek latent
attention), and a blockwise *flash-style* path (online softmax over KV
blocks) that keeps long-context prefill memory O(S·block).

The decode attention's core (scores, ring mask, softmax, context) runs
in :func:`repro_torch.kernels.decode_attention.gqa_decode_attention`:
the CUDA kernel on CUDA, its plain version on the CPU.  The KV caches
are updated in place (the reference's ``dynamic_update_slice`` on a
donated state).  dtypes follow the reference at every step: norms in
fp32 and back, RoPE tables in fp32 cast to x's dtype, scores in the
compute dtype with the mask and softmax in fp32.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.decode_attention import gqa_decode_attention
from .analysis_flags import FLAGS as _AFLAGS

__all__ = [
    "dense_init", "rmsnorm", "layernorm", "norm_init", "apply_norm",
    "rope_tables", "apply_rope", "attention_init", "attention_apply",
    "attention_decode", "mla_init", "mla_apply", "mla_decode",
    "mlp_init", "mlp_apply", "moe_init", "moe_apply", "flash_attention",
    "gelu", "softplus",
]

Params = Dict[str, Any]

# Use the flash path once the KV length exceeds this.
FLASH_THRESHOLD = 2048
FLASH_BLOCK_Q = 512
FLASH_BLOCK_K = 1024


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normal float32 draws from ``gen`` on its device."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    scale = 1.0 / math.sqrt(d_in)
    return (_normal(gen, (d_in, d_out)) * scale).to(dtype)


# jax.nn's definitions: gelu is the tanh approximation by default,
# softplus is logaddexp(x, 0)
def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_init(cfg: ArchConfig, d: int, dtype, device=None) -> Params:
    if cfg.norm == "layernorm":
        return {"w": torch.ones((d,), dtype=dtype, device=device),
                "b": torch.zeros((d,), dtype=dtype, device=device)}
    return {"w": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(x, w, eps=1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * w.to(torch.float32)
    return y.to(x.dtype)


def layernorm(x, w, b, eps=1e-5):
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps) * w.to(torch.float32) \
        + b.to(torch.float32)
    return y.to(x.dtype)


def apply_norm(cfg: ArchConfig, p: Params, x):
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p["b"])
    return rmsnorm(x, p["w"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given positions; dim = rotary dimension."""
    ar = torch.arange(0, dim, 2, dtype=torch.float32,
                      device=positions.device)
    inv = 1.0 / (theta ** (ar / dim))
    ang = positions.to(torch.float32)[..., None] * inv     # (..., dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D) rotated in half-split pairs; cos/sin: (S, D/2)."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    c = cos[..., None, :].to(x.dtype)           # broadcast over heads
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA / SWA / cross) with flash path
# ---------------------------------------------------------------------------


def attention_init(cfg: ArchConfig, gen: torch.Generator, dtype,
                   cross: bool = False) -> Params:
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype),
    }


MaskFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _gqa_scores_ctx(q, k, v, mask_fn: MaskFn, q_pos0: int):
    """Naive path: q (B,Sq,KV,G,D), k/v (B,Sk,KV,D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k) * scale
    sq, sk = q.shape[1], k.shape[1]
    qi = q_pos0 + torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(sk, device=q.device)[None, :]
    scores = scores.to(torch.float32).masked_fill(~mask_fn(qi, ki), -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def flash_attention(q, k, v, mask_fn: MaskFn, q_pos0: int = 0,
                    block_q: int = FLASH_BLOCK_Q,
                    block_k: int = FLASH_BLOCK_K):
    """Blockwise online-softmax attention (memory O(S·block)).

    q: (B, Sq, KV, G, D); k, v: (B, Sk, KV, D).  ``mask_fn(qi, ki)`` is a
    boolean predicate on absolute positions.  The reference's scan over
    KV blocks inside a scan over Q blocks, as two Python loops with the
    same blocks, padding and fp32 running statistics.
    """
    b, sq, kv, g, d = q.shape
    sk = k.shape[1]
    dv = v.shape[-1]                    # may differ from d (MLA)
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    nq = -(-sq // block_q)
    nk = -(-sk // block_k)
    pad_q = nq * block_q - sq
    pad_k = nk * block_k - sk
    scale = 1.0 / math.sqrt(d)
    dev = q.device

    qp = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad_q))
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_k))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    outs = []
    for qi in range(nq):
        qblk = qp[:, qi * block_q:(qi + 1) * block_q]    # (B,bq,KV,G,D)
        m = torch.full((b, kv, g, block_q), -math.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kv, g, block_q), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((b, kv, g, block_q, dv), dtype=qblk.dtype,
                          device=dev)
        qpos = q_pos0 + qi * block_q \
            + torch.arange(block_q, device=dev)[:, None]
        for ki in range(nk):
            kblk = kp[:, ki * block_k:(ki + 1) * block_k]
            vblk = vp[:, ki * block_k:(ki + 1) * block_k]
            s = torch.einsum("bqkgd,bskd->bkgqs", qblk, kblk) * scale
            kpos = (ki * block_k
                    + torch.arange(block_k, device=dev))[None, :]
            valid = mask_fn(qpos, kpos) & (kpos < sk)
            s = s.to(torch.float32).masked_fill(~valid, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(qblk.dtype), vblk)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))         # (B,bq,KV,G,D)
    return torch.cat(outs, dim=1)[:, :sq]


def _mask_fn(cfg: ArchConfig, causal: bool) -> MaskFn:
    win = cfg.sliding_window

    def fn(qi, ki):
        ok = torch.ones(torch.broadcast_shapes(qi.shape, ki.shape),
                        dtype=torch.bool, device=qi.device)
        if causal:
            ok = ok & (ki <= qi)
        if win is not None:
            ok = ok & (ki > qi - win)
        return ok

    return fn


def attention_apply(cfg: ArchConfig, p: Params, x, *, causal: bool = True,
                    kv_src: Optional[torch.Tensor] = None,
                    positions: Optional[torch.Tensor] = None,
                    use_rope: bool = True) -> torch.Tensor:
    """Full-sequence attention (training / prefill / encoder / cross)."""
    b, s, d = x.shape
    hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    g = h // kvh
    src = x if kv_src is None else kv_src
    sk = src.shape[1]
    q = (x @ p["wq"]).reshape(b, s, kvh, g, hd)
    k = (src @ p["wk"]).reshape(b, sk, kvh, hd)
    v = (src @ p["wv"]).reshape(b, sk, kvh, hd)
    if use_rope:
        qpos = positions if positions is not None \
            else torch.arange(s, device=x.device)
        cos_q, sin_q = rope_tables(qpos, hd, cfg.rope_theta)
        cos_k, sin_k = rope_tables(torch.arange(sk, device=x.device), hd,
                                   cfg.rope_theta)
        q = apply_rope(q.reshape(b, s, kvh * g, hd), cos_q, sin_q) \
            .reshape(b, s, kvh, g, hd)
        k = apply_rope(k, cos_k, sin_k)
    mfn = _mask_fn(cfg, causal and kv_src is None)
    _check_seq_parallel()
    if sk > FLASH_THRESHOLD and not _AFLAGS["naive_attention"]:
        ctx = flash_attention(q, k, v, mfn)
    else:
        ctx = _gqa_scores_ctx(q, k, v, mfn, 0)
    return ctx.reshape(b, s, h * hd) @ p["wo"]


def _check_seq_parallel() -> None:
    """The ``attn_seq_parallel`` knob reshards attention over a mesh's
    model axis; without a mesh, or on a model axis of one member (the
    launchers' local mesh), it changes nothing, as in the reference.  Over
    a wider model axis it waits for the sharding slice."""
    from ..launch import meshctx, tuning
    from ..launch.mesh import axis_size
    ctx = meshctx.current()
    if (tuning.FLAGS["attn_seq_parallel"] and ctx is not None
            and axis_size(ctx.mesh, ctx.model_axis) > 1):
        raise NotImplementedError(
            "sequence-parallel attention over a mesh is not ported yet "
            "(ROADMAP §1, launch/mesh and sharding)")


def _kv_store(x, store_dtype):
    """§Perf int8_kv_cache knob: symmetric INT8 (fixed 1/64 scale
    stand-in; production calibrates per head via repro_torch.quant)."""
    if store_dtype == torch.int8:
        return torch.clamp(torch.round(x.to(torch.float32) * 64.0),
                           -127, 127).to(torch.int8)
    return x.to(store_dtype)


def attention_decode(cfg: ArchConfig, p: Params, x, cache: Params,
                     pos: int) -> Tuple[torch.Tensor, Params]:
    """Single-token decode with a (possibly ring-buffered) KV cache.

    ``cache = {"k": (B, S_cache, KV, D), "v": ...}``, written in place;
    ``pos`` is the absolute position of the incoming token (a host int).
    For sliding-window archs the cache holds only ``window`` slots and is
    written ring-wise — long_500k memory stays O(window).
    """
    b, one, d = x.shape
    hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    g = h // kvh
    s_cache = cache["k"].shape[1]
    q = (x @ p["wq"]).reshape(b, 1, kvh, g, hd)
    k = (x @ p["wk"]).reshape(b, 1, kvh, hd)
    v = (x @ p["wv"]).reshape(b, 1, kvh, hd)
    cos, sin = rope_tables(torch.arange(pos, pos + 1, device=x.device), hd,
                           cfg.rope_theta)
    q = apply_rope(q.reshape(b, 1, h, hd), cos, sin).reshape(
        b, 1, kvh, g, hd)
    k = apply_rope(k, cos, sin)
    slot = pos % s_cache                      # ring index (== pos if full)
    ck, cv = cache["k"], cache["v"]
    ck[:, slot] = _kv_store(k[:, 0], ck.dtype)
    cv[:, slot] = _kv_store(v[:, 0], cv.dtype)
    ctx = gqa_decode_attention(q[:, 0], ck, cv, pos, cfg.sliding_window)
    out = ctx.reshape(b, 1, h * hd) @ p["wo"]
    return out, {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_init(cfg: ArchConfig, gen: torch.Generator, dtype) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": dense_init(gen, d, m.q_lora_rank, dtype),
        "wq_b": dense_init(gen, m.q_lora_rank, h * qk, dtype),
        "wkv_a": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                            dtype),
        "wkv_b": dense_init(gen, m.kv_lora_rank,
                            h * (m.qk_nope_head_dim + m.v_head_dim), dtype),
        "wo": dense_init(gen, h * m.v_head_dim, d, dtype),
        "q_norm": torch.ones((m.q_lora_rank,), dtype=dtype,
                             device=gen.device),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dtype,
                              device=gen.device),
    }


def _mla_qkv(cfg: ArchConfig, p: Params, x, positions):
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    q = rmsnorm(x @ p["wq_a"], p["q_norm"]) @ p["wq_b"]
    q = q.reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    kv = x @ p["wkv_a"]
    c_kv = rmsnorm(kv[..., :m.kv_lora_rank], p["kv_norm"])
    k_rope = kv[..., m.kv_lora_rank:].reshape(b, s, 1, dr)
    cos, sin = rope_tables(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)
    return q_nope, q_rope, c_kv, k_rope


def _mla_expand(cfg: ArchConfig, p: Params, c_kv):
    m = cfg.mla
    b, s, _ = c_kv.shape
    h = cfg.n_heads
    dn, dv = m.qk_nope_head_dim, m.v_head_dim
    kv = (c_kv @ p["wkv_b"]).reshape(b, s, h, dn + dv)
    return kv[..., :dn], kv[..., dn:]


def mla_apply(cfg: ArchConfig, p: Params, x, *,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    pos = positions if positions is not None \
        else torch.arange(s, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, pos)
    k_nope, v = _mla_expand(cfg, p, c_kv)
    # fold into the generic GQA shapes: kv-heads == n_heads here
    q = torch.cat([q_nope, q_rope], -1).reshape(b, s, h, 1, -1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, k_rope.shape[-1])], -1)
    mfn = _mask_fn(cfg, True)
    if s > FLASH_THRESHOLD and not _AFLAGS["naive_attention"]:
        ctx = flash_attention(q, k, v, mfn)
    else:
        ctx = _gqa_scores_ctx(q, k, v, mfn, 0)
    return ctx.reshape(b, s, h * m.v_head_dim) @ p["wo"]


def mla_decode(cfg: ArchConfig, p: Params, x, cache: Params,
               pos: int) -> Tuple[torch.Tensor, Params]:
    """Latent-cache decode in the **absorbed** formulation.

    The up-projections fold into the query/context sides —
    ``q^T (W_uk c) = (W_uk^T q)^T c`` and ``Σ_s p_s (W_uv c_s) =
    W_uv (Σ_s p_s c_s)`` — so attention runs entirely in the latent
    space and nothing of size (B, S, H, d) ever materializes.  The
    latent caches are written in place.
    """
    m = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(
        cfg, p, x, torch.arange(pos, pos + 1, device=x.device))
    cc, cr = cache["c_kv"], cache["k_rope"]
    cc[:, pos] = c_kv[:, 0].to(cc.dtype)
    cr[:, pos] = k_rope[:, 0].to(cr.dtype)
    w_kv = p["wkv_b"].reshape(m.kv_lora_rank, h, dn + dv)
    w_k, w_v = w_kv[..., :dn], w_kv[..., dn:]
    # absorb W_uk into the query; scores in latent space
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0], w_k)
    lat = cc.to(x.dtype)                           # (B, S, r)
    rope = cr.to(x.dtype)[:, :, 0]                 # (B, S, dr)
    scale = 1.0 / math.sqrt(dn + dr)
    scores = (torch.einsum("bhl,bsl->bhs", q_lat, lat)
              + torch.einsum("bhr,bsr->bhs", q_rope[:, 0], rope)) * scale
    valid = torch.arange(lat.shape[1], device=x.device) <= pos
    scores = scores.to(torch.float32).masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, -1).to(x.dtype)
    ctx_lat = torch.einsum("bhs,bsl->bhl", probs, lat)
    ctx = torch.einsum("bhl,lhv->bhv", ctx_lat, w_v)
    out = ctx.reshape(b, 1, h * dv) @ p["wo"]
    return out, {"c_kv": cc, "k_rope": cr}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(cfg: ArchConfig, gen: torch.Generator, dtype,
             d_ff: Optional[int] = None) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {"wi": dense_init(gen, d, f, dtype),
                "wg": dense_init(gen, d, f, dtype),
                "wo": dense_init(gen, f, d, dtype)}
    return {"wi": dense_init(gen, d, f, dtype),
            "wo": dense_init(gen, f, d, dtype)}


def mlp_apply(cfg: ArchConfig, p: Params, x) -> torch.Tensor:
    if cfg.act == "swiglu":
        return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
    return gelu(x @ p["wi"]) @ p["wo"]


# ---------------------------------------------------------------------------
# Mixture of Experts (dense one-hot dispatch, static shapes)
# ---------------------------------------------------------------------------


def moe_init(cfg: ArchConfig, gen: torch.Generator, dtype) -> Params:
    m = cfg.moe
    d = cfg.d_model
    sf = m.shared_d_ff or m.d_ff

    def ex(n, fin, fout):
        return (_normal(gen, (n, fin, fout)) / math.sqrt(fin)).to(dtype)

    p = {
        "router": dense_init(gen, d, m.n_experts, dtype),
        "wi": ex(m.n_experts, d, m.d_ff),
        "wg": ex(m.n_experts, d, m.d_ff),
        "wo": ex(m.n_experts, m.d_ff, d),
    }
    if m.n_shared_experts:
        p["shared"] = mlp_init(cfg, gen, dtype,
                               d_ff=sf * m.n_shared_experts)
    return p


def moe_apply(cfg: ArchConfig, p: Params, x) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Returns (output, aux_load_balance_loss).

    Under an active mesh context this dispatches to the expert-parallel
    path (:mod:`repro_torch.models.moe_ep`: capacity packing and the
    grouped expert GEMM); otherwise it uses the dense one-hot reference
    dispatch (smoke-test scale only — it materializes ``(B, S, E, f)``).
    """
    from ..launch import meshctx
    ctx = meshctx.current()
    if ctx is not None:
        from .moe_ep import moe_ep_apply
        return moe_ep_apply(cfg, p, x, ctx)
    m = cfg.moe
    logits = (x @ p["router"]).to(torch.float32)           # (B,S,E)
    if m.router_score == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    vals, idx = torch.topk(scores, m.experts_per_tok, dim=-1)
    gates = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    # combine weights (B,S,E): scatter the top-k gates
    onehot = F.one_hot(idx, m.n_experts).to(torch.float32)
    comb = torch.sum(onehot * gates[..., None], dim=2).to(x.dtype)
    hg = torch.einsum("bsd,edf->bsef", x, p["wg"])
    hi = torch.einsum("bsd,edf->bsef", x, p["wi"])
    act = F.silu(hg) * hi
    y = torch.einsum("bsef,efd->bsed", act, p["wo"])
    out = torch.einsum("bsed,bse->bsd", y, comb)
    if "shared" in p:
        out = out + mlp_apply(cfg, p["shared"], x)
    # Switch-style load-balance aux loss
    me = torch.mean(F.one_hot(idx[..., 0], m.n_experts).to(torch.float32),
                    dim=(0, 1))
    pe = torch.mean(torch.softmax(logits, -1), dim=(0, 1))
    aux = m.n_experts * torch.sum(me * pe)
    return out, aux
