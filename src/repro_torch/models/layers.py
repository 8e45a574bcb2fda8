"""Shared neural building blocks on tensors, over explicit parameters.

Counterpart of :mod:`repro.models.layers`.  Every ``*_init`` returns a
plain dict of tensors and every ``*_apply`` reads its parameters by name
(``p["wq"]``), so the same functions run on those dicts and on the
model's :class:`ParamTree` modules.  Attention supports GQA,
causal/sliding-window masks, KV caches (ring-buffered under sliding
windows, optionally INT8), cross-attention, MLA (DeepSeek latent
attention), and a blockwise *flash-style* path (online softmax over KV
blocks) that keeps long-context prefill memory O(S·block).

The full-sequence attention core (training, prefill, encoder, cross,
MLA) runs in :func:`repro_torch.kernels.flash_attention.
flash_attention_cuda` on CUDA tensors, at every key length; on the CPU
and ``meta`` tensors it keeps the reference's switch between its two
plain versions.  The decode attention's core (scores, ring mask,
softmax, context) runs in
:func:`repro_torch.kernels.decode_attention.gqa_decode_attention`:
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
from ..kernels.flash_attention import flash_attention_cuda
from ..kernels.ssm_decode import softplus
from ..launch.mesh import axis_size
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
# softplus is logaddexp(x, 0) (kernels.ssm_decode's, which the decode
# mixer's plain version runs)
def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


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
    """Full-sequence attention (training / prefill / encoder / cross).
    Under a distributed mesh (DTensor inputs) the projections are DTensor
    products and the rest runs as a local region
    (:func:`_attention_core`)."""
    src = x if kv_src is None else kv_src
    return _attention_core(cfg, x @ p["wq"], src @ p["wk"], src @ p["wv"],
                           p["wo"], causal=causal and kv_src is None,
                           positions=positions, use_rope=use_rope)


def _attention_local(cfg: ArchConfig, q2, k2, v2, causal: bool,
                     positions: Optional[torch.Tensor], use_rope: bool,
                     q_pos0: int = 0) -> torch.Tensor:
    """RoPE, the mask and the attention core on plain tensors: ``q2``
    (B, S, H·hd), ``k2``/``v2`` (B, Sk, KV·hd) -> context (B, S, H·hd).
    The head counts are read from the widths (a model rank's share under
    tensor parallelism); ``q_pos0`` is the absolute position of ``q2``'s
    first row (a sequence-parallel rank's slice).  The core
    (:func:`_attention_core_ctx`) is the flash-attention kernel on CUDA
    tensors at every key length, and on the CPU and ``meta`` tensors the
    reference's switch: naive scores up to ``FLASH_THRESHOLD`` keys, the
    blockwise loop above."""
    b, s, _ = q2.shape
    sk = k2.shape[1]
    hd = cfg.hd
    h, kvh = q2.shape[-1] // hd, k2.shape[-1] // hd
    g = h // kvh
    q = q2.reshape(b, s, kvh, g, hd)
    k = k2.reshape(b, sk, kvh, hd)
    v = v2.reshape(b, sk, kvh, hd)
    if use_rope:
        qpos = positions[q_pos0:q_pos0 + s] if positions is not None \
            else q_pos0 + torch.arange(s, device=q2.device)
        cos_q, sin_q = rope_tables(qpos, hd, cfg.rope_theta)
        cos_k, sin_k = rope_tables(torch.arange(sk, device=q2.device), hd,
                                   cfg.rope_theta)
        q = apply_rope(q.reshape(b, s, kvh * g, hd), cos_q, sin_q) \
            .reshape(b, s, kvh, g, hd)
        k = apply_rope(k, cos_k, sin_k)
    ctx = _attention_core_ctx(cfg, q, k, v, causal, q_pos0)
    return ctx.reshape(b, s, h * hd)


def _attention_core_ctx(cfg: ArchConfig, q, k, v, causal: bool,
                        q_pos0: int = 0):
    """The attention core: q (B, Sq, KV, G, D), k (B, Sk, KV, D), v
    (B, Sk, KV, Dv) -> (B, Sq, KV, G, Dv) under ``cfg``'s mask.  CUDA
    tensors (``naive_attention`` off): the kernel, which raises on what
    it does not take.  Otherwise the reference's switch on ``Sk``."""
    naive = _AFLAGS["naive_attention"]
    if q.is_cuda and not naive:
        return flash_attention_cuda(q, k, v, causal, cfg.sliding_window,
                                    q_pos0)
    mfn = _mask_fn(cfg, causal)
    if k.shape[1] > FLASH_THRESHOLD and not naive:
        return flash_attention(q, k, v, mfn, q_pos0)
    return _gqa_scores_ctx(q, k, v, mfn, q_pos0)


def _attention_core(cfg: ArchConfig, q2, k2, v2, wo, *, causal: bool,
                    positions: Optional[torch.Tensor],
                    use_rope: bool) -> torch.Tensor:
    """:func:`_attention_local` and the output product ``@ wo`` on one
    device; over a distributed mesh a local region
    (:mod:`repro_torch.launch.spmd`) with these placements over the
    model axis (the data axes keep the batch's):

    * the ``attn_seq_parallel`` knob, the sequence divisible by the
      model axis (:func:`_seq_parallel_placements`): q ``Shard`` on its
      sequence dim, k and v replicated; the context leaves sequence-
      sharded and goes back to the flattened head dim (the sharding of
      ``wo``'s rows) for the row-parallel output product;
    * whole heads on each rank (``H`` and ``KV`` divisible): q, k, v
      ``Shard`` on the flattened head dim, ``wo`` row-sharded, the
      output ``Partial`` (Megatron's row-parallel product);
    * otherwise (the ``head_dim`` and ``replicated`` fallbacks): q, k, v
      and ``wo`` gathered, attention computed whole on every model rank
      (the reference psums head-dim partial scores instead).
    """
    from ..launch import spmd
    if not spmd.is_dtensor(q2):
        return _attention_local(cfg, q2, k2, v2, causal, positions,
                                use_rope) @ wo
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q2.device_mesh
    tp = axis_size(mesh, "model")
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    sp = _seq_parallel_placements(mesh, q2)
    if sp is not None:
        q_pl, kv_pl, out_pl, wo_pl = sp
        q_pos0 = mesh.get_local_rank("model") * (q2.shape[1] // tp)
        # k and v serve every rank's rows: their gradients leave partial
        kv_grad = spmd.with_axes(mesh, q2.placements, Partial())
        ctx = spmd.local_region(
            lambda q, k, v: _attention_local(cfg, q, k, v, causal,
                                             positions, use_rope, q_pos0),
            mesh, (q2, k2, v2), (q_pl, kv_pl, kv_pl), out_pl,
            (q_pl, kv_grad, kv_grad))
        return ctx.redistribute(mesh, wo_pl) @ wo
    heads = h % tp == 0 and kvh % tp == 0
    pl = spmd.with_axes(mesh, q2.placements, Shard(2) if heads
                        else None)
    wo_pl = spmd.with_axes(mesh, q2.placements, Shard(0) if heads
                           else None, data=Replicate())
    out_pl = spmd.with_axes(mesh, q2.placements, Partial() if heads
                            else None)
    return spmd.local_region(
        lambda q, k, v, w: _attention_local(cfg, q, k, v, causal, positions,
                                            use_rope) @ w,
        mesh, (q2, k2, v2, wo), (pl, pl, pl, wo_pl), out_pl,
        (pl, pl, pl, spmd.grad_over_data(mesh, wo_pl, q2.placements)))


def _seq_parallel_placements(mesh, q2):
    """The ``attn_seq_parallel`` knob's reshard (the reference's
    ``_maybe_seq_parallel``): ``(q, k/v, context, context for wo)``
    placements when the knob is on, the model axis wider than 1 and the
    sequence divisible by it; else ``None`` (nothing changes: an
    indivisible sequence is left as it is)."""
    from torch.distributed.tensor import Shard
    from ..launch import spmd, tuning
    tp = axis_size(mesh, "model")
    if (not tuning.FLAGS["attn_seq_parallel"] or tp == 1
            or q2.shape[1] % tp):
        return None
    q_pl = spmd.with_axes(mesh, q2.placements, Shard(1))
    kv_pl = spmd.with_axes(mesh, q2.placements)
    wo_pl = spmd.with_axes(mesh, q2.placements, Shard(2)
                           if q2.shape[2] % tp == 0 else None)
    return q_pl, kv_pl, q_pl, wo_pl


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
    written ring-wise — long_500k memory stays O(window).  Under a
    distributed mesh the projections are DTensor products and the rest
    runs as a local region (:func:`_decode_core`).
    """
    ctx, ck, cv = _decode_core(cfg, x @ p["wq"], x @ p["wk"], x @ p["wv"],
                               cache["k"], cache["v"], pos)
    return ctx @ p["wo"], {"k": ck, "v": cv}


def _decode_local(cfg: ArchConfig, q2, k2, v2, ck, cv, pos: int,
                  hd_shard=None):
    """RoPE, the cache store and the decode attention kernel on plain
    tensors: ``q2`` (B, 1, H·hd), ``k2``/``v2`` (B, 1, KV·hd), caches
    (B, S_cache, KV, hd) -> ``(context (B, 1, H·hd), ck, cv)``.
    ``hd_shard = (rank, group)``: the caches hold this model rank's slice
    of the head dim (the ``head_dim`` layout): the new slot's slice is
    stored, and the kernel reads the caches gathered over ``group``."""
    b = q2.shape[0]
    hd = cfg.hd
    h, kvh = q2.shape[-1] // hd, k2.shape[-1] // hd
    g = h // kvh
    s_cache = ck.shape[1]
    q = q2.reshape(b, 1, kvh, g, hd)
    k = k2.reshape(b, 1, kvh, hd)
    v = v2.reshape(b, 1, kvh, hd)
    cos, sin = rope_tables(torch.arange(pos, pos + 1, device=q2.device), hd,
                           cfg.rope_theta)
    q = apply_rope(q.reshape(b, 1, h, hd), cos, sin).reshape(
        b, 1, kvh, g, hd)
    k = apply_rope(k, cos, sin)
    slot = pos % s_cache                      # ring index (== pos if full)
    if hd_shard is None:
        ck[:, slot] = _kv_store(k[:, 0], ck.dtype)
        cv[:, slot] = _kv_store(v[:, 0], cv.dtype)
        k_all, v_all = ck, cv
    else:
        import torch.distributed._functional_collectives as funcol
        rank, group = hd_shard
        w = ck.shape[-1]
        part = slice(rank * w, (rank + 1) * w)
        ck[:, slot] = _kv_store(k[:, 0, :, part], ck.dtype)
        cv[:, slot] = _kv_store(v[:, 0, :, part], cv.dtype)
        gather = getattr(funcol, "all_gather_single", None) \
            or funcol.all_gather_tensor
        k_all = funcol.wait_tensor(gather(ck.contiguous(), 3, group))
        v_all = funcol.wait_tensor(gather(cv.contiguous(), 3, group))
    ctx = gqa_decode_attention(q[:, 0], k_all, v_all, pos,
                               cfg.sliding_window)
    return ctx.reshape(b, 1, h * hd), ck, cv


def _decode_core(cfg: ArchConfig, q2, k2, v2, ck, cv, pos: int):
    """:func:`_decode_local` on one device; over a distributed mesh a
    local region whose model-axis placements follow the caches' (the
    :func:`~repro_torch.launch.sharding.decode_state_specs` layout):
    whole heads (``Shard`` on the caches' head dim): q, k, v and the
    context ``Shard`` on the flattened head dim; the head dim (``Shard``
    on its last dim): q, k and v gathered, each rank stores its slice
    and the kernel reads the caches gathered over the model axis;
    replicated: everything gathered.  The caches are written in place
    in their own shards either way."""
    from ..launch import spmd
    if not spmd.is_dtensor(q2):
        return _decode_local(cfg, q2, k2, v2, ck, cv, pos)
    from torch.distributed.tensor import Shard
    mesh = q2.device_mesh
    axis = mesh.mesh_dim_names.index("model")
    c_model = ck.placements[axis]
    cache_pl = tuple(ck.placements)
    if c_model == Shard(2):
        pl = spmd.with_axes(mesh, q2.placements, Shard(2))
        hd_shard = None
    else:
        pl = spmd.with_axes(mesh, q2.placements)
        hd_shard = ((mesh.get_local_rank("model"), mesh.get_group("model"))
                    if c_model == Shard(3) else None)
    return spmd.local_region(
        lambda q, k, v, kc, vc: _decode_local(cfg, q, k, v, kc, vc, pos,
                                              hd_shard),
        mesh, (q2, k2, v2, ck, cv), (pl, pl, pl, cache_pl, cache_pl),
        (pl, cache_pl, cache_pl))


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
    """Full-sequence MLA; under a distributed mesh a local region
    (:func:`_mla_region`)."""
    return _mla_region(cfg, p, x, None,
                       lambda c, pp, xx, _: _mla_apply_local(
                           c, pp, xx, positions=positions))


def _mla_apply_local(cfg: ArchConfig, p: Params, x, *,
                     positions: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Full-sequence MLA on plain tensors, its heads folded into the
    GQA shapes (KV = H, G = 1; D = nope + rope, Dv = v_head_dim, v a
    strided slice of ``wkv_b``'s output): the core
    (:func:`_attention_core_ctx`) is the flash-attention kernel on CUDA
    tensors at every length, and the reference's switch on the CPU and
    ``meta`` tensors."""
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
    ctx = _attention_core_ctx(cfg, q, k, v, True)
    return ctx.reshape(b, s, h * m.v_head_dim) @ p["wo"]


def mla_decode(cfg: ArchConfig, p: Params, x, cache: Params,
               pos: int) -> Tuple[torch.Tensor, Params]:
    """:func:`_mla_decode_local`; under a distributed mesh a local region
    (:func:`_mla_region`)."""
    return _mla_region(cfg, p, x, cache,
                       lambda c, pp, xx, cc: _mla_decode_local(
                           c, pp, xx, cc, pos))


def _mla_region(cfg: ArchConfig, p: Params, x, cache, body):
    """``body(cfg, p, x, cache)`` on one device; over a distributed mesh
    a local region over the whole sublayer, Megatron-style: when the
    model axis divides the heads, ``wq_b`` and ``wkv_b`` enter column-
    sharded (this rank's heads), ``wo`` row-sharded, the body runs with
    this rank's head count and its output leaves ``Partial`` over the
    model axis (summed by the residual add); otherwise every weight is
    gathered and the output is whole on each rank.  x and the latent
    caches are replicated over the model axis (every rank stores the
    same latents in place); weights are gathered over the data axes
    (under ``fsdp_params``), their gradients leave partial over the data
    axes the batch is sharded on."""
    from ..launch import spmd
    if not spmd.is_dtensor(x):
        return body(cfg, p, x, cache)
    import dataclasses
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    tp = axis_size(mesh, "model")
    heads = cfg.n_heads % tp == 0
    x_pl = spmd.with_axes(mesh, x.placements)

    def w(model):
        return spmd.with_axes(mesh, x.placements, model, data=Replicate())

    w_pl = {k: w(None) for k in p.keys()}
    if heads:
        w_pl.update(wq_b=w(Shard(1)), wkv_b=w(Shard(1)), wo=w(Shard(0)))
        local = dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                                    head_dim=cfg.hd)
    else:
        local = cfg
    w_grad = {k: spmd.grad_over_data(mesh, v, x.placements)
              for k, v in w_pl.items()}
    if heads:
        # the replicated weights serve this rank's heads only: their
        # gradients are partial sums over the model axis too
        for k in p.keys():
            if k not in ("wq_b", "wkv_b", "wo"):
                w_grad[k] = spmd.with_axes(mesh, w_grad[k], Partial())
    # the output and x's gradient: partial sums over the heads' ranks
    part = spmd.with_axes(mesh, x.placements, Partial() if heads else None)
    if cache is None:
        return spmd.local_region(
            lambda pp, xx: body(local, pp, xx, None), mesh, (p, x),
            (w_pl, x_pl), part, (w_grad, part))
    c_pl = {k: tuple(v.placements) for k, v in cache.items()}
    return spmd.local_region(
        lambda pp, xx, cc: body(local, pp, xx, cc), mesh, (p, x, cache),
        (w_pl, x_pl, c_pl), (part, c_pl), (w_grad, part, c_pl))


def _mla_decode_local(cfg: ArchConfig, p: Params, x, cache: Params,
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
    """The dense MLP; under a distributed mesh a local region
    (:func:`_mlp_region`)."""
    from ..launch import spmd
    if spmd.is_dtensor(x):
        return _mlp_region(cfg, p, x)
    return _mlp_local(cfg, p, x)


def _mlp_local(cfg: ArchConfig, p: Params, x) -> torch.Tensor:
    if cfg.act == "swiglu":
        return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
    return gelu(x @ p["wi"]) @ p["wo"]


def _mlp_region(cfg: ArchConfig, p: Params, x):
    """Megatron's MLP as a local region: x replicated over the model
    axis, ``wi``/``wg`` column-sharded and ``wo`` row-sharded when the
    model axis divides ``d_ff`` (the output leaves ``Partial`` over it,
    x's gradient too), else every weight gathered (the output whole on
    each rank).  Weights are gathered over the data axes; their
    gradients leave partial over the data axes the batch is sharded
    on."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from ..launch import spmd
    mesh = x.device_mesh
    split = p["wi"].shape[1] % axis_size(mesh, "model") == 0

    def w(model):
        return spmd.with_axes(mesh, x.placements, model, data=Replicate())

    w_pl = {k: w((Shard(0) if k == "wo" else Shard(1)) if split
                 else None) for k in p.keys()}
    w_grad = {k: spmd.grad_over_data(mesh, v, x.placements)
              for k, v in w_pl.items()}
    x_pl = spmd.with_axes(mesh, x.placements)
    part = spmd.with_axes(mesh, x.placements,
                          Partial() if split else None)
    return spmd.local_region(lambda pp, xx: _mlp_local(cfg, pp, xx), mesh,
                             (p, x), (w_pl, x_pl), part, (w_grad, part))


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
    from ..launch import meshctx, spmd
    if spmd.is_dtensor(x):
        return _moe_region(cfg, p, x)
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


def _moe_region(cfg: ArchConfig, p: Params, x):
    """``moe_apply`` over a distributed mesh: the reference's
    ``shard_map`` (in_specs ``P(dp, None, None)`` for x, the experts
    ``P(model, None, None)``, router and shared expert ``P()``) as a
    local region around :func:`~repro_torch.models.moe_ep.
    moe_ep_apply_local`, which launches the grouped GEMM on this rank's
    expert slice and all-reduces the output over the model group itself.
    So the output and x's gradient leave replicated over the model axis,
    the aux loss replicated everywhere (averaged over the data groups
    the batch is sharded on); the weights' gradients leave partial over
    those data axes."""
    from torch.distributed.tensor import Replicate, Shard
    from ..launch import spmd
    from .moe_ep import moe_ep_apply_local
    mesh = x.device_mesh
    tp = axis_size(mesh, "model")
    if p["wi"].shape[0] % tp:
        raise ValueError(f"{p['wi'].shape[0]} experts do not split over "
                         f"{tp} model ranks")
    x_pl = spmd.with_axes(mesh, x.placements)
    rep = spmd.with_axes(mesh, x.placements, data=Replicate())
    ex = spmd.with_axes(mesh, x.placements, Shard(0), data=Replicate())
    w_pl = {k: (ex if k in ("wi", "wg", "wo") else
                spmd.with_axes(mesh, x.placements, data=Replicate()))
            for k in p.keys()}
    w_grad = {k: spmd.grad_over_data(mesh, v, x.placements)
              for k, v in w_pl.items()}
    names = mesh.mesh_dim_names
    group = mesh.get_group("model") if tp > 1 else None
    data_groups = [mesh.get_group(a) for i, a in enumerate(names)
                   if a != "model" and x.placements[i].is_shard()]
    return spmd.local_region(
        lambda pp, xx: moe_ep_apply_local(cfg, pp, xx, group=group,
                                          data_groups=data_groups),
        mesh, (p, x), (w_pl, x_pl), (x_pl, rep), (w_grad, x_pl))
