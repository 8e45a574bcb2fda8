"""Mamba-2 (SSD — state-space duality) block on tensors.

Counterpart of :mod:`repro.models.ssm`.  Implements the chunked SSD
algorithm (arXiv:2405.21060): the sequence is split into chunks; within
a chunk the quadratic dual form runs as einsums over ``(Q, Q)``
decay-masked scores, and a Python loop carries the ``(d_state,
head_dim)`` recurrent state across chunks (the reference's
``lax.scan``).  Single-token decode is the constant-memory recurrence,
whose state update and readout run in
:func:`repro_torch.kernels.ssd_decode.ssd_decode_step`: the Triton
kernel on CUDA (the state updated in place), its plain version on the
CPU.

Layer I/O matches an attention block (``(B, S, d_model) -> same``), so
hybrid stacks interleave freely.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.ssd_decode import ssd_decode_step
from .layers import _normal, dense_init, rmsnorm, softplus

__all__ = ["ssm_init", "ssm_apply", "ssm_decode", "ssm_state_init"]

Params = Dict[str, Any]


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, n_heads, conv_dim


def ssm_init(cfg: ArchConfig, gen: torch.Generator, dtype) -> Params:
    s, d_in, nh, conv_dim = _dims(cfg)
    d = cfg.d_model
    dev = gen.device
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + nh
    return {
        "in_proj": dense_init(gen, d, proj_out, dtype),
        "conv_w": (_normal(gen, (s.d_conv, conv_dim))
                   / math.sqrt(s.d_conv)).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh,
                                          dtype=torch.float32, device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "norm_w": torch.ones((d_in,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, d_in, d, dtype),
    }


def _split_proj(cfg: ArchConfig, zxbcdt):
    s, d_in, nh, _ = _dims(cfg)
    g = s.n_groups
    return torch.split(zxbcdt, [d_in, d_in, g * s.d_state, g * s.d_state,
                                nh], dim=-1)


def _causal_conv(x, w, b):
    """Depth-wise causal conv1d: x (B,S,C), w (K,C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):                      # tiny static unroll (K=4)
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    # the bias in the activations' dtype: the reference casts it with the
    # stacked block parameters (2-D there), so it is in the compute dtype
    return F.silu(out + b.to(out.dtype))


def _ssm_region(p: Params, u, state, body):
    """``body(p, u, state)`` on one device; over a distributed mesh a
    local region over the whole sublayer: its weights and recurrent
    state gathered over the model axis (the in_proj's column shards do
    not follow the split into z, x, B, C and dt), u replicated over it,
    the output whole on every model rank.  Weights are gathered over the
    data axes too; their gradients leave partial over the data axes the
    batch is sharded on.  A decode state comes back in its own
    placements (the new ``h`` a new DTensor, resharded)."""
    from ..launch import spmd
    if not spmd.is_dtensor(u):
        return body(p, u, state)
    from torch.distributed.tensor import Replicate
    mesh = u.device_mesh
    u_pl = spmd.with_axes(mesh, u.placements)
    w_pl = spmd.with_axes(mesh, u.placements, data=Replicate())
    w_grad = spmd.grad_over_data(mesh, w_pl, u.placements)
    if state is None:
        return spmd.local_region(body, mesh, (p, u, None),
                                 (w_pl, u_pl, None), u_pl,
                                 (w_grad, u_pl, None))
    kept = {k: tuple(v.placements) for k, v in state.items()}
    s_pl = {k: spmd.with_axes(mesh, v.placements)
            for k, v in state.items()}
    out, new = spmd.local_region(body, mesh, (p, u, state),
                                 (w_pl, u_pl, s_pl), (u_pl, s_pl),
                                 (w_grad, u_pl, s_pl))
    return out, {k: v.redistribute(mesh, kept[k]) for k, v in new.items()}


def ssm_apply(cfg: ArchConfig, p: Params, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD (training / prefill); under a distributed mesh a
    local region (:func:`_ssm_region`)."""
    return _ssm_region(p, u, None,
                       lambda pp, uu, _: _ssm_apply_local(cfg, pp, uu))


def _ssm_apply_local(cfg: ArchConfig, p: Params,
                     u: torch.Tensor) -> torch.Tensor:
    s, d_in, nh, conv_dim = _dims(cfg)
    bsz, S, _ = u.shape
    Q = min(s.chunk, S)
    assert S % Q == 0, f"seq {S} not divisible by SSD chunk {Q}"
    nc = S // Q
    g = s.n_groups
    hp = s.head_dim
    f32 = torch.float32

    z, x, B, C, dt_raw = _split_proj(cfg, u @ p["in_proj"])
    xbc = _causal_conv(torch.cat([x, B, C], -1), p["conv_w"], p["conv_b"])
    x, B, C = torch.split(xbc, [d_in, g * s.d_state, g * s.d_state],
                          dim=-1)

    dt = softplus(dt_raw.to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])                              # (nh,)
    x = x.reshape(bsz, nc, Q, nh, hp)
    B = B.reshape(bsz, nc, Q, g, s.d_state)
    C = C.reshape(bsz, nc, Q, g, s.d_state)
    dt = dt.reshape(bsz, nc, Q, nh)
    hpg = nh // g                                           # heads per group
    dA = dt * A                                             # (b,c,Q,nh)
    cum = torch.cumsum(dA, dim=2)                           # (b,c,Q,nh)

    # ---- intra-chunk (dual quadratic form) --------------------------------
    # L[i,j] = exp(cum_i - cum_j) for i >= j; masked before exp
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (b,c,Q,Q,nh)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=u.device))
    L = torch.exp(diff.masked_fill(~mask[None, None, :, :, None],
                                   -math.inf))
    # scores[i,j] = (C_i . B_j) * L[i,j] * dt_j
    CB = torch.einsum("bcqgn,bcsgn->bcqsg", C, B)           # (b,c,Q,Q,g)
    CB = torch.repeat_interleave(CB, hpg, dim=-1)           # (b,c,Q,Q,nh)
    W = CB * L * dt[:, :, None, :, :]
    y_diag = torch.einsum("bcqsh,bcshp->bcqhp", W.to(u.dtype), x)

    # ---- chunk summary states ---------------------------------------------
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)          # (b,c,Q,nh)
    Bh = torch.repeat_interleave(B, hpg, dim=-2).reshape(
        bsz, nc, Q, nh, s.d_state)
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchnp",
                          (decay_end * dt).to(u.dtype), Bh, x)

    # ---- inter-chunk recurrence (emit h_{c-1}) ----------------------------
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (b,c,nh)
    h = torch.zeros((bsz, nh, s.d_state, hp), dtype=u.dtype,
                    device=u.device)
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * chunk_decay[:, c, :, None, None].to(h.dtype) \
            + states[:, c]
    h_prev = torch.stack(prev, dim=1)                       # (b,c,nh,n,p)

    Ch = torch.repeat_interleave(C, hpg, dim=-2).reshape(
        bsz, nc, Q, nh, s.d_state)
    y_off = torch.einsum("bcqhn,bchnp,bcqh->bcqhp", Ch, h_prev,
                         torch.exp(cum).to(u.dtype))

    y = y_diag + y_off + x * p["D"][..., None].to(u.dtype)
    y = y.reshape(bsz, S, d_in)
    y = rmsnorm(y * F.silu(z), p["norm_w"])
    return y @ p["out_proj"]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def ssm_state_init(cfg: ArchConfig, batch: int, dtype,
                   device=None) -> Params:
    s, d_in, nh, conv_dim = _dims(cfg)
    return {
        "h": torch.zeros((batch, nh, s.d_state, s.head_dim), dtype=dtype,
                         device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def ssm_decode(cfg: ArchConfig, p: Params, u: torch.Tensor,
               state: Params) -> Tuple[torch.Tensor, Params]:
    """One-token recurrence: u (B, 1, d).  The state's ``h`` is updated
    in place on every device; the conv window is a new tensor.  Under a
    distributed mesh a local region (:func:`_ssm_region`)."""
    return _ssm_region(p, u, state,
                       lambda pp, uu, st: _ssm_decode_local(cfg, pp, uu, st))


def _ssm_decode_local(cfg: ArchConfig, p: Params, u: torch.Tensor,
                      state: Params) -> Tuple[torch.Tensor, Params]:
    s, d_in, nh, conv_dim = _dims(cfg)
    bsz = u.shape[0]
    g, hp = s.n_groups, s.head_dim

    z, x, B, C, dt_raw = _split_proj(cfg, u @ p["in_proj"])
    xbc = torch.cat([x, B, C], -1)                          # (B,1,conv)
    window = torch.cat([state["conv"], xbc.to(state["conv"].dtype)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window.to(u.dtype),
                            p["conv_w"]) + p["conv_b"]
    xbc1 = F.silu(conv_out)[:, None, :]
    x, B, C = torch.split(xbc1, [d_in, g * s.d_state, g * s.d_state],
                          dim=-1)

    dt = softplus(dt_raw.to(torch.float32) + p["dt_bias"])[:, 0]
    # the kernel takes A_log and D in fp32: at bf16 compute they are the
    # cast's bf16 values, converted exactly
    y, h = ssd_decode_step(state["h"], x.reshape(bsz, nh, hp), dt,
                           p["A_log"].to(torch.float32),
                           B.reshape(bsz, g, s.d_state),
                           C.reshape(bsz, g, s.d_state),
                           p["D"].to(torch.float32))
    y = y.reshape(bsz, 1, d_in).to(u.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_w"])
    out = y @ p["out_proj"]
    new_state = {"h": h, "conv": window[:, 1:].to(state["conv"].dtype)}
    return out, new_state
