"""Mamba-2 (SSD — state-space duality) block on tensors.

Counterpart of :mod:`repro.models.ssm`.  Implements the chunked SSD
algorithm (arXiv:2405.21060): the sequence is split into chunks; within
a chunk the quadratic dual form runs over ``(Q, Q)`` decay-masked
scores, and the ``(d_state, head_dim)`` recurrent state is carried
across chunks (the reference's ``lax.scan``), in
:func:`repro_torch.kernels.ssd_scan.ssd_chunk_scan`: the CUDA kernel
(forward and backward) on CUDA tensors, the reference's einsums and a
Python loop on the CPU and ``meta``.  The causal conv front runs in
:func:`repro_torch.kernels.causal_conv.causal_conv_silu` (reading its
columns of the ``in_proj`` output in place) and the ``D`` skip, gate
and norm in :func:`repro_torch.kernels.gated_norm.gated_norm`: hand
kernels (forward and backward; the gate's in CUDA C++ at bf16) on CUDA
tensors, the reference's arithmetic on the CPU and ``meta``.  Single-token decode is the
constant-memory recurrence: between ``in_proj`` and ``out_proj`` its
whole mixer (the conv window, dt, the state update and readout, the
gate and norm) runs in
:func:`repro_torch.kernels.ssm_decode.ssm_decode_mixer`: one CUDA
kernel launch a layer a token on CUDA tensors (the state updated in
place, the ``in_proj`` row read where it lies), the reference's
arithmetic on the CPU and ``meta``.

Layer I/O matches an attention block (``(B, S, d_model) -> same``), so
hybrid stacks interleave freely.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels.causal_conv import causal_conv_silu
from ..kernels.gated_norm import gated_norm
from ..kernels.ssd_scan import ssd_chunk_scan
from ..kernels.ssm_decode import ssm_decode_mixer
from .layers import _normal, dense_init, softplus

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
    g = s.n_groups
    hp = s.head_dim
    f32 = torch.float32

    zxbcdt = u @ p["in_proj"]
    z, _, _, _, dt_raw = _split_proj(cfg, zxbcdt)
    # the conv reads concat([x, B, C]) where in_proj left it: its columns
    # d_in .. d_in + conv_dim
    xbc = causal_conv_silu(zxbcdt[..., d_in:d_in + conv_dim], p["conv_w"],
                           p["conv_b"])
    x, B, C = torch.split(xbc, [d_in, g * s.d_state, g * s.d_state],
                          dim=-1)

    dt = softplus(dt_raw.to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])                              # (nh,)
    # y_diag + y_off: the kernel on CUDA tensors, the reference's
    # arithmetic on the CPU and meta.  A in fp32: at bf16 compute the cast
    # A_log's values, converted exactly (dt * A promotes to fp32 alike)
    y = ssd_chunk_scan(x.reshape(bsz, S, nh, hp), dt, A.to(f32),
                       B.reshape(bsz, S, g, s.d_state),
                       C.reshape(bsz, S, g, s.d_state), s.chunk)
    # rmsnorm((y + x D) silu(z), norm_w): the kernel on CUDA tensors
    y = gated_norm(y.reshape(bsz, S, d_in), z, p["norm_w"], nh, x, p["D"])
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
    # the mixer reads the in_proj row where it lies and writes the gated,
    # normed row out_proj reads; the new state over the old
    y, window = ssm_decode_mixer(u @ p["in_proj"], state["conv"],
                                 state["h"], p["conv_w"], p["conv_b"],
                                 p["dt_bias"], p["A_log"], p["D"],
                                 p["norm_w"], cfg.ssm.n_groups)
    out = y @ p["out_proj"]
    return out, {"h": state["h"], "conv": window}
