"""Frozen operation and byte counts, and the H100's published peaks.

Copies of ``ssd_bound``, ``gg_bound`` and ``fa_bound`` from the port's
chip smoke script, kept here so that a change to the program cannot move
the yardstick.  Each counts the work the algorithm needs for its inputs,
whatever kernel computes it: a bound in ms is the larger of the
operations at the peak rate and the bytes at the HBM rate.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# NVIDIA H100 SXM, dense rates without sparsity, at the 700 W limit
PEAK_BF16_OPS = 989e12
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12


def _out(parts, peak: float) -> Dict[str, Tuple[float, str, float]]:
    out = {}
    for name, f, n_bytes in parts:
        t_o, t_b = f / peak, n_bytes / PEAK_BYTES
        out[name] = (1e3 * max(t_o, t_b),
                     "operations" if t_o >= t_b else "bytes", f)
    return out


def ssd_bound(case) -> Dict[str, Tuple[float, str, float]]:
    """``{"fwd" | "fwd_bwd": (bound ms, "operations" | "bytes", FLOPs)}``
    of the SSD chunk scan at ``case = (label, B, S, nh, hp, g, N, Q,
    dtype)``, with T = Q (Q + 1) / 2 the causal pairs of a chunk: FLOPs
    2·B·nc·(g·N·T + nh·hp·T + 2·nh·Q·N·hp) forward (C B^T, W x, the
    chunk states, y_off) and 2·B·nc·(g·N·T + 2·nh·hp·T + 2·nh·N·T +
    4·nh·Q·N·hp) more backward, against the bf16 tensor-core peak (fp32
    inputs: the fp32 peak); bytes x, B, C, dt read and y written forward,
    and dy read, dx, dB, dC, ddt written in the backward."""
    _, b, S, nh, hp, g, n, Q, dt = case
    nc, T = S // Q, Q * (Q + 1) / 2
    elem = 2 if dt == "bfloat16" else 4
    peak = PEAK_BF16_OPS if dt == "bfloat16" else PEAK_F32_OPS
    f_fwd = 2.0 * b * nc * (g * n * T + nh * hp * T + 2 * nh * Q * n * hp)
    f_bwd = 2.0 * b * nc * (g * n * T + 2 * nh * hp * T + 2 * nh * n * T
                            + 4 * nh * Q * n * hp)
    io = elem * (2 * b * S * nh * hp + 2 * b * S * g * n) + 4 * b * S * nh
    return _out((("fwd", f_fwd, io), ("fwd_bwd", f_fwd + f_bwd, 2 * io)),
                peak)


def gg_bound(mode: str, hits: int, m: int, k: int, n: int, groups: int,
             nonempty: int, elem: int, peak_ops: float) -> Tuple[float, str]:
    """``(ms, "operations" | "bytes")`` of one grouped product
    (``mode`` "fwd", "dx" or "dw"): the larger of ``2·hits·K·N``
    operations at ``peak_ops`` and the bytes it must move at the HBM
    rate: the rows of the groups read once, the weights of the non-empty
    groups (fwd, dx) read once, the output written once (dw: every
    group's)."""
    ops = 2.0 * hits * k * n / peak_ops
    if mode == "fwd":
        nbytes = hits * k + nonempty * k * n + m * n
    elif mode == "dx":
        nbytes = hits * n + nonempty * k * n + m * k
    else:
        nbytes = hits * k + hits * n + groups * k * n
    t_bytes = elem * nbytes / PEAK_BYTES
    return 1e3 * max(ops, t_bytes), "operations" if ops >= t_bytes \
        else "bytes"


def fa_pairs(sq: int, sk: int, causal: bool, window, q_pos0: int) -> int:
    """The (query row, key) pairs of one head that the mask lets through."""
    pos = q_pos0 + np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk - 1, pos) if causal else np.full(sq, sk - 1)
    lo = (np.maximum(0, pos - window + 1) if window is not None
          else np.zeros(sq, dtype=np.int64))
    return int(np.maximum(hi - lo + 1, 0).sum())


def fa_bound(case) -> Dict[str, Tuple[float, str, float]]:
    """``{"fwd" | "fwd_bwd": (bound ms, "operations" | "bytes", FLOPs)}``
    of the attention core at ``case = (label, B, Sq, Sk, KV, G, D, Dv,
    causal, window, q_pos0, dtype)``: FLOPs 2·pairs·(D + Dv) forward and
    2·pairs·(3D + 2Dv) more backward over the valid pairs of every query
    head, against the bf16 tensor-core peak (fp32 inputs: the fp32
    peak); bytes q, k, v and O once, and dO, dq, dk and dv in the
    backward."""
    _, b, sq, sk, kvh, g, d, dv, causal, window, q_pos0, dt = case
    pairs = b * kvh * g * fa_pairs(sq, sk, causal, window, q_pos0)
    elem = 2 if dt == "bfloat16" else 4
    peak = PEAK_BF16_OPS if dt == "bfloat16" else PEAK_F32_OPS
    f_fwd = 2.0 * pairs * (d + dv)
    f_bwd = 2.0 * pairs * (3 * d + 2 * dv)
    io = elem * (b * sq * kvh * g * (d + dv) + b * sk * kvh * (d + dv))
    return _out((("fwd", f_fwd, io), ("fwd_bwd", f_fwd + f_bwd, 2 * io)),
                peak)
