"""Plain Mamba-2 (arXiv:2405.21060): the tied-embedding stack of SSD
mixers that the ``mamba2-780m`` configuration runs, in float32.

Each layer: ``x += out_proj(rmsnorm((y + x_c·D)·silu(z), norm_w))``
after ``rmsnorm(x)``, where ``in_proj`` gives ``z``, the conv front's
input ``[x_c, B, C]`` and ``dt``; a depth-wise causal conv of width
``d_conv`` with its bias and SiLU; ``dt = softplus(dt + dt_bias)``,
``A = -exp(A_log)``; and the SSD recurrence ``h_t = exp(dt_t A) h_{t-1}
+ dt_t B_t x_t``, ``y_t = C_t h_t``, computed chunk by chunk (the
quadratic form inside a chunk, the state carried across).  The final
rmsnorm and the tied head give the logits.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from . import bounds
from .common import Arith, Spec, ce_sum, dense, f32, remat, rmsnorm


def dims(m: Dict) -> Dict[str, int]:
    d_in = m["expand"] * m["d_model"]
    nh = d_in // m["head_dim"]
    gn = m["n_groups"] * m["d_state"]
    return {"d_in": d_in, "nh": nh, "gn": gn, "conv_dim": d_in + 2 * gn}


def param_specs(m: Dict) -> List[Spec]:
    """The parameters, in the layout the port's parameter tree uses."""
    d, k = m["d_model"], dims(m)
    out: List[Spec] = [(("embed",), (m["vocab"], d), "normal", 0.02),
                       (("final_norm", "w"), (d,), "ones", 0.0)]
    for i in range(m["n_layers"]):
        b = ("blocks", i)
        s = b + ("ssm0",)
        out += [
            (b + ("norm0", "w"), (d,), "ones", 0.0),
            dense(s + ("in_proj",), d, 2 * k["d_in"] + 2 * k["gn"] + k["nh"]),
            (s + ("conv_w",), (m["d_conv"], k["conv_dim"]), "normal",
             1.0 / math.sqrt(m["d_conv"])),
            (s + ("conv_b",), (k["conv_dim"],), "zeros", 0.0),
            (s + ("A_log",), (k["nh"],), "a_log", 0.0),
            (s + ("D",), (k["nh"],), "ones", 0.0),
            (s + ("dt_bias",), (k["nh"],), "dt_bias", 0.0),
            (s + ("norm_w",), (k["d_in"],), "ones", 0.0),
            (s + ("out_proj",), (k["d_in"], d), "normal",
             1.0 / math.sqrt(k["d_in"] * m["n_layers"])),
        ]
    if not m["tie_embeddings"]:
        out.append(dense(("lm_head",), d, m["vocab"]))
    return out


def ssd(x, dt, A, B, C, Q: int, ar: Arith) -> torch.Tensor:
    """y of the SSD recurrence: x (b, S, nh, hp), dt (b, S, nh), A (nh,),
    B and C (b, S, g, N); chunks of ``Q``."""
    b, S, nh, hp = x.shape
    g, n = B.shape[2], B.shape[3]
    nc, rep = S // Q, nh // g
    x = x.reshape(b, nc, Q, nh, hp)
    Bh = B.reshape(b, nc, Q, g, n).repeat_interleave(rep, dim=3)
    Ch = C.reshape(b, nc, Q, g, n).repeat_interleave(rep, dim=3)
    dt = dt.reshape(b, nc, Q, nh)
    cum = torch.cumsum(dt * A, dim=2)                        # (b,c,Q,nh)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (b,c,Q,Q,nh)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp(diff.masked_fill(~causal[None, None, :, :, None],
                                   float("-inf")))
    scores = ar.einsum("bcqhn,bcshn->bcqsh", Ch, Bh) * L \
        * dt[:, :, None, :, :]
    y = ar.einsum("bcqsh,bcshp->bcqhp", scores, x)
    # each chunk's state, carried across the chunks
    w_end = torch.exp(cum[:, :, -1:, :] - cum) * dt          # (b,c,Q,nh)
    states = ar.einsum("bcqhn,bcqhp->bchnp", Bh * w_end[..., None], x)
    decay = torch.exp(cum[:, :, -1, :])                      # (b,c,nh)
    h = torch.zeros_like(states[:, 0])
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(prev, dim=1)                        # (b,c,nh,N,hp)
    y = y + ar.einsum("bcqhn,bchnp->bcqhp",
                      Ch * torch.exp(cum)[..., None], h_prev)
    return y.reshape(b, S, nh, hp)


def mixer(m: Dict, p: Dict, u: torch.Tensor, ar: Arith) -> torch.Tensor:
    k = dims(m)
    d_in, gn, nh = k["d_in"], k["gn"], k["nh"]
    b, S, _ = u.shape
    hp, K = m["head_dim"], m["d_conv"]
    zxbcdt = ar.mm(u, f32(p["in_proj"]))
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + k["conv_dim"]]
    dt = zxbcdt[..., d_in + k["conv_dim"]:]
    w = f32(p["conv_w"])
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    acc = f32(p["conv_b"]) + sum(xp[:, i:i + S] * w[i] for i in range(K))
    xbc = F.silu(acc)
    x, B, C = xbc[..., :d_in], xbc[..., d_in:d_in + gn], xbc[..., d_in + gn:]
    dt = F.softplus(dt + f32(p["dt_bias"]))
    A = -torch.exp(f32(p["A_log"]))
    g, n = m["n_groups"], m["d_state"]
    y = ssd(x.reshape(b, S, nh, hp), dt, A, B.reshape(b, S, g, n),
            C.reshape(b, S, g, n), min(m["chunk"], S), ar)
    y = y.reshape(b, S, d_in) + x * f32(p["D"]).repeat_interleave(hp)
    y = rmsnorm(y * F.silu(z), f32(p["norm_w"]), m["norm_eps"])
    return ar.mm(y, f32(p["out_proj"]))


def hidden(m: Dict, W: Dict, tokens: torch.Tensor, ar: Arith
           ) -> torch.Tensor:
    """The final-normed hidden states (rows, S, d) in float32."""
    x = f32(W["embed"])[tokens.long()]
    eps = m["norm_eps"]
    for bp in W["blocks"]:
        def layer(x, bp=bp):
            return x + mixer(m, bp["ssm0"], rmsnorm(x, f32(bp["norm0"]["w"]),
                                                     eps), ar)
        x = remat(layer, x)
    return rmsnorm(x, f32(W["final_norm"]["w"]), eps)


def head(m: Dict, W: Dict) -> torch.Tensor:
    return f32(W["embed"]).T if m["tie_embeddings"] else f32(W["lm_head"])


def loss_sum(m: Dict, W: Dict, tokens: torch.Tensor, ar: Arith
             ) -> torch.Tensor:
    """The summed next-token cross-entropy of ``tokens`` (rows, S)."""
    h = hidden(m, W, tokens, ar)
    return ce_sum(ar.mm(h[:, :-1], head(m, W)), tokens[:, 1:])


def last_logits(m: Dict, W: Dict, tokens: torch.Tensor, ar: Arith
                ) -> torch.Tensor:
    """The logits (rows, V) at each row's last position."""
    h = hidden(m, W, tokens, ar)
    return ar.mm(h[:, -1], head(m, W))


def ssd_case(m: Dict, b: int, s: int, dtype: str = "bfloat16") -> tuple:
    """The shape tuple of :func:`bounds.ssd_bound` for one layer."""
    k = dims(m)
    return ("", b, s, k["nh"], m["head_dim"], m["n_groups"], m["d_state"],
            min(m["chunk"], s), dtype)


def flops(m: Dict, b: int, s: int, train: bool) -> float:
    """The step's model FLOPs at the configuration's widths: the matrix
    products (three times for a training step) and the SSD terms of
    :func:`bounds.ssd_bound`; the head over the positions the step
    predicts (every position but the last in training, the last in
    prefill)."""
    k, d = dims(m), m["d_model"]
    per_token = 2 * d * (2 * k["d_in"] + 2 * k["gn"] + k["nh"]) \
        + 2 * k["d_in"] * d
    rows = b * (s - 1) if train else b
    mat = m["n_layers"] * b * s * per_token + rows * 2 * d * m["vocab"]
    scan = bounds.ssd_bound(ssd_case(m, b, s))["fwd_bwd" if train
                                               else "fwd"][2]
    return (3 * mat if train else mat) + m["n_layers"] * scan
