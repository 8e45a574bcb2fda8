"""Plain OLMoE-style decoder (arXiv:2409.02060) as the ``olmoe-1b-7b``
configuration runs it, in float32.

Each layer: ``x += wo(attention(rope(wq h), rope(wk h), wv h))`` with
``h = rmsnorm(x)``, causal softmax attention, RoPE rotating the two
halves of each head; then ``x += sum_k gate_k · E_k(rmsnorm(x))`` over
the top-k experts of the router's softmax, the k gates renormalized to
sum 1, each expert ``wo(silu(wg x) · wi x)``.  The final rmsnorm and
the untied head give the logits.  The configuration file lists where
this departs from the published model.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from . import bounds
from .common import Arith, Spec, ce_sum, dense, f32, remat, rmsnorm

# query rows a block in the attention (bounds the scores' memory)
Q_BLOCK = 1024


def param_specs(m: Dict) -> List[Spec]:
    """The parameters, in the layout the port's parameter tree uses."""
    d, hd = m["d_model"], m["head_dim"]
    h, kv = m["n_heads"], m["n_kv_heads"]
    e, f = m["n_experts"], m["expert_d_ff"]
    out: List[Spec] = [(("embed",), (m["vocab"], d), "normal", 0.02),
                       (("final_norm", "w"), (d,), "ones", 0.0)]
    for i in range(m["n_layers"]):
        b = ("blocks", i)
        out += [
            (b + ("norm0", "w"), (d,), "ones", 0.0),
            dense(b + ("attn0", "wq"), d, h * hd),
            dense(b + ("attn0", "wk"), d, kv * hd),
            dense(b + ("attn0", "wv"), d, kv * hd),
            dense(b + ("attn0", "wo"), h * hd, d),
            (b + ("fnorm0", "w"), (d,), "ones", 0.0),
            dense(b + ("moe0", "router"), d, e),
            (b + ("moe0", "wi"), (e, d, f), "normal", 1.0 / math.sqrt(d)),
            (b + ("moe0", "wg"), (e, d, f), "normal", 1.0 / math.sqrt(d)),
            (b + ("moe0", "wo"), (e, f, d), "normal", 1.0 / math.sqrt(f)),
        ]
    if not m["tie_embeddings"]:
        out.append(dense(("lm_head",), d, m["vocab"]))
    return out


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (b, S, H, D) rotated by position, the first half of each head
    against the second."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    c, sn = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * c - x2 * sn, x1 * sn + x2 * c], dim=-1)


def attention(m: Dict, p: Dict, h: torch.Tensor, ar: Arith) -> torch.Tensor:
    b, s, _ = h.shape
    hd, nh, kv = m["head_dim"], m["n_heads"], m["n_kv_heads"]
    q = rope(ar.mm(h, f32(p["wq"])).view(b, s, nh, hd), m["rope_theta"])
    k = rope(ar.mm(h, f32(p["wk"])).view(b, s, kv, hd), m["rope_theta"])
    v = ar.mm(h, f32(p["wv"])).view(b, s, kv, hd)
    k = k.repeat_interleave(nh // kv, dim=2)
    v = v.repeat_interleave(nh // kv, dim=2)
    outs = []
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(s, q0 + Q_BLOCK)
        sc = ar.einsum("bqhd,bkhd->bhqk", q[:, q0:q1], k[:, :q1]) \
            / math.sqrt(hd)
        qi = torch.arange(q0, q1, device=h.device)[:, None]
        ki = torch.arange(q1, device=h.device)[None, :]
        sc = sc.masked_fill(ki > qi, float("-inf"))
        outs.append(ar.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1),
                              v[:, :q1]))
    return ar.mm(torch.cat(outs, 1).reshape(b, s, nh * hd), f32(p["wo"]))


def experts(m: Dict, p: Dict, h: torch.Tensor, ar: Arith) -> torch.Tensor:
    b, s, d = h.shape
    x = h.reshape(-1, d)
    probs = torch.softmax(ar.mm(x, f32(p["router"])), -1)
    vals, idx = torch.topk(probs, m["experts_per_tok"], dim=-1)
    gates = vals / vals.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(m["n_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        ye = ar.mm(F.silu(ar.mm(xe, f32(p["wg"][e])))
                   * ar.mm(xe, f32(p["wi"][e])), f32(p["wo"][e]))
        out = out.index_add(0, tok, ye * gates[tok, slot, None])
    return out.view(b, s, d)


def hidden(m: Dict, W: Dict, tokens: torch.Tensor, ar: Arith
           ) -> torch.Tensor:
    """The final-normed hidden states (rows, S, d) in float32."""
    x = f32(W["embed"])[tokens.long()]
    eps = m["norm_eps"]
    for bp in W["blocks"]:
        def layer(x, bp=bp):
            x = x + attention(m, bp["attn0"],
                              rmsnorm(x, f32(bp["norm0"]["w"]), eps), ar)
            return x + experts(m, bp["moe0"],
                               rmsnorm(x, f32(bp["fnorm0"]["w"]), eps), ar)
        x = remat(layer, x)
    return rmsnorm(x, f32(W["final_norm"]["w"]), eps)


def head(m: Dict, W: Dict) -> torch.Tensor:
    return f32(W["embed"]).T if m["tie_embeddings"] else f32(W["lm_head"])


def loss_sum(m: Dict, W: Dict, tokens: torch.Tensor, ar: Arith
             ) -> torch.Tensor:
    h = hidden(m, W, tokens, ar)
    return ce_sum(ar.mm(h[:, :-1], head(m, W)), tokens[:, 1:])


def last_logits(m: Dict, W: Dict, tokens: torch.Tensor, ar: Arith
                ) -> torch.Tensor:
    h = hidden(m, W, tokens, ar)
    return ar.mm(h[:, -1], head(m, W))


def fa_case(m: Dict, b: int, s: int, dtype: str = "bfloat16") -> tuple:
    """The shape tuple of :func:`bounds.fa_bound` for one layer."""
    g = m["n_heads"] // m["n_kv_heads"]
    return ("", b, s, s, m["n_kv_heads"], g, m["head_dim"], m["head_dim"],
            True, None, 0, dtype)


def flops(m: Dict, b: int, s: int, train: bool) -> float:
    """The step's model FLOPs at the configuration's widths: the
    projections, the router, the k experts a token, the attention core
    over the causal pairs (:func:`bounds.fa_bound`) and the head over
    the positions the step predicts; three times the products for a
    training step."""
    d, hd = m["d_model"], m["head_dim"]
    per_token = 2 * d * hd * (2 * m["n_heads"] + 2 * m["n_kv_heads"]) \
        + 2 * d * m["n_experts"] \
        + m["experts_per_tok"] * 3 * 2 * d * m["expert_d_ff"]
    rows = b * (s - 1) if train else b
    mat = m["n_layers"] * b * s * per_token + rows * 2 * d * m["vocab"]
    core = bounds.fa_bound(fa_case(m, b, s))["fwd_bwd" if train
                                             else "fwd"][2]
    return (3 * mat if train else mat) + m["n_layers"] * core
