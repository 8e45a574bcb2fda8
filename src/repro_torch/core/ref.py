"""Reference INT8 oracle for compiled CIMFlow programs, on tensors.

Counterpart of :mod:`repro.core.ref`, bit-exact with it, with the batch
written out: every static-weight group runs **one** MVM over the
``(B·ho·wo, K)`` patches of the whole batch; a dynamic-weight group
builds a different weight matrix per sample and runs one MVM per
sample.  The semantics are the reference's:

* HWC activations, ``(ky, kx, c)`` im2col patch ordering
  (``(g, ky, kx)`` block-diagonal for depth-wise);
* INT32 accumulation, int32 bias, relu pre-quant (unless a residual
  add/scale follows — then int8 post-add);
* fixed-point requant ``clip((acc*scale + den/2) // den)`` with
  ``den = div << shift`` (``div`` folds the GAP mean), in int64;
* max-pool on int8 with zero-init windows that skip padded positions,
  i.e. ``max(0, max over the valid positions)``;
* saturating int8 residual adds / SE channel scaling;
* dynamic-weight matmuls through
  :func:`repro_torch.core.vecsem.dynamic_weight_matrix`;
* fused ``softmax`` / ``layernorm`` / ``gelu`` through
  :mod:`repro_torch.core.vecsem`.

The MVM is swappable (``matmul``): the ``func:torch`` backend runs it on
the bit-serial CUDA kernel; the default is the exact plain contraction.
``QuantParams`` and the group-routing helpers come from
:mod:`repro_torch.core.codegen`, as the reference's come from its codegen.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.ref import mvm_ref
from . import vecsem
from .codegen import QuantParams, _main_and_skip_preds, _weight_pred
from .graph import CondensedGraph

__all__ = ["QuantParams", "conv_weight_matrix", "dwconv_weight_matrix",
           "im2col", "quantize", "run_reference", "auto_quant",
           "random_init"]

# the INT8 x INT8 -> INT32 contraction ``(M, K) int8, (K, N) int8 ->
# (M, N) int32``
MatmulFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def conv_weight_matrix(kernel: np.ndarray) -> np.ndarray:
    """(kh, kw, cin, cout) int8 kernel -> (kh*kw*cin, cout) matrix."""
    kh, kw, cin, cout = kernel.shape
    return kernel.reshape(kh * kw * cin, cout).astype(np.int8)


def dwconv_weight_matrix(kernel: np.ndarray) -> np.ndarray:
    """(kh, kw, C) depth-wise kernel -> block-diagonal (C*kh*kw, C)."""
    kh, kw, c = kernel.shape
    w = np.zeros((c * kh * kw, c), dtype=np.int8)
    for g in range(c):
        w[g * kh * kw:(g + 1) * kh * kw, g] = \
            kernel[:, :, g].reshape(-1)
    return w


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int, pad: int,
           depthwise: bool = False) -> torch.Tensor:
    """``(B, H, W, C)`` maps -> ``(B, ho*wo, K)`` patches; zero padding.

    Patch order is ``(ky, kx, c)``, or ``(c, ky, kx)`` — the reference's
    ``(g, ky, kx)`` — for depth-wise.
    """
    b, h, w, c = x.shape
    xp = x.new_zeros((b, h + 2 * pad, w + 2 * pad, c))
    xp[:, pad:pad + h, pad:pad + w] = x
    # (B, ho, wo, C, kh, kw) windows, as views
    win = xp.unfold(1, kh, stride).unfold(2, kw, stride)
    ho, wo = win.shape[1], win.shape[2]
    if not depthwise:
        win = win.permute(0, 1, 2, 4, 5, 3)          # (ky, kx, c)
    return win.reshape(b, ho * wo, kh * kw * c)


def quantize(acc: torch.Tensor, q: QuantParams, div: int = 1
             ) -> torch.Tensor:
    den = div << q.shift
    v = (acc.to(torch.int64) * q.scale + (den >> 1)) // den
    return v.clamp(-128, 127).to(torch.int8)


def _sat_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.to(torch.int16) + b.to(torch.int16)).clamp(
        -128, 127).to(torch.int8)


def _sat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.to(torch.int32) * b.to(torch.int32)).clamp(
        -128, 127).to(torch.int8)


def _maxpool(y: torch.Tensor, k: int, stride: int, pad: int, ho: int,
             wo: int) -> torch.Tensor:
    """Zero-init window max over the valid positions of ``(B,H,W,n)``:
    padded positions hold 0, which the zero init already dominates."""
    b, h, w, n = y.shape
    hp = max(h + pad, (ho - 1) * stride + k)
    wp = max(w + pad, (wo - 1) * stride + k)
    yp = y.new_zeros((b, hp, wp, n))
    yp[:, pad:pad + h, pad:pad + w] = y
    out = y.new_zeros((b, ho, wo, n))
    for jy in range(k):
        for jx in range(k):
            out = torch.maximum(
                out, yp[:, jy:jy + (ho - 1) * stride + 1:stride,
                        jx:jx + (wo - 1) * stride + 1:stride])
    return out


def _group_spec(cg: CondensedGraph, g) -> Optional[Tuple]:
    src = cg.source
    if src is None or g.anchor is None:
        return None
    op = src.ops[g.anchor]
    if op.kind not in ("conv", "dwconv"):
        return None
    return (op.attrs["k"], op.attrs["stride"], op.attrs["padding"],
            op.kind == "dwconv")


def run_reference(cg: CondensedGraph, weights: Dict[int, torch.Tensor],
                  biases: Dict[int, torch.Tensor],
                  quant: Dict[int, QuantParams],
                  inputs: torch.Tensor,
                  return_acc: bool = False,
                  matmul: Optional[MatmulFn] = None,
                  faults: Optional[Any] = None
                  ) -> Dict[Union[int, str], torch.Tensor]:
    """Forward-pass the batch; returns {gid: (batch, ...) int8 maps}
    (conv groups: (B, ho', wo', N) post-fusion; vector groups: (B, N)).

    Every tensor lies on one device, which the MVMs run on.  ``matmul``
    overrides the contraction (default: the exact plain
    :func:`repro_torch.kernels.ref.mvm_ref`).  ``return_acc`` adds
    ``"acc"``: {gid: (B, M, N) int32 accumulators before the fused ops}.

    ``faults`` is an optional :class:`repro_torch.faults.FaultSet`:
    static weight matrices are stuck-at-corrupted before the MVM and
    each sample's ``(M, N)`` slice of the accumulator takes its
    deterministic per-``(group, sample)`` transient flips after it, as
    in the reference.  ``None`` (and an empty set) leave the oracle
    bit-exactly unchanged.  Dynamic-weight (attention) matmuls build
    their matrix from activations at run time and carry no
    stored-weight faults.
    """
    mm: MatmulFn = matmul if matmul is not None else mvm_ref
    src = cg.source
    assert src is not None, "reference needs the source graph"
    op_owner = {i: g.idx for g in cg for i in g.op_ids}
    B = inputs.shape[0]
    outs: Dict[int, torch.Tensor] = {}
    accs: Dict[int, torch.Tensor] = {}

    for g in cg:
        main, side = _main_and_skip_preds(cg, g, op_owner)
        wp = _weight_pred(cg, g, op_owner)
        spec = _group_spec(cg, g)
        q = quant[g.idx]
        vops = _vops(cg, g)
        anchor_op = src.ops[g.anchor] if g.anchor is not None else None
        x = inputs if main is None else outs[main]
        if g.dynamic_weights:
            wbuf = inputs if wp is None else outs[wp]
            W = vecsem.dynamic_weight_matrix(
                wbuf, anchor_op.gemm_k, anchor_op.gemm_n, anchor_op.groups,
                bool(anchor_op.attrs.get("transpose_weights")))
            kdim, n = W.shape[1:]
        else:
            W = weights[g.idx]
            if faults is not None:
                W = faults.corrupt_weight_matrix(g.idx, W)
            kdim, n = W.shape
        if spec is not None:
            k, stride, pad, dw = spec
            a = im2col(x, k, k, stride, pad, dw)
            ho, wo, n = anchor_op.out_shape
        else:
            a = x.reshape(B, -1, kdim)
            ho, wo = 1, 1
        if g.dynamic_weights:
            acc = torch.stack([mm(a[s], W[s]) for s in range(B)])
        else:
            acc = mm(a.reshape(-1, kdim), W).reshape(B, -1, n)
        if faults is not None:
            acc = torch.stack([faults.corrupt_acc(acc[s], g.idx, s)
                               for s in range(B)])
        if return_acc:
            accs[g.idx] = acc
        sv = (outs[side[0]] if side else x) \
            if ("add" in vops or "mul" in vops) else None
        # process fused ops strictly in graph order
        i32 = True                    # still in the INT32 accumulator?
        y = None

        def leave_i32():
            nonlocal i32, y
            if i32:
                z = quantize(acc, q)
                y = (z.reshape(B, ho, wo, n) if spec is not None
                     else z.reshape(B, -1))
                i32 = False

        for op in vops:
            if op == "bias":
                acc = acc + biases[g.idx].to(torch.int32)
            elif op == "relu":
                if i32:
                    acc = acc.clamp_min(0)
                else:
                    y = y.clamp_min(0)
            elif op in ("add", "mul"):
                leave_i32()
                if op == "mul":
                    y = _sat_mul(y, sv.reshape(
                        (B,) + (1,) * (y.dim() - 2) + (-1,)))
                else:
                    y = _sat_add(y, sv.reshape(y.shape))
            elif op == "maxpool":
                leave_i32()
                y = _maxpool(y, *_pool_of(cg, g))
            elif op == "globalpool":
                leave_i32()
                m = y.reshape(B, -1, n)
                y = quantize(m.to(torch.int64).sum(dim=1), q,
                             div=m.shape[1])
            elif op == "softmax":
                # per head-row segment, matching codegen's VLEN
                leave_i32()
                seg = anchor_op.gemm_n if anchor_op is not None \
                    else y.shape[-1]
                y = vecsem.softmax_i8(y.reshape(-1, seg)).reshape(y.shape)
            elif op == "layernorm":
                leave_i32()
                row = y.shape[-1]
                if anchor_op is not None:
                    row = anchor_op.gemm_n * (
                        anchor_op.groups if anchor_op.groups > 1 else 1)
                y = vecsem.layernorm_i8(y.reshape(-1, row)).reshape(y.shape)
            elif op == "gelu":
                leave_i32()
                y = vecsem.gelu_i8(y)
            else:
                raise NotImplementedError(
                    f"oracle: fused op {op!r} unsupported")
        leave_i32()
        outs[g.idx] = y
    if return_acc:
        outs["acc"] = accs          # type: ignore[assignment]
    return outs


def _vops(cg: CondensedGraph, g) -> Tuple[str, ...]:
    src = cg.source
    out = []
    for i in g.op_ids:
        op = src.ops[i]
        if op.is_mvm or op.kind in ("bn", "flatten", "identity"):
            continue
        out.append(op.kind)
    return tuple(out)


def _pool_of(cg: CondensedGraph, g):
    src = cg.source
    for i in g.op_ids:
        op = src.ops[i]
        if op.kind == "maxpool":
            ho, wo, _ = op.out_shape
            return (op.attrs["k"], op.attrs["stride"],
                    op.attrs.get("padding", 0), ho, wo)
    return None


def random_init(cg: CondensedGraph, batch: int = 1, seed: int = 0,
                device: Union[str, torch.device, None] = None
                ) -> Tuple[Dict[int, torch.Tensor],
                           Dict[int, torch.Tensor], torch.Tensor]:
    """Random int8 ``(weights, biases, inputs)`` for a condensed graph.

    Drawn with numpy ``default_rng(seed)`` in the reference's order, so
    the same seed gives the same values as :func:`repro.core.ref.
    random_init`; then moved to ``device`` (default: CUDA).
    """
    dev = resolve_device(device)
    src = cg.source
    assert src is not None, "random_init needs the source graph"
    rng = np.random.default_rng(seed)
    weights: Dict[int, np.ndarray] = {}
    biases: Dict[int, np.ndarray] = {}
    lo, hi = -6, 7
    for g in cg:
        if g.anchor is None:
            continue
        op = src.ops[g.anchor]
        if op.kind == "conv":
            k = op.attrs["k"]
            cin = src.ops[op.inputs[0]].out_shape[-1]
            ker = rng.integers(lo, hi, (k, k, cin, op.gemm_n),
                               dtype=np.int8)
            weights[g.idx] = conv_weight_matrix(ker)
        elif op.kind == "dwconv":
            k = op.attrs["k"]
            ker = rng.integers(lo, hi, (k, k, op.groups), dtype=np.int8)
            weights[g.idx] = dwconv_weight_matrix(ker)
        elif op.kind == "linear" and not g.dynamic_weights:
            weights[g.idx] = rng.integers(lo, hi, (g.gemm_k, g.gemm_n),
                                          dtype=np.int8)
        if "bias" in _vops(cg, g):
            biases[g.idx] = rng.integers(
                -40, 40, g.gemm_n * (g.groups if g.groups > 1 else 1)
            ).astype(np.int32)
    inputs = rng.integers(-8, 8, (batch,) + src.ops[0].out_shape
                          ).astype(np.int8)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    return ({k: put(v) for k, v in weights.items()},
            {k: put(v) for k, v in biases.items()}, put(inputs))


def auto_quant(cg: CondensedGraph, weights: Dict[int, torch.Tensor],
               biases: Dict[int, torch.Tensor],
               inputs: torch.Tensor) -> Dict[int, QuantParams]:
    """Pick per-group shifts that keep outputs in a healthy int8 range
    (fixed-point iteration of the oracle: downstream ranges depend on
    upstream quantization).  Runs the plain oracle on the inputs'
    device."""
    qp = {g.idx: QuantParams(scale=1, shift=0) for g in cg}
    for _ in range(3):
        accs = run_reference(cg, weights, biases, qp, inputs,
                             return_acc=True)["acc"]
        peaks = torch.stack([accs[g.idx].abs().max().to(torch.int64)
                             for g in cg]).tolist()
        new = {}
        for g, p in zip(cg, peaks):
            peak = max(1, int(p))
            shift = (max(0, math.ceil(math.log2(peak / 100)))
                     if peak > 100 else 0)
            new[g.idx] = QuantParams(scale=1, shift=min(shift, 30))
        if new == qp:
            break
        qp = new
    return qp
