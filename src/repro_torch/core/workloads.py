"""DNN workload graph builders (paper §IV-A benchmark suite).

Host code: a copy of :mod:`repro.core.workloads` (the JAX package), kept
identical so the port's compile results equal the reference's; the
port imports nothing of ``repro``.

The paper evaluates on ResNet18, VGG19 (compute-intensive) and MobileNetV2,
EfficientNetB0 (compact, depth-wise separable).  All INT8 weights/activations
(§IV-A).  Builders return :class:`repro.core.graph.Graph` objects at standard
ImageNet geometry (224x224x3) unless ``res`` is overridden — tests use small
``res`` to keep the simulator fast.

A bonus ``transformer_lm`` builder exercises the compiler on transformer
blocks (attention score/context matmuls are dynamic-weight MVMs, marked
``attrs['dynamic_weights']``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .graph import Graph, Op

__all__ = [
    "resnet18", "vgg19", "mobilenetv2", "efficientnetb0",
    "transformer_lm", "transformer_decode", "tiny_cnn", "WORKLOADS",
    "build",
]


# ---------------------------------------------------------------------------
# ResNet18
# ---------------------------------------------------------------------------


def resnet18(res: int = 224, n_classes: int = 1000) -> Graph:
    g = Graph("resnet18")
    x = g.input("image", (res, res, 3))
    x = g.conv("conv1", x, cout=64, k=7, stride=2, padding=3, act="relu")
    x = g.pool("maxpool", x, k=3, stride=2, padding=1)

    def block(x: int, name: str, cout: int, stride: int) -> int:
        cin = g.ops[x].out_shape[-1]
        y = g.conv(f"{name}.conv1", x, cout=cout, k=3, stride=stride,
                   act="relu")
        y = g.conv(f"{name}.conv2", y, cout=cout, k=3)
        if stride != 1 or cin != cout:
            x = g.conv(f"{name}.down", x, cout=cout, k=1, stride=stride)
        y = g.eltwise(f"{name}.add", "add", y, x)
        return g.unary(f"{name}.relu", "relu", y)

    for li, (cout, stride) in enumerate(
            [(64, 1), (128, 2), (256, 2), (512, 2)], start=1):
        x = block(x, f"layer{li}.0", cout, stride)
        x = block(x, f"layer{li}.1", cout, 1)

    x = g.globalpool("avgpool", x)
    g.linear("fc", x, cout=n_classes)
    return g


# ---------------------------------------------------------------------------
# VGG19
# ---------------------------------------------------------------------------


def vgg19(res: int = 224, n_classes: int = 1000) -> Graph:
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
           512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
    g = Graph("vgg19")
    x = g.input("image", (res, res, 3))
    ci = 0
    for v in cfg:
        if v == "M":
            x = g.pool(f"pool{ci}", x, k=2, stride=2)
        else:
            ci += 1
            x = g.conv(f"conv{ci}", x, cout=int(v), k=3, act="relu")
    x = g.unary("flatten", "flatten", x)
    # classifier operates on the flattened 7x7x512; keep gemm_m = 1
    h, w, c = g.ops[g.ops[x].inputs[0]].out_shape
    g.ops[x].out_shape = (h * w * c,)
    x = g.linear("fc1", x, cout=4096, act="relu")
    x = g.linear("fc2", x, cout=4096, act="relu")
    g.linear("fc3", x, cout=n_classes)
    return g


# ---------------------------------------------------------------------------
# MobileNetV2
# ---------------------------------------------------------------------------

_MBV2_CFG = [  # (expansion t, cout, repeats, stride)
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


def mobilenetv2(res: int = 224, n_classes: int = 1000) -> Graph:
    g = Graph("mobilenetv2")
    x = g.input("image", (res, res, 3))
    x = g.conv("stem", x, cout=32, k=3, stride=2, act="relu6")
    bi = 0
    for t, c, n, s in _MBV2_CFG:
        for i in range(n):
            stride = s if i == 0 else 1
            cin = g.ops[x].out_shape[-1]
            name = f"block{bi}"
            y = x
            hidden = cin * t
            if t != 1:
                y = g.conv(f"{name}.expand", y, cout=hidden, k=1, act="relu6")
            y = g.conv(f"{name}.dw", y, cout=hidden, k=3, stride=stride,
                       groups=hidden, act="relu6")
            y = g.conv(f"{name}.project", y, cout=c, k=1)
            if stride == 1 and cin == c:
                y = g.eltwise(f"{name}.add", "add", y, x)
            x = y
            bi += 1
    x = g.conv("head", x, cout=1280, k=1, act="relu6")
    x = g.globalpool("avgpool", x)
    g.linear("fc", x, cout=n_classes)
    return g


# ---------------------------------------------------------------------------
# EfficientNetB0
# ---------------------------------------------------------------------------

_EFB0_CFG = [  # (expansion, cout, repeats, stride, kernel)
    (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3),
]


def efficientnetb0(res: int = 224, n_classes: int = 1000,
                   se_ratio: float = 0.25) -> Graph:
    g = Graph("efficientnetb0")
    x = g.input("image", (res, res, 3))
    x = g.conv("stem", x, cout=32, k=3, stride=2, act="silu")
    bi = 0
    for t, c, n, s, k in _EFB0_CFG:
        for i in range(n):
            stride = s if i == 0 else 1
            cin = g.ops[x].out_shape[-1]
            name = f"mbconv{bi}"
            y = x
            hidden = cin * t
            if t != 1:
                y = g.conv(f"{name}.expand", y, cout=hidden, k=1, act="silu")
            y = g.conv(f"{name}.dw", y, cout=hidden, k=k, stride=stride,
                       groups=hidden, act="silu")
            # squeeze-and-excite on the depthwise output
            se_c = max(1, int(cin * se_ratio))
            sq = g.globalpool(f"{name}.se.pool", y)
            sq = g.linear(f"{name}.se.reduce", sq, cout=se_c, act="silu")
            sq = g.linear(f"{name}.se.expand", sq, cout=hidden, act="sigmoid")
            y = g.eltwise(f"{name}.se.scale", "mul", y, sq)
            y = g.conv(f"{name}.project", y, cout=c, k=1)
            if stride == 1 and cin == c:
                y = g.eltwise(f"{name}.add", "add", y, x)
            x = y
            bi += 1
    x = g.conv("head", x, cout=1280, k=1, act="silu")
    x = g.globalpool("avgpool", x)
    g.linear("fc", x, cout=n_classes)
    return g


# ---------------------------------------------------------------------------
# Transformer LM (post-LN blocks; attention matmuls are dynamic-weight
# MVMs — their "weights" are the K / V activations, written into macro
# groups at runtime; see the weight-source abstraction in repro.core.graph)
# ---------------------------------------------------------------------------


def transformer_lm(n_layers: int = 4, d_model: int = 512, n_heads: int = 8,
                   d_ff: Optional[int] = None, seq: int = 128,
                   vocab: int = 32000) -> Graph:
    """Post-LN transformer blocks over an embedding projection.

    ``scores = q @ kᵀ`` carries ``attrs['transpose_weights']`` (the
    weight matrix is the transposed K activations); ``ctx = p @ v``
    uses V rows directly.  Both are grouped per-head GEMMs whose
    block-diagonal packing consumes whole activation rows, so the
    compiled input layout is exactly the producer's HW row layout.
    Post-LN placement keeps every residual tap a *group output*, which
    is the layout contract codegen's side-operand routing assumes.
    """
    d_ff = d_ff or 4 * d_model
    g = Graph(f"transformer_{n_layers}L_{d_model}d")
    x = g.input("tokens", (seq, d_model))   # token embeddings
    # embedding projection: gives layer 0's residual tap a group output
    x = g.linear("embed", x, cout=d_model, bias=False)
    dh = d_model // n_heads

    def mha(name: str, src: int) -> int:
        q = g.linear(f"{name}.q", src, cout=d_model, bias=False)
        k = g.linear(f"{name}.k", src, cout=d_model, bias=False)
        v = g.linear(f"{name}.v", src, cout=d_model, bias=False)
        # scores = q @ k^T : per-head (seq x dh) @ (dh x seq)
        sc = g.add(Op(name=f"{name}.scores", kind="matmul", inputs=(q, k),
                      out_shape=(n_heads, seq, seq), gemm_m=seq, gemm_k=dh,
                      gemm_n=seq, groups=n_heads,
                      attrs={"dynamic_weights": True,
                             "transpose_weights": True}))
        sm = g.unary(f"{name}.softmax", "softmax", sc)
        ctx = g.add(Op(name=f"{name}.ctx", kind="matmul", inputs=(sm, v),
                       out_shape=(seq, d_model), gemm_m=seq, gemm_k=seq,
                       gemm_n=dh, groups=n_heads,
                       attrs={"dynamic_weights": True}))
        o = g.linear(f"{name}.o", ctx, cout=d_model, bias=False)
        r = g.eltwise(f"{name}.res", "add", o, src)
        return g.unary(f"{name}.ln", "layernorm", r)

    for li in range(n_layers):
        x = mha(f"l{li}.attn", x)
        y = g.linear(f"l{li}.up", x, cout=d_ff, bias=False, act="gelu")
        y = g.linear(f"l{li}.down", y, cout=d_model, bias=False)
        y = g.eltwise(f"l{li}.res2", "add", y, x)
        x = g.unary(f"l{li}.ln2", "layernorm", y)
    g.linear("lm_head", x, cout=vocab, bias=False)
    return g


def transformer_decode(n_layers: int = 2, d_model: int = 128,
                       n_heads: int = 4, d_ff: Optional[int] = None,
                       kv_len: int = 64, vocab: int = 256,
                       incremental: bool = True) -> Graph:
    """One KV-cached decode step (seq=1) against a ``kv_len``-entry cache.

    The per-layer K/V caches are *graph inputs* ``(kv_len, d_model)``
    serving as the attention matmuls' dynamic-weight operands — the
    gmem-resident cache the chip streams into its macro groups.  The
    new token's K/V projections are emitted as boundary outputs (the
    cache-append write-back); they do not feed this step's attention,
    which reads the already-appended ``kv_len``-entry cache.

    ``incremental=True`` marks both attention matmuls ``kv_append``:
    across consecutive samples the cache differs only in its last row,
    so mapping/trace/codegen price an append-row re-stage (O(1) per
    step in ``kv_len``) instead of re-gathering the whole buffer.  With
    ``incremental=False`` the full per-sample re-stage of the dynamic
    path is priced — the O(kv_len) baseline the serving regression
    test compares against.
    """
    d_ff = d_ff or 4 * d_model
    dh = d_model // n_heads
    g = Graph(f"decode_{n_layers}L_{d_model}d_kv{kv_len}")
    x = g.input("token", (1, d_model))      # current-token embedding
    caches = [(g.input(f"l{li}.k_cache", (kv_len, d_model)),
               g.input(f"l{li}.v_cache", (kv_len, d_model)))
              for li in range(n_layers)]
    x = g.linear("embed", x, cout=d_model, bias=False)
    attn_attrs = {"dynamic_weights": True}
    if incremental:
        attn_attrs["kv_append"] = True

    def mha(name: str, src: int, kc: int, vc: int) -> int:
        q = g.linear(f"{name}.q", src, cout=d_model, bias=False)
        # cache-append write-back of the new token's K/V row (boundary
        # outputs: no in-graph consumer, spilled to gmem)
        g.linear(f"{name}.k", src, cout=d_model, bias=False)
        g.linear(f"{name}.v", src, cout=d_model, bias=False)
        # scores = q @ K_cacheᵀ : per-head (1 x dh) @ (dh x kv_len)
        sc = g.add(Op(name=f"{name}.scores", kind="matmul",
                      inputs=(q, kc), out_shape=(n_heads, 1, kv_len),
                      gemm_m=1, gemm_k=dh, gemm_n=kv_len, groups=n_heads,
                      attrs=dict(attn_attrs, transpose_weights=True)))
        sm = g.unary(f"{name}.softmax", "softmax", sc)
        ctx = g.add(Op(name=f"{name}.ctx", kind="matmul",
                       inputs=(sm, vc), out_shape=(1, d_model),
                       gemm_m=1, gemm_k=kv_len, gemm_n=dh, groups=n_heads,
                       attrs=dict(attn_attrs)))
        o = g.linear(f"{name}.o", ctx, cout=d_model, bias=False)
        r = g.eltwise(f"{name}.res", "add", o, src)
        return g.unary(f"{name}.ln", "layernorm", r)

    for li in range(n_layers):
        kc, vc = caches[li]
        x = mha(f"l{li}.attn", x, kc, vc)
        y = g.linear(f"l{li}.up", x, cout=d_ff, bias=False, act="gelu")
        y = g.linear(f"l{li}.down", y, cout=d_model, bias=False)
        y = g.eltwise(f"l{li}.res2", "add", y, x)
        x = g.unary(f"l{li}.ln2", "layernorm", y)
    g.linear("lm_head", x, cout=vocab, bias=False)
    return g


# ---------------------------------------------------------------------------
# Tiny CNN — used by the compile-and-run (ISS vs JAX oracle) tests
# ---------------------------------------------------------------------------


def tiny_cnn(res: int = 8, c: int = 8, n_classes: int = 10) -> Graph:
    g = Graph("tiny_cnn")
    x = g.input("image", (res, res, 3))
    x = g.conv("conv1", x, cout=c, k=3, act="relu", use_bn=False)
    x = g.pool("pool1", x, k=2, stride=2)
    x = g.conv("conv2", x, cout=2 * c, k=3, act="relu", use_bn=False)
    x = g.globalpool("gap", x)
    g.linear("fc", x, cout=n_classes)
    return g


def deepseek_proxy(n_layers: int = 8, d_model: int = 768, n_heads: int = 12,
                   d_ff: int = 2048, seq: int = 32,
                   vocab: int = 1024) -> Graph:
    """Scale-out proxy LM: a decoder stack whose resident int8 weights
    (~45 MB at the defaults) exceed one chip's weight-resident gmem
    capacity (~16.8 MB), so it compiles only through the
    :mod:`repro.system` multi-chip partitioner — the in-tree witness
    that the mesh genuinely extends reach rather than just latency."""
    g = transformer_lm(n_layers=n_layers, d_model=d_model, n_heads=n_heads,
                       d_ff=d_ff, seq=seq, vocab=vocab)
    g.name = f"deepseek_proxy_{n_layers}L_{d_model}d"
    return g


WORKLOADS = {
    "resnet18": resnet18,
    "vgg19": vgg19,
    "mobilenetv2": mobilenetv2,
    "efficientnetb0": efficientnetb0,
    "transformer": transformer_lm,
    "transformer_decode": transformer_decode,
    "tiny_cnn": tiny_cnn,
    "deepseek_proxy": deepseek_proxy,
}


def build(name: str, **kw) -> Graph:
    try:
        return WORKLOADS[name](**kw)
    except KeyError:
        raise KeyError(f"unknown workload {name!r}; "
                       f"have {sorted(WORKLOADS)}") from None
