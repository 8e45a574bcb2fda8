"""Computation-graph IR for the CIMFlow compiler.

Host code: a copy of :mod:`repro.core.graph` (the JAX package), kept
identical so the port's compile results equal the reference's; the
port imports nothing of ``repro``.

The compiler front-end (paper §III-C, *CG-level optimization*) works on an
operator DAG derived from an ONNX-like model description:

1.  **Op DAG** — one node per operator, with the tensor/GEMM geometry the
    CIM mapping needs (im2col'd ``(M, K, N)`` for MVM-based ops).
2.  **Condensation** — MVM-based operators (conv / linear / matmul) are
    identified as *anchors*; adjacent non-MVM operators (bias, BN, activation,
    pooling, element-wise adds, SE-scaling...) are grouped with them, giving a
    condensed CG whose nodes are :class:`Group` s.
3.  **Linearization** — a dependency-preserving topological order of groups,
    the substrate for the DP-based partitioning (Alg. 1).

Shapes are batch-free: feature maps are ``(H, W, C)``, vectors ``(C,)``.
The ``gemm_*`` fields describe one *sample*; batching is applied by the cost
model / simulator.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Op",
    "Graph",
    "Group",
    "CondensedGraph",
    "MVM_KINDS",
    "WEIGHT_STATIC",
    "WEIGHT_STREAMED",
    "WEIGHT_DYNAMIC",
    "WEIGHT_SOURCES",
]


class GraphError(ValueError):
    pass


# Operator kinds that anchor a CIM group (executed on the CIM unit).
MVM_KINDS = {"conv", "dwconv", "linear", "matmul"}

# Weight-source abstraction, threaded through every layer of the stack:
#
# * ``static``   — CIM-resident weights, preloaded from global memory in
#   the stage prologue (the classic CNN case);
# * ``streamed`` — weights exceed the allocated MG slots and are
#   re-loaded from global memory in multiple *rounds* per sample (a
#   *mapping* outcome, discovered at op-level planning, never a graph
#   property);
# * ``dynamic``  — the weights are a predecessor operator's activations
#   (attention Q·Kᵀ / P·V matmuls), written into macro groups at
#   runtime from local memory, once per sample.
WEIGHT_STATIC = "static"
WEIGHT_STREAMED = "streamed"
WEIGHT_DYNAMIC = "dynamic"
WEIGHT_SOURCES = (WEIGHT_STATIC, WEIGHT_STREAMED, WEIGHT_DYNAMIC)

# Vector-unit kinds and their per-element cost class (see VectorUnitConfig).
VECTOR_KINDS = {
    "bias": "alu", "bn": "mul", "relu": "alu", "relu6": "alu",
    "silu": "special", "gelu": "special", "sigmoid": "special",
    "swish": "special", "tanh": "special", "softmax": "special",
    "add": "alu", "mul": "mul", "maxpool": "alu", "avgpool": "alu",
    "globalpool": "alu", "quant": "mul", "dequant": "mul",
    "layernorm": "special", "rmsnorm": "special", "concat": "alu",
    "pad": "alu", "flatten": "alu", "identity": "alu",
}


@dataclass
class Op:
    """A single operator node.

    ``out_shape`` is the batch-free output shape.  For MVM-based kinds the
    ``gemm_*`` triple is the im2col'd per-sample GEMM: ``M`` output
    positions, ``K`` reduction length, ``N`` output channels.  Depth-wise
    conv is modelled as ``groups=C`` small GEMMs: ``K = kh*kw`` and
    ``N = C`` — one output channel per group.  Its poor CIM row-utilization
    (``K`` ≪ macro rows) then *emerges* from the mapping rather than being
    special-cased.
    """

    name: str
    kind: str
    inputs: Tuple[int, ...] = ()
    out_shape: Tuple[int, ...] = ()
    attrs: Dict[str, Any] = field(default_factory=dict)
    # GEMM geometry for MVM kinds (per sample, post-im2col).
    gemm_m: int = 0
    gemm_k: int = 0
    gemm_n: int = 0
    groups: int = 1          # grouped conv / depthwise
    weight_bits: int = 8
    act_bits: int = 8
    idx: int = -1            # assigned on insertion

    # -- derived ------------------------------------------------------------

    @property
    def is_mvm(self) -> bool:
        return self.kind in MVM_KINDS

    @property
    def out_elems(self) -> int:
        return int(math.prod(self.out_shape)) if self.out_shape else 0

    @property
    def weight_elems(self) -> int:
        if not self.is_mvm:
            return 0
        return self.gemm_k * self.gemm_n * self.groups

    @property
    def weight_bytes(self) -> int:
        return self.weight_elems * self.weight_bits // 8

    @property
    def macs(self) -> int:
        if not self.is_mvm:
            return 0
        return self.gemm_m * self.gemm_k * self.gemm_n * self.groups

    @property
    def flops(self) -> int:
        return 2 * self.macs

    def __repr__(self) -> str:
        if self.is_mvm:
            return (f"Op({self.idx}:{self.name} {self.kind} "
                    f"M{self.gemm_m} K{self.gemm_k} N{self.gemm_n}"
                    f"{f' g{self.groups}' if self.groups > 1 else ''})")
        return f"Op({self.idx}:{self.name} {self.kind} {self.out_shape})"


class Graph:
    """An operator DAG under construction + analysis helpers."""

    def __init__(self, name: str = "model") -> None:
        self.name = name
        self.ops: List[Op] = []

    # -- construction ---------------------------------------------------------

    def add(self, op: Op) -> int:
        for i in op.inputs:
            if not 0 <= i < len(self.ops):
                raise GraphError(f"{op.name}: dangling input {i}")
        op.idx = len(self.ops)
        self.ops.append(op)
        return op.idx

    def input(self, name: str, shape: Tuple[int, ...]) -> int:
        return self.add(Op(name=name, kind="input", out_shape=shape))

    def conv(self, name: str, src: int, *, cout: int, k: int, stride: int = 1,
             padding: Optional[int] = None, groups: int = 1,
             act: Optional[str] = None, use_bn: bool = True) -> int:
        """Conv2D (+BN+activation fused as separate grouped ops)."""
        h, w, cin = self.ops[src].out_shape
        if padding is None:
            padding = k // 2
        ho = (h + 2 * padding - k) // stride + 1
        wo = (w + 2 * padding - k) // stride + 1
        if cin % groups or cout % groups:
            raise GraphError(f"{name}: groups {groups} !| {cin}->{cout}")
        kind = "dwconv" if groups == cin and groups == cout else "conv"
        i = self.add(Op(
            name=name, kind=kind, inputs=(src,), out_shape=(ho, wo, cout),
            gemm_m=ho * wo, gemm_k=(cin // groups) * k * k,
            gemm_n=cout // groups, groups=groups,
            attrs={"k": k, "stride": stride, "padding": padding}))
        if use_bn:
            i = self.add(Op(name=f"{name}.bn", kind="bn", inputs=(i,),
                            out_shape=(ho, wo, cout)))
        if act:
            i = self.add(Op(name=f"{name}.{act}", kind=act, inputs=(i,),
                            out_shape=(ho, wo, cout)))
        return i

    def linear(self, name: str, src: int, *, cout: int,
               act: Optional[str] = None, bias: bool = True) -> int:
        shp = self.ops[src].out_shape
        cin = shp[-1]
        m = int(math.prod(shp[:-1])) if len(shp) > 1 else 1
        out_shape = shp[:-1] + (cout,)
        i = self.add(Op(name=name, kind="linear", inputs=(src,),
                        out_shape=out_shape, gemm_m=m, gemm_k=cin,
                        gemm_n=cout))
        if bias:
            i = self.add(Op(name=f"{name}.bias", kind="bias", inputs=(i,),
                            out_shape=out_shape))
        if act:
            i = self.add(Op(name=f"{name}.{act}", kind=act, inputs=(i,),
                            out_shape=out_shape))
        return i

    def pool(self, name: str, src: int, *, k: int, stride: Optional[int] = None,
             kind: str = "maxpool", padding: int = 0) -> int:
        stride = stride or k
        h, w, c = self.ops[src].out_shape
        ho = (h + 2 * padding - k) // stride + 1
        wo = (w + 2 * padding - k) // stride + 1
        return self.add(Op(name=name, kind=kind, inputs=(src,),
                           out_shape=(ho, wo, c),
                           attrs={"k": k, "stride": stride,
                                  "padding": padding}))

    def globalpool(self, name: str, src: int) -> int:
        _, _, c = self.ops[src].out_shape
        return self.add(Op(name=name, kind="globalpool", inputs=(src,),
                           out_shape=(c,)))

    def eltwise(self, name: str, kind: str, a: int, b: int) -> int:
        sa, sb = self.ops[a].out_shape, self.ops[b].out_shape
        if sa != sb and math.prod(sa) != math.prod(sb):
            # allow broadcast (SE scaling: (C,) * (H,W,C))
            if sa[-1] != sb[-1]:
                raise GraphError(f"{name}: shape mismatch {sa} vs {sb}")
        out = sa if math.prod(sa) >= math.prod(sb) else sb
        return self.add(Op(name=name, kind=kind, inputs=(a, b),
                           out_shape=out))

    def unary(self, name: str, kind: str, src: int) -> int:
        return self.add(Op(name=name, kind=kind, inputs=(src,),
                           out_shape=self.ops[src].out_shape))

    # -- analysis -------------------------------------------------------------

    def consumers(self) -> List[List[int]]:
        outs: List[List[int]] = [[] for _ in self.ops]
        for op in self.ops:
            for i in op.inputs:
                outs[i].append(op.idx)
        return outs

    def topo_order(self) -> List[int]:
        # ops are appended post-order already; verify and return.
        for op in self.ops:
            for i in op.inputs:
                if i >= op.idx:
                    raise GraphError("graph not in topological insert order")
        return list(range(len(self.ops)))

    @property
    def total_weight_bytes(self) -> int:
        return sum(op.weight_bytes for op in self.ops)

    @property
    def total_macs(self) -> int:
        return sum(op.macs for op in self.ops)

    def summary(self) -> str:
        n_mvm = sum(1 for o in self.ops if o.is_mvm)
        return (f"graph '{self.name}': {len(self.ops)} ops ({n_mvm} MVM), "
                f"{self.total_weight_bytes / 1e6:.2f} MB weights, "
                f"{self.total_macs / 1e6:.1f} MMACs/sample")

    def condense(self) -> "CondensedGraph":
        return CondensedGraph.from_graph(self)


# ---------------------------------------------------------------------------
# Condensed graph (groups)
# ---------------------------------------------------------------------------


@dataclass
class Group:
    """A condensed CG node: one MVM anchor + its fused non-MVM neighbours.

    Quantities consumed by the mapping cost model:

    * ``gemm_m/k/n``, ``groups``  — the anchor GEMM (zero for anchor-less
      groups, e.g. a leading pool);
    * ``weight_bytes``            — CIM array footprint;
    * ``vector_work``             — per-sample vector-unit element-ops,
      split by latency class;
    * ``in_bytes`` / ``out_bytes``— activation traffic across the group
      boundary (per sample).
    """

    idx: int
    name: str
    op_ids: Tuple[int, ...]
    anchor: Optional[int]               # op id of the MVM anchor
    preds: Tuple[int, ...] = ()         # group indices
    gemm_m: int = 0
    gemm_k: int = 0
    gemm_n: int = 0
    groups: int = 1
    weight_bits: int = 8
    act_bits: int = 8
    weight_bytes: int = 0
    macs: int = 0
    vector_work: Dict[str, int] = field(default_factory=dict)
    in_bytes: int = 0
    out_bytes: int = 0
    # Graph-level weight source of the anchor: ``static`` (learned
    # weights in gmem) or ``dynamic`` (weights are a predecessor op's
    # activations).  ``streamed`` is a mapping outcome, never set here.
    weight_source: str = WEIGHT_STATIC
    transpose_weights: bool = False     # dynamic: W = producer outputᵀ
    # Append-only dynamic weights (KV-cached decode): across consecutive
    # samples the weight operand grows by exactly one producer row, so
    # the mapping/trace/codegen layers may price (and emit) an
    # incremental re-gather of just the appended row instead of
    # re-staging the whole buffer.  Set from ``attrs['kv_append']``.
    weight_incremental: bool = False

    @property
    def is_mvm(self) -> bool:
        return self.anchor is not None

    @property
    def dynamic_weights(self) -> bool:
        return self.weight_source == WEIGHT_DYNAMIC

    @property
    def vector_elems(self) -> int:
        return sum(self.vector_work.values())

    def __repr__(self) -> str:
        return (f"Group({self.idx}:{self.name} w={self.weight_bytes}B "
                f"macs={self.macs} out={self.out_bytes}B)")


class CondensedGraph:
    """Condensed CG: dependency-preserving sequence of groups (paper §III-C)."""

    def __init__(self, name: str, groups: List[Group],
                 source: Optional[Graph] = None) -> None:
        self.name = name
        self.groups = groups
        self.source = source
        self._check()

    def _check(self) -> None:
        for g in self.groups:
            for p in g.preds:
                if not 0 <= p < g.idx:
                    raise GraphError(
                        f"group {g.idx} has non-topological pred {p}")

    def __len__(self) -> int:
        return len(self.groups)

    def __iter__(self):
        return iter(self.groups)

    def __getitem__(self, i: int) -> Group:
        return self.groups[i]

    # -- dependency closures (Alg. 1 line 1) ---------------------------------

    def ancestor_masks(self) -> List[int]:
        """Per-group bitmask of its transitive predecessors (exclusive)."""
        masks = [0] * len(self.groups)
        for g in self.groups:
            m = 0
            for p in g.preds:
                m |= masks[p] | (1 << p)
            masks[g.idx] = m
        return masks

    @property
    def total_weight_bytes(self) -> int:
        return sum(g.weight_bytes for g in self.groups)

    @property
    def total_macs(self) -> int:
        return sum(g.macs for g in self.groups)

    def summary(self) -> str:
        return (f"condensed '{self.name}': {len(self.groups)} groups, "
                f"{self.total_weight_bytes / 1e6:.2f} MB weights, "
                f"{self.total_macs / 1e6:.1f} MMACs/sample")

    # -- construction ---------------------------------------------------------

    @staticmethod
    def from_graph(g: Graph) -> "CondensedGraph":
        """MVM-anchored condensation.

        Pass 1: assign every op to a group id — an MVM op starts a new group;
        a non-MVM op joins the group of its *latest* producer (adjacent
        grouping).  Ops preceding any MVM (stem pools etc.) join group of
        their producer or a fresh anchor-less group for graph inputs.
        Pass 2: renumber groups in topological order of first-op, collect
        geometry + boundary traffic.
        """
        n = len(g.ops)
        owner = [-1] * n
        groups_ops: List[List[int]] = []

        for op in g.ops:
            if op.kind == "input":
                owner[op.idx] = -1          # inputs belong to no group
                continue
            if op.is_mvm:
                owner[op.idx] = len(groups_ops)
                groups_ops.append([op.idx])
                continue
            # non-MVM: fuse into the latest producing group
            prod_groups = [owner[i] for i in op.inputs if owner[i] >= 0]
            if prod_groups:
                gid = max(prod_groups)
            else:
                gid = len(groups_ops)       # anchor-less stem group
                groups_ops.append([])
            owner[op.idx] = gid
            groups_ops[gid].append(op.idx)

        cons = g.consumers()
        # renumber non-empty groups in first-op order (already topological)
        renum = {gid: k for k, gid in enumerate(
            gid for gid, ops_ in enumerate(groups_ops) if ops_)}
        out: List[Group] = []
        for gid, op_ids in enumerate(groups_ops):
            if not op_ids:
                continue
            anchor = next((i for i in op_ids if g.ops[i].is_mvm), None)
            member = set(op_ids)
            preds: Set[int] = set()
            in_bytes = 0
            for i in op_ids:
                for s in g.ops[i].inputs:
                    so = owner[s]
                    if so == gid:
                        continue
                    if so >= 0:
                        preds.add(renum[so])
                    sop = g.ops[s]
                    in_bytes += sop.out_elems * sop.act_bits // 8
            out_bytes = 0
            for i in op_ids:
                if not cons[i] or any(c not in member for c in cons[i]):
                    op = g.ops[i]
                    out_bytes += op.out_elems * op.act_bits // 8
            vw: Dict[str, int] = {}
            for i in op_ids:
                op = g.ops[i]
                if op.is_mvm:
                    continue
                cls = _vec_class(op.kind)
                vw[cls] = vw.get(cls, 0) + op.out_elems
            a = g.ops[anchor] if anchor is not None else None
            out.append(Group(
                idx=renum[gid], name=g.ops[op_ids[0]].name,
                op_ids=tuple(op_ids), anchor=anchor,
                preds=tuple(sorted(preds)),
                gemm_m=a.gemm_m if a else 0, gemm_k=a.gemm_k if a else 0,
                gemm_n=a.gemm_n if a else 0, groups=a.groups if a else 1,
                weight_bits=a.weight_bits if a else 8,
                act_bits=a.act_bits if a else 8,
                weight_bytes=a.weight_bytes if a else 0,
                macs=a.macs if a else 0, vector_work=vw,
                in_bytes=in_bytes, out_bytes=out_bytes,
                weight_source=(WEIGHT_DYNAMIC
                               if a is not None
                               and a.attrs.get("dynamic_weights")
                               else WEIGHT_STATIC),
                transpose_weights=bool(
                    a.attrs.get("transpose_weights")) if a else False,
                weight_incremental=bool(
                    a.attrs.get("kv_append")) if a else False))
        return CondensedGraph(g.name, out, source=g)


def _vec_class(kind: str) -> str:
    c = VECTOR_KINDS.get(kind, "alu")
    return c
