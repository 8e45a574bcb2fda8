"""Unified decoder-LM / encoder-decoder model covering all ten assigned
architectures, on tensors.

Counterpart of :mod:`repro.models.transformer`:

* ``block_pattern`` interleaves sublayers per block — ``"A"`` (dense
  transformers), ``"M"`` (pure Mamba-2), ``"MMMMMMMA"`` (Jamba's 1:7
  hybrid).  The parameters live in a :class:`ParamTree` module whose
  ``blocks`` is a ``ModuleList`` of per-block trees; the reference's
  ``lax.scan`` over stacked blocks is a Python loop over it, and the
  per-block decode caches are a list.
* FFN per sublayer is dense MLP or MoE (``moe_stride`` alternates them,
  Jamba-style); attention is GQA, sliding-window, or MLA per config.
* ``encoder_layers > 0`` adds a bidirectional encoder + cross-attention
  (Whisper); the audio frontend is a stub fed precomputed frames.
* ``vision_tokens > 0`` prepends projected patch embeddings (LLaVA-style
  anyres stub) to the token embeddings.
* Decode keeps per-block KV caches (ring-buffered under sliding
  windows, written in place), MLA latent caches, or SSD recurrent
  states; the position is a host int that advances by one per step.

Mixed precision as in the reference: master parameters in
``param_dtype``, matrices and every floating leaf of the blocks cast to
``compute_dtype`` by :func:`cast_params`.  The reference casts inside
every ``decode_step``; here the cast is made once per model
(``decode_step`` takes cast
parameters as they are), which gives the same numbers.  The cast is
differentiable: :func:`loss_fn` casts under autograd, so the gradients
reach the fp32 masters (``ParamTree.requires_grad_``).

Training (:func:`loss_fn`) rematerializes each block with one
``torch.utils.checkpoint`` (non-reentrant), as the reference's
``jax.checkpoint`` over its scan body; the ``remat_policy`` knob
``"dots"`` keeps the matrix products' outputs (a selective checkpoint),
``"nothing"`` keeps nothing.  The next-token cross-entropy runs in
:func:`repro_torch.kernels.cross_entropy.cross_entropy`: the Triton
kernel on CUDA, its plain version on the CPU.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..kernels.cross_entropy import cross_entropy
from . import layers as L
from . import ssm as S

__all__ = ["ParamTree", "init_params", "cast_params", "forward", "loss_fn",
           "init_decode_state", "decode_step", "prefill", "cache_len_for"]

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dt(cfg: ArchConfig) -> Tuple[torch.dtype, torch.dtype]:
    return _DTYPES[cfg.param_dtype], _DTYPES[cfg.compute_dtype]


class ParamTree(nn.Module):
    """A nested mapping of tensors as a module: a mapping becomes a
    child ``ParamTree``, a list of mappings a ``ModuleList`` of them.  A
    tensor outside autograd becomes a parameter, created without a
    gradient (``requires_grad_(True)`` makes the tree trainable); a
    parameter is kept as it is; a tensor that autograd
    tracks (one computed from parameters, as :func:`cast_params` makes)
    is kept as it is too, as a buffer, so that gradients flow through it
    to the parameters it came from.  ``tree["name"]`` reads a child or a
    tensor, so the layer functions take these and plain dicts alike.
    ``compute_dtype`` is set on the trees :func:`cast_params` made."""

    def __init__(self, tree: Mapping[str, Any]) -> None:
        super().__init__()
        self.compute_dtype: Optional[torch.dtype] = None
        for k, v in tree.items():
            if isinstance(v, ParamTree):
                self.add_module(k, v)
            elif isinstance(v, Mapping):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, (list, tuple, nn.ModuleList)):
                self.add_module(k, nn.ModuleList(
                    t if isinstance(t, ParamTree) else ParamTree(t)
                    for t in v))
            elif isinstance(v, nn.Parameter):
                self.register_parameter(k, v)
            elif v.requires_grad:
                self.register_buffer(k, v, persistent=False)
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key: str):
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def __contains__(self, key: str) -> bool:
        return (key in self._modules or key in self._parameters
                or key in self._buffers)

    def keys(self):
        return (list(self._parameters) + list(self._buffers)
                + list(self._modules))

    def map(self, fn) -> "ParamTree":
        """A new tree of ``fn(tensor)`` over every leaf (same layout);
        ``fn`` runs under autograd, as called."""
        out = {}
        for k in self.keys():
            v = self[k]
            if isinstance(v, ParamTree):
                out[k] = v.map(fn)
            elif isinstance(v, nn.ModuleList):
                out[k] = [t.map(fn) for t in v]
            else:
                out[k] = fn(v)
        return ParamTree(out)


def cast_params(cfg: ArchConfig, params: ParamTree) -> ParamTree:
    """Mixed precision: master params stay in ``param_dtype``; matrices
    are cast to ``compute_dtype``, 1-D params outside the blocks
    (``final_norm``, ``enc_norm``, the MTP norm) stay full precision.  The
    reference casts its tree with the blocks stacked, so a block's 1-D
    params (norm scales, SSM A/D/dt_bias, conv bias) are 2-D there and
    cast too: here every floating leaf under ``blocks`` / ``enc_blocks``
    is cast whatever its rank.  Returns ``params`` itself when it is
    already a cast tree.  Differentiable: under autograd the cast leaves
    stay in the graph of the masters (the leaves left as they are *are*
    the masters)."""
    _, cdtype = _dt(cfg)
    if params.compute_dtype == cdtype:
        return params

    def cast(a: torch.Tensor, stacked: bool = False) -> torch.Tensor:
        if a.dim() + stacked < 2:
            return a
        if a.dtype == torch.int8:
            # §Perf int8_weights knob: INT8 storage, dequant at use
            # (fixed 1/128 scale stand-in)
            return a.to(cdtype) * (1.0 / 128)      # exact: a power of two
        if a.is_floating_point():
            return a.to(cdtype)
        return a

    cast_stacked = functools.partial(cast, stacked=True)
    tree = {}
    for k in params.keys():
        v = params[k]
        if isinstance(v, nn.ModuleList):    # blocks, enc_blocks: stacked
            tree[k] = [bp.map(cast_stacked) for bp in v]
        elif isinstance(v, ParamTree):
            tree[k] = v.map(cast)
        else:
            tree[k] = cast(v)
    from ..launch import spmd
    for k, v in tree.items():
        if k not in ("blocks", "enc_blocks") and spmd.any_dtensor(v):
            # fsdp_params: the tree's other leaves gathered over the data
            # axes once a step (the blocks' at each block's use)
            tree[k] = spmd.gather_over_data(v)
    out = ParamTree(tree)
    out.compute_dtype = cdtype
    return out


def _use_moe(cfg: ArchConfig, sub_idx: int) -> bool:
    if cfg.moe is None:
        return False
    stride = getattr(cfg.moe, "moe_stride", 1)
    return sub_idx % max(stride, 1) == 0


def _has_ffn(cfg: ArchConfig, ch: str) -> bool:
    return cfg.family != "ssm"          # Mamba-2 blocks are self-contained


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(cfg: ArchConfig, gen: torch.Generator, pdtype,
                cross: bool) -> Params:
    p: Params = {}
    dev = gen.device
    for i, ch in enumerate(cfg.block_pattern):
        p[f"norm{i}"] = L.norm_init(cfg, cfg.d_model, pdtype, dev)
        if ch == "A":
            if cfg.mla is not None:
                p[f"attn{i}"] = L.mla_init(cfg, gen, pdtype)
            else:
                p[f"attn{i}"] = L.attention_init(cfg, gen, pdtype)
            if cross:
                p[f"xnorm{i}"] = L.norm_init(cfg, cfg.d_model, pdtype, dev)
                p[f"xattn{i}"] = L.attention_init(cfg, gen, pdtype,
                                                  cross=True)
        else:
            p[f"ssm{i}"] = S.ssm_init(cfg, gen, pdtype)
        if _has_ffn(cfg, ch):
            p[f"fnorm{i}"] = L.norm_init(cfg, cfg.d_model, pdtype, dev)
            if _use_moe(cfg, i):
                p[f"moe{i}"] = L.moe_init(cfg, gen, pdtype)
            else:
                p[f"mlp{i}"] = L.mlp_init(cfg, gen, pdtype)
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: Union[str, torch.device, None] = None) -> ParamTree:
    """Random parameters from ``generator`` (drawn on its device), on
    ``device`` (default: CUDA).  The draws differ from the reference's
    (another generator); the initializers' scales and constants match."""
    dev = resolve_device(device)
    pdtype, _ = _dt(cfg)
    gen = generator
    p: Params = {
        "embed": (L._normal(gen, (cfg.vocab, cfg.d_model)) * 0.02
                  ).to(pdtype),
        "final_norm": L.norm_init(cfg, cfg.d_model, pdtype, gen.device),
    }
    cross = cfg.encoder_layers > 0
    p["blocks"] = [_init_block(cfg, gen, pdtype, cross)
                   for _ in range(cfg.n_blocks)]
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab, pdtype)
    if cross:
        p["enc_blocks"] = [{
            "norm0": L.norm_init(cfg, cfg.d_model, pdtype, gen.device),
            "attn0": L.attention_init(cfg, gen, pdtype),
            "fnorm0": L.norm_init(cfg, cfg.d_model, pdtype, gen.device),
            "mlp0": L.mlp_init(cfg, gen, pdtype),
        } for _ in range(cfg.encoder_layers)]
        p["enc_norm"] = L.norm_init(cfg, cfg.d_model, pdtype, gen.device)
    if cfg.vision_tokens:
        p["vis_proj"] = L.dense_init(gen, cfg.d_model, cfg.d_model, pdtype)
    if cfg.mtp:
        p["mtp"] = {
            "norm": L.norm_init(cfg, cfg.d_model, pdtype, gen.device),
            "proj": L.dense_init(gen, 2 * cfg.d_model, cfg.d_model, pdtype),
        }
    tree = ParamTree(p)
    return tree if gen.device == dev else tree.to(dev)


# ---------------------------------------------------------------------------
# Block application (full sequence)
# ---------------------------------------------------------------------------


def _block_apply(cfg: ArchConfig, bp, x, enc=None, positions=None):
    from ..launch import spmd
    if spmd.is_dtensor(x):
        # fsdp_params: this block's weights gathered over the data axes
        # for its use (recomputed under remat, as ZeRO-3 does)
        bp = spmd.gather_over_data(bp)
    aux = None
    for i, ch in enumerate(cfg.block_pattern):
        h = L.apply_norm(cfg, bp[f"norm{i}"], x)
        if ch == "A":
            if cfg.mla is not None:
                x = x + _settle(L.mla_apply(cfg, bp[f"attn{i}"], h,
                                            positions=positions), x)
            else:
                x = x + _settle(L.attention_apply(
                    cfg, bp[f"attn{i}"], h, causal=True,
                    positions=positions), x)
            if enc is not None:
                hx = L.apply_norm(cfg, bp[f"xnorm{i}"], x)
                x = x + _settle(L.attention_apply(
                    cfg, bp[f"xattn{i}"], hx, causal=False, kv_src=enc,
                    use_rope=False), x)
        else:
            x = x + S.ssm_apply(cfg, bp[f"ssm{i}"], h)
        if _has_ffn(cfg, ch):
            hf = L.apply_norm(cfg, bp[f"fnorm{i}"], x)
            if _use_moe(cfg, i):
                y, a = L.moe_apply(cfg, bp[f"moe{i}"], hf)
                x = x + y
                aux = a if aux is None else aux + a
            else:
                x = x + _settle(L.mlp_apply(cfg, bp[f"mlp{i}"], hf), x)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def _run_encoder(cfg: ArchConfig, params, frames: torch.Tensor):
    """Whisper-style encoder over precomputed frame embeddings."""
    _, cdtype = _dt(cfg)
    x = frames.to(cdtype)
    # sinusoidal positions
    s = x.shape[1]
    pos = torch.arange(s, device=x.device)[:, None]
    dim = torch.arange(cfg.d_model // 2, device=x.device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / cfg.d_model)
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(cdtype)
    x = x + _replicated_like(pe, x)
    from ..launch import spmd
    for bp in params["enc_blocks"]:
        bp = spmd.gather_over_data(bp)
        h = L.apply_norm(cfg, bp["norm0"], x)
        x = x + _settle(L.attention_apply(cfg, bp["attn0"], h, causal=False,
                                          use_rope=False), x)
        hf = L.apply_norm(cfg, bp["fnorm0"], x)
        x = x + _settle(L.mlp_apply(cfg, bp["mlp0"], hf), x)
    return L.apply_norm(cfg, params["enc_norm"], x)


def _settle(y, x):
    """A sublayer's output ``y`` in the residual stream ``x``'s
    placements (rows sharded as the batch, replicated over the model
    axis): over a distributed mesh the row-parallel products' partial
    sums are all-reduced here, once, before the residual add (Megatron's
    all-reduce), so every sublayer sees the same layout; else ``y``."""
    from ..launch import spmd
    if spmd.is_dtensor(y) and tuple(y.placements) != tuple(x.placements):
        return y.redistribute(x.device_mesh, x.placements)
    return y


def _replicated_like(t: torch.Tensor, x) -> torch.Tensor:
    """``t`` as a DTensor replicated over ``x``'s mesh when ``x`` is a
    DTensor (a table computed on every rank), else ``t``."""
    from ..launch import spmd
    if not spmd.is_dtensor(x):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _embed(table, tokens) -> torch.Tensor:
    """Rows of ``table`` at ``tokens``.  Over a distributed mesh a local
    region: a vocab-sharded table (``Shard(0)`` over the model axis) is
    looked up on each rank for the ids in its row range, the others'
    rows zero, and the partial rows summed once (an all-reduce of the
    activations, not a gather of the table); a ``d_model``-sharded or
    replicated table gives its columns, gathered.  The rows come back in
    the tokens' batch placements, replicated over the model axis."""
    from ..launch import spmd
    if not spmd.is_dtensor(table):
        return table[tokens.long()]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    axis = mesh.mesh_dim_names.index("model")
    t_model = table.placements[axis]
    t_pl = spmd.with_axes(mesh, tokens.placements, t_model,
                          data=Replicate())
    tok_pl = spmd.with_axes(mesh, tokens.placements)
    if t_model == Shard(0):
        n = table.shape[0] // mesh.shape[axis]
        lo = mesh.get_local_rank("model") * n

        def body(tab, tok):
            idx = tok.long() - lo
            ok = (idx >= 0) & (idx < n)
            rows = tab[idx.clamp(0, n - 1)]
            return torch.where(ok[..., None], rows, torch.zeros(
                (), dtype=rows.dtype, device=rows.device))
        out_pl = spmd.with_axes(mesh, tokens.placements, Partial())
    else:
        def body(tab, tok):
            return tab[tok.long()]
        out_pl = spmd.with_axes(mesh, tokens.placements,
                                Shard(2) if t_model == Shard(1)
                                else None)
    rows = spmd.local_region(
        body, mesh, (table, tokens), (t_pl, tok_pl), out_pl,
        (spmd.grad_over_data(mesh, t_pl, tokens.placements), tok_pl))
    return rows.redistribute(mesh, tok_pl)


def _embed_inputs(cfg: ArchConfig, params, batch: Mapping) -> Tuple:
    _, cdtype = _dt(cfg)
    x = _embed(params["embed"], batch["tokens"]).to(cdtype)
    if cfg.vision_tokens:
        vis = batch["patches"].to(cdtype) @ params["vis_proj"]
        x = torch.cat([vis, x], dim=1)
    enc = None
    if cfg.encoder_layers:
        enc = _run_encoder(cfg, params, batch["frames"])
    return x, enc


def _head(cfg: ArchConfig, params, dtype) -> torch.Tensor:
    from ..launch import spmd
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(dtype)
    return spmd.gather_over_data(head)


def forward(cfg: ArchConfig, params: ParamTree, batch: Mapping,
            remat: bool = True) -> torch.Tensor:
    """Logits over the (text) token positions.  ``remat`` is the
    reference's rematerialization switch; without autograd it changes
    nothing, and is kept for the signature."""
    params = cast_params(cfg, params)
    x, enc = _embed_inputs(cfg, params, batch)
    for bp in params["blocks"]:
        x, _ = _block_apply(cfg, bp, x, enc=enc)
    x = L.apply_norm(cfg, params["final_norm"], x)
    if cfg.vision_tokens:
        x = x[:, cfg.vision_tokens:]
    return x @ _head(cfg, params, x.dtype)


_aten = torch.ops.aten
# the matrix products' ops as autograd dispatches them (matmul and einsum
# land on these): what jax.checkpoint_policies.dots_saveable keeps
_DOTS = frozenset((_aten.mm.default, _aten.bmm.default,
                   _aten.addmm.default, _aten.baddbmm.default))


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_policy():
    """The ``context_fn`` of a block's checkpoint under the
    ``remat_policy`` knob: ``"dots"`` saves the matrix products' outputs,
    ``"nothing"`` (the default) recomputes the whole block."""
    from ..launch import tuning
    if tuning.FLAGS["remat_policy"] == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_dots)
    return None


def _remat_block(cfg: ArchConfig, bp, x, enc):
    ctx = _remat_policy()
    kw = {} if ctx is None else {"context_fn": ctx}
    # a block draws no random numbers: no RNG state to stash
    return checkpoint(_block_apply, cfg, bp, x, enc, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def loss_fn(cfg: ArchConfig, params: ParamTree, batch: Mapping,
            remat: bool = True) -> torch.Tensor:
    """Next-token cross-entropy (+ MoE aux + MTP when configured), a
    float32 scalar.  Each block is rematerialized (``remat``, as the
    reference always does; ``remat=False`` keeps every activation and
    gives the same numbers).  The parameters are cast under autograd, so
    ``loss.backward()`` reaches the masters that require grad."""
    params = cast_params(cfg, params)
    x, enc = _embed_inputs(cfg, params, batch)
    auxs = []
    for bp in params["blocks"]:
        if remat and torch.is_grad_enabled():
            x, aux = _remat_block(cfg, bp, x, enc)
        else:
            x, aux = _block_apply(cfg, bp, x, enc=enc)
        auxs.append(aux)
    x = L.apply_norm(cfg, params["final_norm"], x)
    if cfg.vision_tokens:
        x = x[:, cfg.vision_tokens:]
    head = _head(cfg, params, x.dtype)

    tokens = batch["tokens"]
    labels = batch.get("labels", tokens)

    def xent(h, lab):
        # logits in the compute dtype; the kernel reads them in fp32, as
        # the reference's (h @ head).astype(float32)
        logits = h @ head
        return _cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              lab.reshape(-1))

    loss = xent(x[:, :-1], labels[:, 1:])
    if cfg.mtp:
        # multi-token prediction: predict t+2 from (h_t, emb_{t+1})
        _, cdtype = _dt(cfg)
        emb_next = _embed(params["embed"], tokens[:, 1:-1]).to(cdtype)
        h = L.apply_norm(cfg, params["mtp"]["norm"], x[:, :-2])
        h2 = torch.cat([h, emb_next], -1) @ params["mtp"]["proj"]
        loss = loss + 0.3 * xent(h2, labels[:, 2:])
    if cfg.moe is not None:
        loss = loss + 0.01 * torch.sum(torch.stack(auxs))
    return loss


def _cross_entropy(logits, labels) -> torch.Tensor:
    """The mean cross-entropy (:func:`~repro_torch.kernels.cross_entropy.
    cross_entropy`).  Over a distributed mesh a local region: the logits'
    rows stay sharded as the batch is, their vocab (column-sharded by the
    head) is gathered over the model axis, so the kernel reads whole
    rows; each rank's mean over its rows, divided by the data ranks the
    rows are sharded over, leaves ``Partial`` over them (their sum is the
    global mean: every rank holds as many rows)."""
    from ..launch import spmd
    if not spmd.is_dtensor(logits):
        return cross_entropy(logits, labels)
    from torch.distributed.tensor import Partial, Replicate
    mesh = logits.device_mesh
    row_pl = lab_pl = spmd.with_axes(mesh, labels.placements)
    n = 1
    for i, pl in enumerate(row_pl):
        if pl.is_shard():
            n *= mesh.shape[i]
    out_pl = tuple(Partial() if pl.is_shard() else Replicate()
                   for pl in row_pl)
    return spmd.local_region(
        lambda lg, lb: cross_entropy(lg, lb) / n, mesh, (logits, labels),
        (row_pl, lab_pl), out_pl)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def cache_len_for(cfg: ArchConfig, seq_len: int) -> int:
    """KV slots needed for a context of ``seq_len`` (ring under SWA)."""
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_decode_state(cfg: ArchConfig, params, batch: int, seq_len: int,
                      enc: Optional[torch.Tensor] = None,
                      device: Union[str, torch.device, None] = None
                      ) -> Params:
    """Pre-allocated per-block caches + position counter (a host int).
    The device is ``params``' (or ``device``; default CUDA)."""
    from ..launch import tuning
    _, cdtype = _dt(cfg)
    if device is None and params is not None and "embed" in params:
        dev = params["embed"].device
    else:
        dev = resolve_device(device)
    kv_dtype = torch.int8 if tuning.FLAGS["int8_kv_cache"] else cdtype
    s_cache = cache_len_for(cfg, seq_len)
    caches: List[Params] = []
    for _ in range(cfg.n_blocks):
        c: Params = {}
        for i, ch in enumerate(cfg.block_pattern):
            if ch == "A":
                if cfg.mla is not None:
                    m = cfg.mla
                    c[f"attn{i}"] = {
                        "c_kv": torch.zeros((batch, s_cache,
                                             m.kv_lora_rank),
                                            dtype=cdtype, device=dev),
                        "k_rope": torch.zeros((batch, s_cache, 1,
                                               m.qk_rope_head_dim),
                                              dtype=cdtype, device=dev),
                    }
                else:
                    shape = (batch, s_cache, cfg.n_kv_heads, cfg.hd)
                    c[f"attn{i}"] = {
                        "k": torch.zeros(shape, dtype=kv_dtype, device=dev),
                        "v": torch.zeros(shape, dtype=kv_dtype, device=dev),
                    }
            else:
                c[f"ssm{i}"] = S.ssm_state_init(cfg, batch, cdtype, dev)
        caches.append(c)
    state: Params = {"caches": caches, "pos": 0}
    if enc is not None:
        state["enc"] = enc
    return state


def decode_step(cfg: ArchConfig, params: ParamTree, state: Params,
                token: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """One decode step: token (B, 1) int -> (logits (B, vocab) fp32,
    state).  The KV caches and the SSM states are updated in place on
    every device, so the input state is consumed; the returned state is
    a new dict with ``pos + 1``."""
    params = cast_params(cfg, params)
    _, cdtype = _dt(cfg)
    x = _embed(params["embed"], token).to(cdtype)
    pos = state["pos"]
    enc = state.get("enc")
    new_caches = []
    from ..launch import spmd
    for bp, cache in zip(params["blocks"], state["caches"]):
        bp = spmd.gather_over_data(bp)
        new_cache = {}
        for i, ch in enumerate(cfg.block_pattern):
            h = L.apply_norm(cfg, bp[f"norm{i}"], x)
            if ch == "A":
                if cfg.mla is not None:
                    y, nc = L.mla_decode(cfg, bp[f"attn{i}"], h,
                                         cache[f"attn{i}"], pos)
                else:
                    y, nc = L.attention_decode(cfg, bp[f"attn{i}"], h,
                                               cache[f"attn{i}"], pos)
                x = x + _settle(y, x)
                new_cache[f"attn{i}"] = nc
                if enc is not None:
                    hx = L.apply_norm(cfg, bp[f"xnorm{i}"], x)
                    x = x + _settle(L.attention_apply(
                        cfg, bp[f"xattn{i}"], hx, causal=False, kv_src=enc,
                        use_rope=False), x)
            else:
                y, ns = S.ssm_decode(cfg, bp[f"ssm{i}"], h,
                                     cache[f"ssm{i}"])
                x = x + y
                new_cache[f"ssm{i}"] = ns
            if _has_ffn(cfg, ch):
                hf = L.apply_norm(cfg, bp[f"fnorm{i}"], x)
                if _use_moe(cfg, i):
                    y, _ = L.moe_apply(cfg, bp[f"moe{i}"], hf)
                    x = x + y
                else:
                    x = x + _settle(L.mlp_apply(cfg, bp[f"mlp{i}"], hf), x)
        new_caches.append(new_cache)
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = (x[:, 0] @ _head(cfg, params, x.dtype)).to(torch.float32)
    new_state = dict(state)
    new_state["caches"] = new_caches
    new_state["pos"] = pos + 1
    return logits, new_state


def prefill(cfg: ArchConfig, params: ParamTree, batch: Mapping,
            seq_len: Optional[int] = None) -> Tuple[torch.Tensor, None]:
    """Last-token logits of the full prompt (the forward path), and no
    decode state: caches are filled by stepping decode, as the
    reference's ``launch/serve.py`` does."""
    logits = forward(cfg, params, batch, remat=False)
    return logits[:, -1], None
