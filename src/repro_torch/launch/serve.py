"""LM serving: batched prefill + token-by-token decode.

Counterpart of :mod:`repro.launch.serve` (``python -m
repro.launch.serve``), on one CUDA device unless ``--device`` names
another.  ``--reduced`` serves the smoke-scale config.  Decode uses the
pre-allocated (ring-buffered under SWA, INT8 under the
``int8_kv_cache`` knob) caches, MLA latent caches, or SSD states —
whatever the architecture calls for — through the hand kernels for
decode attention and the SSD step on CUDA.  As the reference's launcher,
it runs under the local ``(1, 1)`` ``("data", "model")`` mesh, so MoE
architectures decode through expert-parallel MoE (``models/moe_ep``,
the grouped expert GEMM).

Example::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
        --reduced --device cpu --batch 2 --prompt-len 8 --gen 8

Prints what the reference prints: the run's shape, the prefill and
decode times (host clock after a device synchronize) and the first
sequence's first 16 sampled token ids.  Sampling draws from a generator
seeded with ``--seed + 1`` (its numbers differ from ``jax.random``'s);
``--temperature 0`` is greedy.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..configs import ARCHS, ShapeConfig, reduced
from ..data import make_batch
from ..device import resolve_device
from ..models import transformer as T
from . import meshctx, steps
from .mesh import data_axes_of, make_mesh

__all__ = ["main", "serve"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(args: argparse.Namespace) -> Dict:
    """Serve for parsed ``args``; returns the last logits, the
    sampled tokens (B, gen), and the prefill and decode seconds."""
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg)
    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh needs the production mesh and "
            "launch/sharding, which are not ported yet (ROADMAP §1)")
    dev = resolve_device(args.device)
    total = args.prompt_len + args.gen
    mesh = make_mesh((1, 1), ("data", "model"))

    with meshctx.use_mesh(mesh, data_axes=data_axes_of(mesh)):
        params = T.init_params(cfg, torch.Generator(dev).manual_seed(
            args.seed), dev)
        # one cast per model (the masters are not needed after it)
        params = T.cast_params(cfg, params)
        shape = ShapeConfig("cli", total, args.batch, "decode")
        decode_fn, _ = steps.make_decode_step(cfg, dev, shape)

        batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
            cfg, args.batch, args.prompt_len, seed=args.seed,
            step=0).items()}
        enc = (T._run_encoder(cfg, params, batch["frames"])
               if cfg.encoder_layers else None)
        state = T.init_decode_state(cfg, params, args.batch, total,
                                    enc=enc)

        # prefill by stepping the prompt through the decode path (fills
        # caches exactly, as the reference's serve.py does)
        _sync(dev)
        t0 = time.perf_counter()
        logits = None
        for t in range(args.prompt_len):
            logits, state = decode_fn(params, state,
                                      batch["tokens"][:, t:t + 1])
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        gen = torch.Generator(dev).manual_seed(args.seed + 1)
        out_tokens = []
        _sync(dev)
        t1 = time.perf_counter()
        for t in range(args.gen):
            if args.temperature > 0:
                probs = torch.softmax(logits / args.temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)
            else:
                nxt = torch.argmax(logits, dim=-1)[:, None]
            nxt = nxt.to(torch.int32)
            out_tokens.append(nxt)
            logits, state = decode_fn(params, state, nxt)
        _sync(dev)
        t_gen = time.perf_counter() - t1

    tokens = (torch.cat(out_tokens, dim=1) if out_tokens
              else torch.zeros((args.batch, 0), dtype=torch.int32))
    return {"cfg": cfg, "logits": logits, "tokens": tokens.cpu().numpy(),
            "prefill_s": t_prefill, "decode_s": t_gen}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "'cpu' runs the kernels' plain versions)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parser().parse_args(argv)
    out = serve(args)
    cfg, gen = out["cfg"], out["tokens"]
    t_prefill, t_gen = out["prefill_s"], out["decode_s"]
    print(f"arch={cfg.name} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen}")
    print(f"prefill: {t_prefill:.2f}s  decode: {t_gen:.2f}s "
          f"({args.batch * args.gen / t_gen:.1f} tok/s)")
    print("sample token ids:", gen[0][:16].tolist())
    logits = out["logits"]
    assert logits is None or bool(torch.isfinite(logits).all()), \
        "non-finite logits"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
