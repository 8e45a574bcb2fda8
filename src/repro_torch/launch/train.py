"""Training driver: data -> train step -> checkpoints, with the
fault-tolerance substrate wired in.

Counterpart of :mod:`repro.launch.train` (``python -m
repro.launch.train``), on one CUDA device unless ``--device`` names
another.  ``--reduced`` trains the smoke-scale config.  Demonstrates:

* deterministic resumable data (stream state in the checkpoint),
* async atomic checkpointing + crash-safe restore,
* straggler detection over per-step timings,
* elastic re-mesh planning on simulated node loss (``--simulate-loss``,
  planned over the local mesh of one device).

As the reference's launcher, it runs under a mesh context: the local
``(1, 1)`` ``("data", "model")`` mesh (:func:`.mesh.make_mesh`), so MoE
architectures train through expert-parallel MoE (``models/moe_ep``, the
grouped expert GEMM).

Example::

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch mamba2-780m --reduced --steps 6 --device cpu

Prints the reference's lines (the loss, learning rate, gradient norm
and host ms of a step every ``--log-every`` steps; a ``done:`` line with
the median ms/step).  The parameters come from a generator seeded 0
(its numbers differ from ``jax.random``'s).  A checkpoint named step N
holds the state after N updates and the stream positioned at batch N,
so a resume from it repeats nothing: every ``--ckpt-every`` updates and
at the end.  ``--production-mesh`` trains over the reference's (16, 16)
mesh (:func:`.mesh.make_production_mesh`), the step's tensors placed by
the sharding rules: it needs a process group of 256 ranks, and without
one it prints which and exits 1 (there is no fallback to the local
mesh).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import ARCHS, ShapeConfig, reduced
from ..data import SyntheticStream
from ..device import resolve_device
from ..models import transformer as T
from ..optim import AdamWConfig, adamw_init
from ..runtime import StragglerDetector, plan_remesh
from . import meshctx, steps
from .mesh import axis_size, make_mesh, make_production_mesh
from .sharding import usable_data_axes

__all__ = ["main", "parser", "local_mesh"]


def local_mesh():
    """The launchers' mesh: one device, as (data, model)."""
    return make_mesh((1, 1), ("data", "model"))


def _to_device(batch, dev: torch.device):
    """A numpy batch on ``dev`` without waiting on the device's queue
    (pinned host copies, asynchronous transfers)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--simulate-loss", type=int, default=0,
                    help="simulate N chips lost at mid-run (re-mesh demo)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "'cpu' runs the kernels' plain versions)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parser().parse_args(argv)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg)
    try:
        mesh = make_production_mesh() if args.production_mesh \
            else local_mesh()
    except RuntimeError as e:
        print(f"--production-mesh: {e}", file=sys.stderr)
        return 1
    dev = resolve_device(args.device)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    adamw = AdamWConfig()
    dp = usable_data_axes(mesh, args.batch)

    with meshctx.use_mesh(mesh, data_axes=dp):
        step_fn, _ = steps.make_train_step(
            cfg, dev, shape, adamw, lr_peak=args.lr,
            warmup=max(2, args.steps // 10), total_steps=args.steps,
            mesh=mesh)
        params = T.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
        opt = adamw_init(params, adamw)

        start = 0
        stream_state = {"step": 0, "seed": 0}
        mgr: Optional[CheckpointManager] = None
        if args.ckpt_dir:
            mgr = CheckpointManager(args.ckpt_dir, keep=3)
            restored = mgr.restore({"params": params, "opt": opt})
            if restored[0] is not None:
                start, tree, meta = restored
                params, opt = tree["params"], tree["opt"]
                stream_state = meta.get("stream", stream_state)
                print(f"[resume] from step {start}")

        stream = SyntheticStream.restore(cfg, args.batch, args.seq,
                                         stream_state)
        straggler = StragglerDetector()
        t_hist = []
        for step in range(start, args.steps):
            batch = _to_device(next(stream), dev)
            t0 = time.time()
            params, opt, metrics = step_fn(params, opt, batch, step)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            t_hist.append(dt)
            flagged = straggler.record_step({"host0": dt})
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt * 1e3:.0f} ms"
                      + (f" stragglers={flagged}" if flagged else ""))
            done = step + 1
            if mgr and done % args.ckpt_every == 0 and done < args.steps:
                mgr.save(done, {"params": params, "opt": opt},
                         metadata={"stream": stream.state_dict(),
                                   "step": done})
            if args.simulate_loss and step == args.steps // 2:
                survivors = mesh.size() - args.simulate_loss
                plan = plan_remesh(
                    survivors, model_parallel=axis_size(mesh, "model"),
                    target_data_parallel=int(np.prod(
                        [axis_size(mesh, a) for a in dp])) if dp else 1)
                print(f"[elastic] lost {args.simulate_loss} chips -> "
                      f"mesh {plan.mesh_shape}, grad_accum x"
                      f"{plan.grad_accum} ({plan.reason}); restart from "
                      f"latest checkpoint would resume step "
                      f"{mgr.latest_step() if mgr else 'n/a'}")
        if mgr:
            mgr.save(args.steps, {"params": params, "opt": opt},
                     metadata={"stream": stream.state_dict(),
                               "step": args.steps}, blocking=True)
        stream.close()
        print(f"done: {args.steps - start} steps, "
              f"median {np.median(t_hist) * 1e3:.0f} ms/step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
