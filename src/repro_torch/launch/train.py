"""Training launcher of the port, with the flags of ``repro.launch.train``:

``python -m repro_torch.launch.train --arch <id> --steps 100 ...``

A plain step loop over the synthetic pipeline: a smoke-sized config
unless ``--full``, AdamW with a warmup of 10 steps.  It runs on the GPU;
``--device cpu`` runs it on the CPU.  It prints one line per step and
the JAX launcher's final JSON keys.  ``--ckpt-dir`` raises: the
checkpoint manager and the ``Trainer`` come with ROADMAP.md Queue 1
items 7-8.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from repro_torch.configs import REGISTRY, get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.train import (batch_to, build_train_step,
                               default_options_for, init_train_state)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b",
                    choices=sorted(REGISTRY))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--d-model", type=int, default=None,
                    help="override smoke width (e.g. ~100M model)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)
    if args.ckpt_dir:
        raise NotImplementedError(
            "--ckpt-dir: checkpointing and the Trainer are not ported yet "
            "(ROADMAP.md Queue 1 items 7-8)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = smoke(cfg)
        if args.d_model:
            hd = max(16, args.d_model // max(cfg.n_heads, 1))
            cfg = dataclasses.replace(
                cfg, d_model=args.d_model, d_ff=args.d_model * 3,
                d_head=hd, vocab_size=4096,
                n_layers=max(cfg.n_layers, 8))
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    model = build_model(cfg)
    opts = dataclasses.replace(default_options_for(cfg), peak_lr=args.lr,
                               warmup=10, total_steps=args.steps, chunk=1024)
    state = init_train_state(model, args.seed, opts, device)
    step = build_train_step(model, opts)
    pipe = SyntheticPipeline(cfg, shape, seed=args.seed)
    losses, seconds = [], []
    for i in range(args.steps):
        batch = batch_to(pipe.batch(i), device)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        m = {k: float(v) for k, v in metrics.items()}   # waits for the step
        seconds.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        print(f"step {i}: loss {m['loss']:.4f} aux {m['aux_loss']:.4f} "
              f"grad_norm {m['grad_norm']:.4f} lr {m['lr']:.3e} "
              f"{seconds[-1] * 1e3:.1f} ms")
    res = {"first_loss": losses[0], "last_loss": losses[-1],
           "steps": int(state["step"]),
           "median_step_s": float(np.median(seconds))}
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
