"""Training launcher of the port, with the flags of ``repro.launch.train``:

``python -m repro_torch.launch.train --arch <id> --steps 100 ...``

The ``Trainer`` over the synthetic pipeline, as the JAX launcher: a
smoke-sized config unless ``--full``, AdamW with a warmup of 10 steps,
with ``--ckpt-dir`` a checkpoint every 50 steps and one of the final
state.  It runs on the GPU; ``--device cpu`` runs it on the CPU.  It
prints one line per step, the stats dump on stderr (its distribution
prints as a dict), and last the JAX launcher's final JSON keys, the only
text on stdout from its first ``{`` on.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.configs import REGISTRY, get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.train import (Trainer, build_train_step,
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
    tr = Trainer(model=model, train_step=step, pipeline=pipe, state=state,
                 ckpt_dir=args.ckpt_dir, ckpt_interval=50)
    tr.instantiate()
    out = tr.run(args.steps)
    h = out["history"]
    for r in h:
        print(f"step {r['step']}: loss {r['loss']:.4f} "
              f"{r['time_s'] * 1e3:.1f} ms")
    print(tr.stats.dump_text(), file=sys.stderr)
    res = {"first_loss": h[0]["loss"], "last_loss": h[-1]["loss"],
           "steps": out["final_step"],
           "median_step_s": tr.watchdog.median()}
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
