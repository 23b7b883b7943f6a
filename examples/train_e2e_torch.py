"""End-to-end training on the PyTorch port, the twin of
``examples/train_e2e.py``: a ~100M-param dense model trained for a few
hundred steps through the port's ``Trainer``, with checkpoints, one
injected failure and its recovery (restore the latest checkpoint, replay
from it), and the stats dump.

Run on the card: PYTHONPATH=src python examples/train_e2e_torch.py [--steps 200]
On the CPU, add:  --device cpu  (and a small --steps, --dim and
--ckpt-interval, so that a checkpoint precedes the failure)

Nothing here imports JAX.
"""

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.common import leaves
from repro_torch.train import (SimulatedFailure, Trainer, TrainOptions,
                               build_train_step, init_train_state)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ~100M params: 8 layers x d=512 (d_ff 1536) + 32k vocab
    base = smoke(get_config("stablelm-1.6b"))
    cfg = dataclasses.replace(
        base, n_layers=8, d_model=args.dim, d_ff=3 * args.dim, d_head=64,
        n_heads=args.dim // 64, n_kv_heads=args.dim // 64, vocab_size=32768)
    model = build_model(cfg)
    shape = ShapeConfig("e2e", seq_len=128, global_batch=8, kind="train")
    opts = TrainOptions(peak_lr=3e-3, warmup=min(20, args.steps // 4),
                        total_steps=args.steps,
                        chunk=128)
    state = init_train_state(model, 0, opts, device)
    n_params = sum(p.numel() for p in leaves(state["params"]))
    print(f"model: {cfg.n_layers}L d={cfg.d_model} "
          f"params={n_params / 1e6:.1f}M on {device}")
    step = build_train_step(model, opts)
    pipe = SyntheticPipeline(cfg, shape, seed=1)

    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(model=model, train_step=step, pipeline=pipe, state=state,
                     ckpt_dir=os.path.join(d, "ckpt"),
                     ckpt_interval=args.ckpt_interval,
                     heartbeat_path=os.path.join(d, "hb.json"))
        tr.instantiate()
        # inject one failure mid-run: the trainer must restore and continue
        res = tr.run(args.steps,
                     fail_at={args.steps // 2: SimulatedFailure("injected")})
        h = res["history"]
        print(f"loss: {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f} over "
              f"{res['final_step']} steps "
              f"(recovered {int(tr.s_failures.value())} failure)")
        if not h[-1]["loss"] < h[0]["loss"]:
            raise RuntimeError("training must reduce loss")
        print(tr.stats.dump_text())
    print("train_e2e OK")
    return res


if __name__ == "__main__":
    main()
