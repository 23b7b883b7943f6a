"""Serving launcher of the port: the continuous-batching server on a
smoke-sized model, with the flags of ``repro.launch.serve``.

``python -m repro_torch.launch.serve --arch stablelm-1.6b --requests 8``

It runs on the GPU; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import REGISTRY, get_config, smoke
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import BatchServer, Request


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b",
                    choices=sorted(REGISTRY))
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke(get_config(args.arch))
    model = build_model(cfg)
    params = model.init(args.seed, device)
    srv = BatchServer(model, params, slots=args.slots, seq_capacity=64,
                      device=device)
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        # the JAX launcher's draws, in its order: the length, a VLM's
        # vision embeddings or an encoder-decoder's frame embeddings, then
        # the prompt
        plen = int(rng.integers(2, 12))
        extras = {}
        if cfg.family == "vlm":
            extras["vision_embeds"] = rng.standard_normal(
                (cfg.n_vis, cfg.d_model)).astype(np.float32) * 0.1
        if cfg.family == "audio":
            extras["enc_embeds"] = rng.standard_normal(
                (cfg.enc_seq, cfg.d_model)).astype(np.float32) * 0.1
        reqs.append(Request(rid=i,
                            prompt=rng.integers(0, cfg.vocab_size, plen),
                            max_new_tokens=args.max_new, extras=extras))
    done = srv.serve(reqs)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt_len={len(r.prompt)} -> {r.output}")
    print(f"server.tokens_out {srv.tokens_out}")
    print(f"server.requests {srv.requests}")
    print(f"server.decode_steps {srv.decode_steps}")
    print(f"server.tokens_per_decode_step {srv.tokens_per_decode_step}")
    print(f"server.latency_mean_s {float(np.mean(srv.latency))}")


if __name__ == "__main__":
    main()
