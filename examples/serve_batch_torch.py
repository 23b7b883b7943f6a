"""Batched serving of the PyTorch port: the run of
``examples/serve_batch.py`` on ``repro_torch``.

Continuous batching over mixed-length requests on ``smoke(mixtral-8x22b)``
(MoE and a sliding window) through the port's ``BatchServer``, then a
check that request 0's batched output equals a sequential greedy
prefill-and-decode through the port's own steps.  On the card the
prefill runs the flash attention kernel (windowed) and every prefill and
decode step the moe_mlp kernel: it prints their launches in the batched
run and fails if either kernel never ran there.

Run on the card: PYTHONPATH=src python examples/serve_batch_torch.py
On the CPU, add:  --cpu

Nothing here imports JAX or the ``repro`` package.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, smoke
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.moe_mlp.ops import expert_mlp
from repro_torch.models import build_model
from repro_torch.serve import (BatchServer, Request, build_decode_step,
                               build_prefill_step)

CAP = 48


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card; raises "
                         "without one)")
    device = resolve_device("cpu" if ap.parse_args(argv).cpu else None)

    cfg = smoke(get_config("mixtral-8x22b"))      # MoE + sliding window
    model = build_model(cfg)
    params = model.init(0, device)

    srv = BatchServer(model, params, slots=3, seq_capacity=CAP,
                      device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(2, 10))),
                    max_new_tokens=6) for i in range(7)]
    flash_attention.launches = expert_mlp.launches = 0
    done = srv.serve(reqs)
    launches = {"flash_attention": flash_attention.launches,
                "moe_mlp": expert_mlp.launches}
    if device.type == "cuda":
        assert all(launches.values()), launches

    # request 0 again, alone: one prefill, then one-token decode steps
    req = next(r for r in done if r.rid == 0)
    prefill = build_prefill_step(model, seq_capacity=CAP)
    decode = build_decode_step(model)
    with torch.no_grad():
        logits, cache = prefill(srv.params, {"tokens": torch.as_tensor(
            req.prompt[None], dtype=torch.int64, device=device)})
        toks = [int(torch.argmax(logits[0, -1].float()))]
        cur = len(req.prompt)
        while len(toks) < len(req.output):
            nxt, _, cache = decode(srv.params, {
                "tokens": torch.tensor([[toks[-1]]], device=device),
                "cache": cache,
                "cur_len": torch.tensor([cur], device=device)})
            toks.append(int(nxt[0, 0]))
            cur += 1
    assert req.output == toks, (req.output, toks)
    print(f"served {len(done)} requests, {srv.tokens_out} tokens, "
          f"{srv.tokens_per_decode_step:.2f} tokens/decode-step "
          f"on {device}; kernel launches {launches}")
    print("batched output == sequential greedy decode for request 0")
    print("serve_batch OK")


if __name__ == "__main__":
    main()
