"""The ranks' side of ``tests/test_torch_cp_rows.py``: each function runs
on every one of 4 gloo ranks of the CPU on a (2, 2) ("data", "model")
mesh (``_worker`` is the spawned entry).  PyTorch and the port only.
"""

import datetime
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

import _mesh_gloo_worker as gw
from repro_torch.configs import get_config, smoke
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model, encdec, transformer
from repro_torch.models.common import leaves, leaves_with_path
from repro_torch.train import TrainOptions, init_train_state
from repro_torch.train.step import loss_and_grads

WORLD = gw.WORLD
# context-parallel train cells: a causal LM, one with a vision prefix, an
# encoder-decoder (its encoder's 16 frames split too) and minicpm (tied
# embeddings, its residual scale); each with the vocab split over
# "model" and with it whole (the logits then laid out by the rows)
TRAIN_ARCHS = ("stablelm-1.6b", "qwen2-vl-7b", "whisper-small", "minicpm-2b")
VOCAB_RULES = {"split": {}, "whole": {"vocab": None}}
# prefills whose stacked cache is written layer by layer on DTensors: a
# dense LM under the prefill rules and under context-parallel ones, an
# encoder-decoder (self and cross caches) and the hybrid (a tuple of
# per-position stacks)
STACK_CELLS = (("stablelm-1.6b", {}), ("stablelm-1.6b", gw.Q_SEQ_RULES),
               ("whisper-small", gw.Q_SEQ_RULES), ("jamba-v0.1-52b", {}))


def _train_grads(arch, vocab, mesh):
    """``loss_and_grads`` of smoke ``arch`` in f32 on DTensor params and
    batch under ``gw.Q_SEQ_RULES`` (and ``VOCAB_RULES[vocab]``) against
    plain tensors: the loss relative to itself, the gradients' largest
    difference relative to the largest gradient, the leaf whose
    difference is largest relative to its own largest value."""
    cfg = smoke(get_config(arch))
    model = build_model(cfg, torch.float32)
    opts = TrainOptions(warmup=0, total_steps=10)
    sh = gw._sharder(cfg, mesh, gw.TRAIN_B, gw.S, "train",
                     {**gw.Q_SEQ_RULES, **VOCAB_RULES[vocab]})
    params = init_train_state(model, 0, opts, "cpu")["params"]
    dparams = sh.distribute(params,
                            sh.param_shardings(model.param_specs()[1]))
    batch = gw._batch(cfg, gw.TRAIN_B, gw.S, 3, train=True)
    dbatch = sh.distribute(batch, sh.batch_shardings(batch))
    grads, loss, _ = loss_and_grads(model, opts, params, batch)
    with sh.scope():
        dgrads, dloss, _ = loss_and_grads(model, opts, dparams, dbatch, sh)
    diffs = {path: (float((dg.full_tensor() - g).abs().max()),
                    float(g.abs().max()))
             for (path, dg), g in zip(leaves_with_path(dgrads),
                                      leaves(grads))}
    top = max(t for _, t in diffs.values())
    worst = max(diffs, key=lambda p: diffs[p][0] / (diffs[p][1] or 1.0))
    return {"loss": abs(float(dloss.full_tensor()) - float(loss))
            / abs(float(loss)),
            "grad": max(d for d, _ in diffs.values()) / top,
            "worst_leaf": [worst, diffs[worst][0] / (diffs[worst][1]
                                                     or 1.0)],
            "q_seq": sh.axis_size("q_seq"),
            "vocab_split": sh.axis_size("vocab")}


def _stack(arch, rules, mesh):
    """A sharded prefill whose ``_stack_layer`` is spied on: each layer's
    entry kept, and the stacked cache it returns held against
    ``torch.stack`` of those entries (the replaced formula) on DTensors:
    the same placements, and full tensors equal bit for bit."""
    cfg = smoke(get_config(arch))
    model = build_model(cfg, torch.float32)
    params = model.init(0, "cpu")
    sh = gw._sharder(cfg, mesh, gw.B, gw.S, "prefill", rules)
    dparams = sh.distribute(params, sh.param_shardings(model.param_specs()[1]))
    batch = gw._batch(cfg, gw.B, gw.S, 1)
    entries = {}
    real = transformer._stack_layer

    def spy(stacked, i, n, entry):
        out = real(stacked, i, n, entry)
        if isinstance(out, torch.Tensor):
            entries.setdefault(id(out), []).append(entry)
        return out
    transformer._stack_layer = encdec._stack_layer = spy
    try:
        with torch.no_grad():
            _, cache = model.prefill(dparams, batch, seq_capacity=gw.CAP,
                                     sharder=sh)
    finally:
        transformer._stack_layer = encdec._stack_layer = real
    out = {"leaves": 0, "placements": True, "equal": True, "split": False}

    def walk(stacked):
        if isinstance(stacked, dict):
            for v in stacked.values():
                walk(v)
            return
        want = torch.stack(entries[id(stacked)])
        out["leaves"] += 1
        out["placements"] &= (isinstance(stacked, DTensor)
                              and tuple(stacked.placements)
                              == tuple(want.placements))
        out["equal"] &= bool(torch.equal(stacked.full_tensor(),
                                         want.full_tensor()))
        out["split"] |= any(p.is_shard() for p in stacked.placements)
    for tree in (cache if isinstance(cache, tuple) else (cache,)):
        walk(tree)
    return out


def _worker(rank, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        results = {}
        t0 = time.perf_counter()
        for arch in TRAIN_ARCHS:
            for vocab in VOCAB_RULES:
                gw._case(results, f"train/{arch}/{vocab}", _train_grads,
                         arch, vocab, mesh)
        for arch, rules in STACK_CELLS:
            kind = "q_seq" if rules else "prefill"
            gw._case(results, f"stack/{arch}/{kind}", _stack, arch, rules,
                     mesh)
        results["seconds"] = time.perf_counter() - t0
        if rank == 0:
            torch.save(results, Path(out) / "results.pt")
    finally:
        dist.destroy_process_group()
