"""The ranks' side of ``tests/test_torch_mesh_gloo.py``: each function
runs on every one of 4 gloo ranks of the CPU inside one process group
(``_worker`` is the spawned entry).  PyTorch and the port only: the
parent process holds the results against the JAX package.
"""

import dataclasses
import datetime
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import REGISTRY, get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist.sharding import MeshSharder, make_rules
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models.common import leaves, leaves_with_path, map_leaves
from repro_torch.models.layers import cross_entropy, padded_vocab
from repro_torch.train import (TrainOptions, build_train_step,
                               init_train_state, lr_at, train_state_specs)
from repro_torch.train.step import loss_and_grads

ARCHS = sorted(REGISTRY)
# kv heads that do not divide "model": the decode rules split the cache
# along its slots ("kv_seq")
KV_SEQ_ARCHS = ("deepseek-67b", "qwen2-vl-7b")
KV_SEQ_STEPS = 8
TRAIN_ARCHS = ("stablelm-1.6b", "olmoe-1b-7b")
# decode with the cache laid out as the dry run's decode batch (every
# leaf's leading dim, the layers, split over "data"): a causal LM, an
# MoE, RWKV's states and whisper's self and cross caches
LAYER_SPLIT_ARCHS = ("stablelm-1.6b", "olmoe-1b-7b", "rwkv6-7b",
                     "whisper-small")
LAYER_SPLIT_STEPS = 3
# context-parallel prefill: the rules' mapping overridden as the JAX dry
# run's ``rules_override`` does, query rows over "model" and no heads
# split (a causal LM, one with a vision prefix, and an encoder-decoder
# whose encoder and cross attention are not causal)
Q_SEQ_ARCHS = ("stablelm-1.6b", "qwen2-vl-7b", "whisper-small")
Q_SEQ_RULES = {"heads": None, "kv_heads": None, "kv_heads_c": None,
               "q_seq": ("model",)}
# smoke mixtral with its experts whole: "model" splits the expert
# weights' d_ff ("mlp") instead, as the production rules do where the
# experts do not divide the model axis
D_FF_ARCH, D_FF_RULES = "mixtral-8x22b", {"experts": None}
STACKS = ("layers", "enc_layers", "dec_layers")
# the loss alone on logits laid out as ``unembed`` lays them out, by
# vocab size: one that "model" splits (smoke's 256), one it splits with
# padding (254, padded to 256) and one it does not split (255, padded to
# 256: whole on every rank)
XENT_VOCABS = (256, 254, 255)
RESTORE_MESHES = ((4, 1), (1, 4))
WORLD = 4
B, S, CAP = 2, 16, 20            # batch, prompt length, cache capacity
TRAIN_B = 4
LOGIT_TOL = 1e-5                 # of the largest logit, f32


def _case(results, name, fn, *args):
    try:
        results[name] = fn(*args)
    except Exception:                              # noqa: BLE001
        results[name] = {"error": traceback.format_exc()}


def _batch(cfg, b, s, seed, train=False):
    g = torch.Generator().manual_seed(seed)
    s_text = s - (cfg.n_vis if cfg.family == "vlm" else 0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s_text),
                                     generator=g)}
    if train:
        batch["labels"] = torch.randint(0, cfg.vocab_size, (b, s),
                                        generator=g)
        batch["mask"] = torch.ones(b, s)
    if cfg.family == "vlm":
        batch["vision_embeds"] = 0.1 * torch.randn(b, cfg.n_vis, cfg.d_model,
                                                   generator=g)
    if cfg.family == "audio":
        batch["enc_embeds"] = 0.1 * torch.randn(b, cfg.enc_seq, cfg.d_model,
                                                generator=g)
    return batch


def _sharder(cfg, mesh, b, s, kind, rules_override=None):
    rules = make_rules(cfg, ShapeConfig("gloo", s, b, kind), mesh)
    rules.mapping.update(rules_override or {})
    return MeshSharder(mesh, rules)


def _rel(got, want):
    return float((got.full_tensor() - want).abs().max()
                 / want.abs().max())


def _serve(arch, mesh, rules_override=None):
    """Prefill and one decode step, sharded against plain; under
    ``rules_override``, the dim that each mesh dim splits of the stacked
    expert weights ``wi`` and ``wo`` (None: replicated)."""
    cfg = smoke(get_config(arch))
    model = build_model(cfg, torch.float32)
    params = model.init(0, "cpu")
    sh = _sharder(cfg, mesh, B, S, "prefill", rules_override)
    dparams = sh.distribute(params, sh.param_shardings(model.param_specs()[1]))
    batch = _batch(cfg, B, S, 1)
    tok = torch.randint(0, cfg.vocab_size, (B, 1),
                        generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want, cache = model.prefill(params, batch, seq_capacity=CAP)
        got, dcache = model.prefill(dparams, batch, seq_capacity=CAP,
                                    sharder=sh)
        want_d, _ = model.decode(params, {"tokens": tok}, cache, S)
        got_d, _ = model.decode(dparams, {"tokens": tok}, dcache, S,
                                sharder=sh)
    ffn = dparams["layers"]["ffn"] if rules_override else {}
    return {"prefill": _rel(got, want), "decode": _rel(got_d, want_d),
            "dtensor": type(got).__name__,
            "placements": [str(p) for p in got.placements],
            "experts": {n: [p.dim if p.is_shard() else None
                            for p in ffn[n].placements]
                        for n in ("wi", "wo") if n in ffn}}


def _serve_q_seq(arch, mesh):
    """A prefill under context-parallel rules (``Q_SEQ_RULES``) against
    the unsharded port, on both attention paths: the plain one (the CPU's)
    and the kernel path, run here on the CPU: ``layers.PLAIN_DEVICES``
    emptied, ``layers.flash_attention`` the op on checked inputs
    (``run_op``), and the op given the plain version with its
    ``q_offset`` as its CPU implementation for the test's scope.  On the
    kernel path x's rows are laid out by "q_seq" before the q
    projection and each rank's op call gets its rows' offset; the op's
    calls and their local q rows are recorded."""
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.models import layers as ll
    cfg = smoke(get_config(arch))
    model = build_model(cfg, torch.float32)
    params = model.init(0, "cpu")
    sh = _sharder(cfg, mesh, B, S, "prefill")
    sh.rules.mapping.update(Q_SEQ_RULES)
    dparams = sh.distribute(params, sh.param_shardings(model.param_specs()[1]))
    batch = _batch(cfg, B, S, 1)
    calls = []

    def impl(q, k, v, causal, window, prefix, q_offset=0):
        calls.append((tuple(q.shape), tuple(k.shape), bool(causal),
                      int(q_offset)))
        return fo.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, prefix=prefix,
                                        q_offset=q_offset)
    with torch.no_grad():
        want, _ = model.prefill(params, batch, seq_capacity=CAP)
        plain, _ = model.prefill(dparams, batch, seq_capacity=CAP,
                                 sharder=sh)
        saved = ll.PLAIN_DEVICES, ll.flash_attention
        ll.PLAIN_DEVICES, ll.flash_attention = (), fo.run_op
        try:
            with torch.library._scoped_library("repro_torch", "IMPL") as lib:
                lib.impl("flash_attention", impl, "CPU")
                kern, _ = model.prefill(dparams, batch, seq_capacity=CAP,
                                        sharder=sh)
        finally:
            ll.PLAIN_DEVICES, ll.flash_attention = saved
    mine = {"plain": _rel(plain, want), "kernel": _rel(kern, want),
            "calls": calls, "coordinate": list(mesh.get_coordinate())}
    ranks = [None] * WORLD
    dist.all_gather_object(ranks, mine)
    return {"ranks": ranks, "n_heads": cfg.n_heads,
            "family": cfg.family}


def _serve_kv_seq(arch, mesh):
    """Prefill and KV_SEQ_STEPS decode steps under the decode rules of a
    cache of CAP slots, against plain: the cache is split along its
    slots, and the steps write past the prefill into the ring buffer's
    wrap (slots 16-19, then 0-3: both ranks' ranges)."""
    cfg = smoke(get_config(arch))
    model = build_model(cfg, torch.float32)
    params = model.init(0, "cpu")
    sh = _sharder(cfg, mesh, B, CAP, "decode")
    dparams = sh.distribute(params, sh.param_shardings(model.param_specs()[1]))
    batch = _batch(cfg, B, S, 1)
    g = torch.Generator().manual_seed(2)
    toks = [torch.randint(0, cfg.vocab_size, (B, 1), generator=g)
            for _ in range(KV_SEQ_STEPS)]
    with torch.no_grad():
        want, cache = model.prefill(params, batch, seq_capacity=CAP)
        got, dcache = model.prefill(dparams, batch, seq_capacity=CAP,
                                    sharder=sh)
        split_dims = [p.dim for p in dcache["k"].placements if p.is_shard()]
        errs = [_rel(got, want)]
        for i, tok in enumerate(toks):
            want, cache = model.decode(params, {"tokens": tok}, cache, S + i)
            got, dcache = model.decode(dparams, {"tokens": tok}, dcache,
                                       S + i, sharder=sh)
            errs.append(_rel(got, want))
        cache_err = max(float((dcache[n].full_tensor() - cache[n]).abs().max())
                        for n in ("k", "v"))
    return {"rules_kv_seq": sh.rules.mapping["kv_seq"],
            "cache_split_dims": split_dims, "errs": errs,
            "cache_err": cache_err}


def _decode_layer_split(arch, mesh, b=B):
    """A plain prefill, its cache laid out by ``batch_shardings`` under
    the decode rules of a batch of ``B`` (the layers split over "data")
    and LAYER_SPLIT_STEPS decode steps against the unsharded port: each
    step's logits, whether each step returned its cache argument, and
    the cache after the steps.  ``b`` = 3 does not divide the 2 ranks of
    "data": each layer then moves whole to every rank."""
    cfg = smoke(get_config(arch))
    model = build_model(cfg, torch.float32)
    params = model.init(0, "cpu")
    sh = _sharder(cfg, mesh, B, CAP, "decode")
    dparams = sh.distribute(params, sh.param_shardings(model.param_specs()[1]))
    batch = _batch(cfg, b, S, 1)
    g = torch.Generator().manual_seed(2)
    toks = [torch.randint(0, cfg.vocab_size, (b, 1), generator=g)
            for _ in range(LAYER_SPLIT_STEPS)]
    with torch.no_grad():
        _, cache = model.prefill(params, batch, seq_capacity=CAP)
        dcache = sh.distribute(cache, sh.batch_shardings(cache))
        split = sorted({str(x.placements) for x in leaves(dcache)})
        errs, returned = [], []
        for i, tok in enumerate(toks):
            want, cache = model.decode(params, {"tokens": tok}, cache, S + i)
            got, out = model.decode(dparams, {"tokens": tok}, dcache, S + i,
                                    sharder=sh)
            errs.append(_rel(got, want))
            returned.append(out is dcache)
        cache_err = max(float((d.full_tensor() - c).abs().max())
                        for d, c in zip(leaves(dcache), leaves(cache)))
    return {"placements": split, "errs": errs, "returned": returned,
            "cache_err": cache_err}


def _xent(vocab, mesh):
    """``cross_entropy`` (masked) on DTensor logits laid out by the train
    rules of smoke stablelm with ``vocab``, against plain tensors: the
    loss and the logits' gradient, relative to their largest values, and
    each rank's local logits' width."""
    cfg = dataclasses.replace(smoke(get_config("stablelm-1.6b")),
                              vocab_size=vocab)
    vp = padded_vocab(cfg)
    sh = _sharder(cfg, mesh, TRAIN_B, S, "train")
    g = torch.Generator().manual_seed(vocab)
    logits = 3.0 * torch.randn(TRAIN_B, S, vp, generator=g)
    batch = {"labels": torch.randint(0, vocab, (TRAIN_B, S), generator=g),
             "mask": (torch.rand(TRAIN_B, S, generator=g) > 0.25).float()}
    x = logits.clone().requires_grad_()
    want = cross_entropy(x, batch["labels"], cfg, batch["mask"])
    want.backward()
    dbatch = sh.distribute(batch, sh.batch_shardings(batch))
    with sh.scope():
        dx = sh.ac(logits, ("batch", None, "vocab")).detach()
        dx.requires_grad_()
        got = cross_entropy(dx, dbatch["labels"], cfg, dbatch["mask"])
        got.backward()
    return {"loss": abs(float(got.full_tensor()) - float(want))
            / abs(float(want)),
            "grad": _rel(dx.grad, x.grad),
            "local_vocab": dx.to_local().shape[-1], "padded_vocab": vp,
            "vocab_split": sh.axis_size("vocab")}


def _loss_grads(arch, mesh, dtype=torch.float32):
    """``loss_and_grads`` of smoke ``arch`` in ``dtype`` on DTensor params
    and batch (the train rules) against plain tensors: the loss relative
    to itself;
    the gradients' largest difference relative to the largest gradient
    (``grad``), as the logits' check does; the unembedding leaf's (the
    head, or the tied table), where the loss's gradient enters the
    model, relative to its own largest value (``unembed``); and the leaf
    whose difference is largest relative to its own largest value
    (``worst_leaf``)."""
    cfg = smoke(get_config(arch))
    model = build_model(cfg, dtype)
    opts = TrainOptions(warmup=0, total_steps=10)
    sh = _sharder(cfg, mesh, TRAIN_B, S, "train")
    params = init_train_state(model, 0, opts, "cpu")["params"]
    dparams = sh.distribute(params,
                            sh.param_shardings(model.param_specs()[1]))
    batch = _batch(cfg, TRAIN_B, S, 3, train=True)
    dbatch = sh.distribute(batch, sh.batch_shardings(batch))
    grads, loss, _ = loss_and_grads(model, opts, params, batch)
    with sh.scope():
        dgrads, dloss, _ = loss_and_grads(model, opts, dparams, dbatch, sh)
    diffs = {path: (float((dg.full_tensor() - g).abs().max()),
                    float(g.abs().max()))
             for (path, dg), g in zip(leaves_with_path(dgrads),
                                      leaves(grads))}

    def rel(d, top):
        return d / top if top else (0.0 if d == 0 else float("inf"))
    top = max(t for _, t in diffs.values())
    worst = max(diffs, key=lambda p: rel(*diffs[p]))
    return {"loss": abs(float(dloss.full_tensor()) - float(loss))
            / abs(float(loss)),
            "grad": max(d for d, _ in diffs.values()) / top,
            "unembed": rel(*diffs["embed/table" if cfg.tie_embeddings
                                  else "embed/head"]),
            "worst_leaf": [worst, rel(*diffs[worst])],
            "vocab_split": sh.axis_size("vocab")}


def _grads_and_compress(model, opts, sh, axes, dstate, dbatch):
    """The gradients of the sharded state as they leave autograd: for
    each stacked leaf, whether it has its param's placements (a
    ``Partial`` where the param is replicated).  Then ``compress_
    gradients`` on them laid out like the params, with an error buffer
    drawn from a seed in the same layout, against the replicated path
    (``blocks_stay_local`` off) bit for bit, and the collectives the
    compress issues for the leaves whose blocks stay local (none
    expected); the paths of the leaves that do not."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.optim import compress
    params = dstate["params"]
    with sh.scope():
        grads, _, _ = loss_and_grads(model, opts, params, dbatch, sh)
    stacked = {}
    for (path, g), p in zip(leaves_with_path(grads), leaves(params)):
        if set(path.split("/")) & set(STACKS):
            stacked[path] = all(
                gp == pp or (pp == Replicate() and gp.is_partial())
                for gp, pp in zip(g.placements, p.placements))
    grads = map_leaves(sh.ac, grads, axes["params"])
    gen = torch.Generator().manual_seed(5)
    err = map_leaves(lambda g, a: sh.ac(1e-3 * torch.randn(
        g.shape, generator=gen), a), grads, axes["params"])
    local = [(path, compress.blocks_stay_local(g.shape, g.placements))
             for path, g in leaves_with_path(grads)]
    keep = [i for i, (_, ok) in enumerate(local) if ok]
    gl, el = list(leaves(grads)), list(leaves(err))
    with CommDebugMode() as comm:
        deq_l, err_l = compress.compress_gradients(
            tuple(gl[i] for i in keep), tuple(el[i] for i in keep))
    deq, new_err = compress.compress_gradients(grads, err)
    saved = compress.blocks_stay_local
    compress.blocks_stay_local = lambda *a, **k: False
    try:
        deq_r, err_r = compress.compress_gradients(grads, err)
    finally:
        compress.blocks_stay_local = saved

    def pick(tree):
        flat = list(leaves(tree))
        return tuple(flat[i] for i in keep)

    def same(a, b):
        return all(torch.equal(x.full_tensor(), y.full_tensor())
                   for x, y in zip(leaves(a), leaves(b)))
    return {"stacked_placements": stacked,
            "bit_equal": same(deq, deq_r) and same(new_err, err_r),
            "local_bit_equal": same(deq_l, pick(deq_r))
            and same(err_l, pick(err_r)),
            "placements_kept": all(
                d.placements == g.placements and e.placements == g.placements
                for d, e, g in zip(pick(deq), pick(new_err), pick(grads))),
            "local_comms": comm.get_total_counts(),
            "n_local": len(keep),
            "replicated": [p for p, ok in local if not ok]}


def _train(arch, mesh, out: Path):
    """One train step with grad_compress on DTensor state against the
    plain step; stablelm's sharded state is then saved from the mesh.
    Before the step, the gradients and the compress of the sharded
    state (``_grads_and_compress``)."""
    cfg = smoke(get_config(arch))
    model = build_model(cfg, torch.float32)
    opts = TrainOptions(grad_compress=True, warmup=0, total_steps=10)
    sh = _sharder(cfg, mesh, TRAIN_B, S, "train")
    _, axes = train_state_specs(model, opts)
    ref = init_train_state(model, 0, opts, "cpu")
    dstate = sh.distribute(init_train_state(model, 0, opts, "cpu"),
                           sh.param_shardings(axes))
    batch = _batch(cfg, TRAIN_B, S, 3, train=True)
    dbatch = sh.distribute(batch, sh.batch_shardings(batch))
    grads = _grads_and_compress(model, opts, sh, axes, dstate, dbatch)
    lr0 = float(lr_at(opts, torch.zeros((), dtype=torch.int32)))
    ref, rm = build_train_step(model, opts)(ref, batch)
    dstate, dm = build_train_step(model, opts, sh, axes["params"])(dstate,
                                                                   dbatch)

    def diffs(key):
        d = torch.cat([(a.full_tensor() - b).abs().flatten()
                       for a, b in zip(leaves(dstate[key]),
                                       leaves(ref[key]))])
        return float(d.max()), float((d > 1e-5).float().mean())

    err_step = max(float(e.abs().max()) for e in leaves(ref["err"])) * 2
    res = {"loss": float(rm["loss"]), "loss_sharded":
           float(dm["loss"].full_tensor()), "lr0": lr0,
           "params": diffs("params"), "err": diffs("err"),
           "err_step": err_step, "grads": grads,
           "param_types": sorted({type(p).__name__
                                  for p in leaves(dstate["params"])})}
    if arch == "stablelm-1.6b":
        CheckpointManager(str(out / "ckpt_mesh"), async_save=False).save(
            dstate, 1)
        full = map_leaves(lambda x: x.detach().full_tensor(), dstate)
        if dist.get_rank() == 0:
            CheckpointManager(str(out / "ckpt_plain"),
                              async_save=False).save(full, 1)
        dist.barrier()
    return res


def _save_fails(mesh, out: Path):
    """A distributed save whose write fails on rank 0 (a file stands where
    its staging directory goes), async and sync: every rank's outcome,
    gathered for rank 0."""
    state = {"w": distribute_tensor(torch.arange(16.0).reshape(4, 4), mesh,
                                    [Shard(0), Shard(1)])}
    res = {}
    for mode in ("async", "sync"):
        d = out / f"ckpt_fail_{mode}"
        if dist.get_rank() == 0:
            d.mkdir()
            (d / "step_00000001.tmp").write_text("not a directory")
        dist.barrier()
        mgr = CheckpointManager(str(d), async_save=mode == "async")
        try:
            mgr.save(state, 1)
            mgr.wait()
            outcome = None
        except Exception as e:                     # noqa: BLE001
            outcome = f"{type(e).__name__}: {e}"
        outcomes = [None] * WORLD
        dist.all_gather_object(outcomes, outcome)
        res[mode] = {"outcomes": outcomes,
                     "published": mgr.available_steps()}
    return res


def _jax_logits(mesh, out: Path):
    """smoke stablelm's sharded prefill on params drawn by the JAX
    package (converted by the parent), for the parent to hold against
    JAX."""
    cfg = smoke(get_config("stablelm-1.6b"))
    model = build_model(cfg, torch.float32)
    params = torch.load(out / "stablelm_params.pt")
    tokens = torch.load(out / "stablelm_tokens.pt")
    sh = _sharder(cfg, mesh, B, S, "prefill")
    dparams = sh.distribute(params, sh.param_shardings(model.param_specs()[1]))
    with torch.no_grad():
        logits, _ = model.prefill(dparams, {"tokens": tokens}, sharder=sh)
    full = logits.full_tensor()
    if dist.get_rank() == 0:
        torch.save(full, out / "stablelm_logits.pt")
    return {"shape": list(full.shape)}


def _restore(ckdir: Path, dest, train_opts):
    """Restore ``ckdir`` onto a ``dest`` mesh: each leaf's full tensor
    against the plain restore, bit for bit, and the rank's local shard
    against its slice of it."""
    cfg = smoke(get_config("stablelm-1.6b"))
    specs, axes = train_state_specs(build_model(cfg, torch.float32),
                                    TrainOptions(**train_opts))
    mesh = make_mesh(dest, ("data", "model"), "cpu")
    sh = _sharder(cfg, mesh, TRAIN_B, S, "train")
    mgr = CheckpointManager(str(ckdir))
    got = mgr.restore(specs, shardings=sh.param_shardings(axes))
    want = mgr.restore(specs, device="cpu")
    bad, sharded = [], 0
    for (key, a), b in zip(leaves_with_path(got), leaves(want)):
        grad = a.requires_grad == b.requires_grad
        a = a.detach()
        full = a.full_tensor()
        shape, offset = compute_local_shape_and_global_offset(
            full.shape, a.device_mesh, a.placements)
        piece = b.detach()[tuple(slice(o, o + n)
                                 for o, n in zip(offset, shape))]
        local = a.to_local()
        sharded += tuple(local.shape) != tuple(full.shape)
        if not (isinstance(a, DTensor) and full.dtype == b.dtype
                and torch.equal(full, b.detach())
                and torch.equal(local, piece) and grad):
            bad.append(key)
    return {"bad": bad, "leaves": len(list(leaves(want))),
            "sharded_leaves": sharded}


def _ops(mesh):
    """Each kernel op's DTensor strategy on the (2, 2) mesh.  The ops have
    no CPU implementation; here each gets one for the test's scope that
    records the local shapes it is called with and computes the plain
    version.  Per layout: the output's placements, the local shapes the
    op saw (the rank's shards, or the whole tensors where the strategy
    replicates), and the full result against the plain version."""
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.kernels.moe_mlp import ops as mo
    from repro_torch.kernels.quantize import ops as qo
    from repro_torch.kernels.quantize.ref import quantize_plain
    from repro_torch.kernels.rwkv6_wkv import ops as wo
    seen = []

    def spy(fn):
        def impl(*args):
            seen.append([tuple(a.shape) for a in args
                         if isinstance(a, torch.Tensor)])
            return fn(*args)
        return impl

    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g)

    r, s0, s1, s2 = Replicate(), Shard(0), Shard(1), Shard(2)
    q, k, v = rand(4, 8, 8, 16), rand(4, 8, 4, 16), rand(4, 8, 4, 16)
    x, wi, wg, wo_ = (rand(4, 4, 3, 32), rand(4, 32, 128), rand(4, 32, 128),
                      rand(4, 128, 32))
    rows = rand(8, 256)
    rr, kk, vv = rand(4, 8, 4, 16), rand(4, 8, 4, 16), rand(4, 8, 4, 16)
    lw, u, st = -torch.rand(4, 8, 4, 16, generator=g), rand(4, 16), \
        rand(4, 4, 16, 16)
    def rows_op(q, k, v, c, w, p):
        return fo.flash_attention_rows(q, k, v, causal=c, window=w,
                                       prefix=p)

    cases = {
        # name: (op, args, per-arg placements, want out placements)
        "flash batch": (fo.OP, (q, k, v, True, 0, 0),
                        [(s0, r)] * 3, [(s0, r)]),
        # 4 kv heads over 4 ranks: the heads split is offered and kept
        "flash heads": (fo.OP, (q, k, v, True, 0, 0),
                        [(r, s2)] * 3, [(r, s2)]),
        "flash batch+heads": (fo.OP, (q, k, v, False, 0, 0),
                              [(s0, s2)] * 3, [(s0, s2)]),
        "moe groups": (mo.OP, (x, wi, wg, wo_),
                       [(s0, r)] + [(r, r)] * 3, [(s0, r)]),
        "moe experts": (mo.OP, (x, wi, wg, wo_),
                        [(s0, s1)] + [(r, s0)] * 3, [(s0, s1)]),
        # each rank's slice of d_ff: a partial sum over "model"
        "moe d_ff": (mo.OP, (x, wi, wg, wo_),
                     [(s0, r), (r, s2), (r, s2), (r, s1)],
                     [(s0, Partial())]),
        # context parallelism: q's rows split over "model", every key on
        # each rank; each rank's call gets its rows' offset
        "flash q_seq": (rows_op, (q, k, v, True, 0, 0),
                        [(s0, s1), (s0, r), (s0, r)], [(s0, s1)]),
        "quantize rows": (qo.OP, (rows,), [(s0, s0)], [(s0, s0)] * 2),
        "wkv6 batch": (wo.OP, (rr, kk, vv, lw, u, st, 32),
                       [(s0, r)] * 4 + [(r, r), (s0, r)],
                       [(s0, r), (s0, r)]),
        "wkv6 heads": (wo.OP, (rr, kk, vv, lw, u, st, 32),
                       [(r, s2)] * 4 + [(r, s0), (r, s1)],
                       [(r, s2), (r, s1)]),
    }
    plain = {"flash_attention": lambda q, k, v, c, w, p, o=0:
             fo.flash_attention_plain(q, k, v, causal=c, window=w, prefix=p,
                                      q_offset=o),
             "expert_mlp": mo.expert_mlp_plain,
             "quantize_blocks": quantize_plain,
             "wkv6": lambda r_, k_, v_, lw_, u_, s_, c:
             wo.wkv6_state_plain(r_, k_, v_, lw_, u_, s_)}
    out = {}
    with torch.library._scoped_library("repro_torch", "IMPL") as lib:
        for name, fn in plain.items():
            lib.impl(name, spy(fn), "CPU")
        for name, (op, args, pls, want_pls) in cases.items():
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            dargs, it = [], iter(pls)
            for a in args:
                dargs.append(distribute_tensor(a, mesh, next(it))
                             if isinstance(a, torch.Tensor) else a)
            got = op(*dargs)
            want = ("flash_attention" if op is rows_op
                    else op.name().split("::")[1])
            want = plain[want](*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            local = [tuple(d.to_local().shape) for d in dargs
                     if isinstance(d, torch.Tensor)]
            out[name] = {
                "placements": [tuple(o.placements) == w
                               for o, w in zip(got, want_pls)],
                "local_shapes": seen[-1] == local,
                "sharded": local != [tuple(t.shape) for t in tensors],
                "equal": [bool(torch.equal(o.full_tensor(), w))
                          for o, w in zip(got, want)],
                "rel": [_rel(o, w) for o, w in zip(got, want)]}
    return out


def _worker(rank, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = Path(out)
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        results = {}
        t0 = time.perf_counter()
        for arch in ARCHS:
            _case(results, f"serve/{arch}", _serve, arch, mesh)
        _case(results, f"serve_d_ff/{D_FF_ARCH}", _serve, D_FF_ARCH, mesh,
              D_FF_RULES)
        for arch in Q_SEQ_ARCHS:
            _case(results, f"q_seq/{arch}", _serve_q_seq, arch, mesh)
        for arch in KV_SEQ_ARCHS:
            _case(results, f"kv_seq/{arch}", _serve_kv_seq, arch, mesh)
        for arch in LAYER_SPLIT_ARCHS:
            _case(results, f"layer_split/{arch}", _decode_layer_split, arch,
                  mesh)
        _case(results, "layer_split_whole/stablelm-1.6b", _decode_layer_split,
              "stablelm-1.6b", mesh, 3)
        for arch in TRAIN_ARCHS:
            _case(results, f"train/{arch}", _train, arch, mesh, out)
        for vocab in XENT_VOCABS:
            _case(results, f"xent/{vocab}", _xent, vocab, mesh)
        for arch in ARCHS:
            _case(results, f"loss/{arch}", _loss_grads, arch, mesh)
        _case(results, "loss64/rwkv6-7b", _loss_grads, "rwkv6-7b", mesh,
              torch.float64)
        _case(results, "jax_logits", _jax_logits, mesh, out)
        _case(results, "save_fails", _save_fails, mesh, out)
        _case(results, "ops", _ops, mesh)
        for dest in RESTORE_MESHES:
            _case(results, f"restore_mesh/{dest}", _restore,
                  out / "ckpt_mesh", dest,
                  {"grad_compress": True})
            _case(results, f"restore_jax/{dest}", _restore,
                  out / "ckpt_jax", dest,
                  {"grad_compress": True, "moment_dtype": "bfloat16"})
        results["seconds"] = time.perf_counter() - t0
        if rank == 0:
            torch.save(results, out / "results.pt")
    finally:
        dist.destroy_process_group()
