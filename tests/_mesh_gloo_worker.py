"""The ranks' side of ``tests/test_torch_mesh_gloo.py``: each function
runs on every one of 4 gloo ranks of the CPU inside one process group
(``_worker`` is the spawned entry).  PyTorch and the port only: the
parent process holds the results against the JAX package.
"""

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
from repro_torch.train import (TrainOptions, build_train_step,
                               init_train_state, lr_at, train_state_specs)

ARCHS = sorted(REGISTRY)
# kv heads that do not divide "model": the decode rules split the cache
# along its slots ("kv_seq")
KV_SEQ_ARCHS = ("deepseek-67b", "qwen2-vl-7b")
KV_SEQ_STEPS = 8
TRAIN_ARCHS = ("stablelm-1.6b", "olmoe-1b-7b")
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


def _sharder(cfg, mesh, b, s, kind):
    return MeshSharder(mesh, make_rules(cfg, ShapeConfig("gloo", s, b, kind),
                                        mesh))


def _rel(got, want):
    return float((got.full_tensor() - want).abs().max()
                 / want.abs().max())


def _serve(arch, mesh):
    """Prefill and one decode step, sharded against plain."""
    cfg = smoke(get_config(arch))
    model = build_model(cfg, torch.float32)
    params = model.init(0, "cpu")
    sh = _sharder(cfg, mesh, B, S, "prefill")
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
    return {"prefill": _rel(got, want), "decode": _rel(got_d, want_d),
            "dtensor": type(got).__name__,
            "placements": [str(p) for p in got.placements]}


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


def _train(arch, mesh, out: Path):
    """One train step with grad_compress on DTensor state against the
    plain step; stablelm's sharded state is then saved from the mesh."""
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
           "err_step": err_step,
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
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
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
        "quantize rows": (qo.OP, (rows,), [(s0, s0)], [(s0, s0)] * 2),
        "wkv6 batch": (wo.OP, (rr, kk, vv, lw, u, st, 32),
                       [(s0, r)] * 4 + [(r, r), (s0, r)],
                       [(s0, r), (s0, r)]),
        "wkv6 heads": (wo.OP, (rr, kk, vv, lw, u, st, 32),
                       [(r, s2)] * 4 + [(r, s0), (r, s1)],
                       [(r, s2), (r, s1)]),
    }
    plain = {"flash_attention": lambda q, k, v, c, w, p:
             fo.flash_attention_plain(q, k, v, causal=c, window=w, prefix=p),
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
            want = op.name().split("::")[1]
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
                          for o, w in zip(got, want)]}
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
        for arch in KV_SEQ_ARCHS:
            _case(results, f"kv_seq/{arch}", _serve_kv_seq, arch, mesh)
        for arch in TRAIN_ARCHS:
            _case(results, f"train/{arch}", _train, arch, mesh, out)
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
