"""Two layouts of the port's meshed and serving steps, held against what
XLA's compiled step holds.

* olmoe's train step on the fake (2, 2) mesh: the expert down projection
  runs on each rank's experts (``models.moe``: h back to the experts'
  split after its "mlp" layout), so the expert outputs are split by E
  and reach the combine's d_model split by one move; no all-reduce has
  the whole capacity blocks (G, E, C, D) as its operand (before, the
  down projection contracted h's d_ff split and left the whole blocks a
  partial sum, all-reduced at the "moe_d" constraint).
* prefill and decode on f32 params cast where XLA's compiled form does
  (``transformer.lm_apply``, ``encdec.encdec_apply``): the gathered rows
  of the token table, each layer's leaves in the layer loop, the weight
  the unembedding projects by, so no bf16 copy of the whole table is
  alive at a prefill's peak; the values are the cast-first order's, bit
  for bit.  Train mode keeps the cast-first order (the embedding
  gradient's scatter-add runs in bf16, as in JAX).
* a norm where autograd records nothing runs its f32 chain in place on
  one copy of x (``layers._norm_in_place``): the recorded chain's bits.
"""

import dataclasses
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import REGISTRY, SHAPES, get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import op_cost
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models import layers as ll
from repro_torch.models.common import cast, leaves, map_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cell(monkeypatch, cfg, name, seq_batch, device):
    shape = ShapeConfig(name, *seq_batch, SHAPES[name].kind)
    monkeypatch.setattr(dr, "get_config", lambda a: cfg)
    monkeypatch.setattr(dr, "SHAPES", {**SHAPES, name: shape})
    with dr.fake_process_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device)
        res = dr.dryrun_cell(cfg.name, name, mesh=mesh, device=device)
    assert res["status"] == "ok", res.get("error")
    return res


def test_olmoe_train_step_reduces_no_whole_capacity_blocks(monkeypatch):
    """smoke olmoe's train step at one layer (batch 2 of 128 tokens) on
    the fake (2, 2) mesh, its 4 experts and d_ff split over "model":
    every collective's operand is recorded from ``CostMode``'s moves (by
    shape: a CPU mesh all-gathers where a CUDA mesh does an all-to-all).
    No all-reduce has the capacity blocks' (E, C, D) whole, for any
    count of groups; the expert outputs leave the rank split by E, a
    rank's (G / 2, E / 2, C, D).  At 128 tokens a rank's h (C = 80 rows
    an expert) outweighs its share of wo (D = 64 columns), as at full
    width, so that DTensor's own choice for the down projection moves
    wo to h's d_ff split and leaves the blocks a partial sum (at 32
    tokens it moves h instead)."""
    cfg = dataclasses.replace(smoke(get_config("olmoe-1b-7b")), n_layers=1)
    seq, batch = 128, 2
    moved = []
    real = op_cost.CostMode._move

    def spy(mode, func, args, out):
        if func.namespace in op_cost.COLLECTIVE_NAMESPACES:
            moved.append((op_cost.collective_kind(func),
                          tuple(op_cost._tensors(args[:1])[0].shape)))
        return real(mode, func, args, out)
    monkeypatch.setattr(op_cost.CostMode, "_move", spy)
    res = _cell(monkeypatch, cfg, "train_4k", (seq, batch), "cpu")
    g = batch // res["options"]["accum_steps"]
    k, e, d = cfg.top_k, cfg.n_experts, cfg.d_model
    c = min(max(1, math.ceil(k * seq * cfg.capacity_factor / e)), seq * k)
    whole = [m for m in moved
             if m[0] == "all-reduce" and m[1][1:] == (e, c, d)]
    assert moved and whole == [], whole
    assert ("all-gather", (g // 2, e // 2, c, d)) in moved, sorted(set(moved))
    assert res["replicated_kernels"] == {}


@pytest.mark.parametrize("arch", ["stablelm-1.6b"])
def test_prefill_holds_no_whole_cast_table_at_its_peak(monkeypatch, arch):
    """smoke ``arch``'s prefill (batch 2 of 32 tokens) on f32 params, on
    the fake (2, 2) mesh on fake CUDA tensors: of the storage alive at
    its peak (``tools/peak_live.py``), none has the token table's shape
    in bf16 (the cast-first order held a bf16 copy of every leaf, the
    table among them, through the whole forward)."""
    cfg = smoke(get_config(arch))
    table = tuple(build_model(cfg).param_specs()[0]["embed"]["table"].shape)
    with _tool("peak_live")._PeakLive() as tr:
        _cell(monkeypatch, cfg, "prefill_32k", (32, 2), "cuda")
    live = [tag for _, tag in tr.live.values() if tag]
    assert live
    assert not [t for t in live if t[1] == table and t[2] == "bfloat16"], live


def _batch(model, kind: str, seq: int, b: int, seed: int):
    """A batch of ``model.input_specs``' keys drawn with numpy from
    ``seed``: tokens (and labels) from the first 16 ids, so that rows of
    the table repeat, the mask ones, stub embeddings in bf16."""
    rng = np.random.default_rng(seed)
    specs = model.input_specs(ShapeConfig("t", seq, b, kind))
    out = {}
    for k, s in specs.items():
        if not s.dtype.is_floating_point:
            out[k] = torch.from_numpy(rng.integers(0, 16, s.shape)).to(
                s.dtype)
        elif k == "mask":
            out[k] = torch.ones(s.shape, dtype=s.dtype)
        else:
            out[k] = torch.from_numpy(rng.standard_normal(s.shape).astype(
                np.float32)).to(s.dtype)
    return out


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


# an arch of each path that casts in its own place: dense decoders
# (stablelm; minicpm's tied table; nemotron's sq-ReLU), MoE, RWKV, the
# hybrid's per-position stacks, the vision prefix, the encoder-decoder
@pytest.mark.parametrize("arch", sorted(set(REGISTRY) - {
    "deepseek-67b", "mixtral-8x22b"}))
def test_prefill_and_decode_match_the_cast_first_order(arch):
    """smoke ``arch``: a prefill (batch 2 of 16 tokens, capacity 20) and
    two decode steps on its f32 params give logits and caches bit for
    bit those of the same calls on the params cast to bf16 first."""
    cfg = smoke(get_config(arch))
    model = build_model(cfg)
    params = model.init(3, device="cpu")
    first = cast(params, BF16)
    batch = _batch(model, "prefill", 16, 2, 0)
    runs = []
    with torch.no_grad():
        for p in (params, first):
            logits, cache = model.prefill(p, batch, seq_capacity=20)
            steps = [logits]
            for t in range(2):
                tok = {"tokens": torch.full((2, 1), 5 + t, dtype=torch.int32)}
                logits, cache = model.decode(p, tok, cache, 16 + t)
                steps.append(logits)
            runs.append((tuple(steps), cache))
    (got, got_cache), (want, want_cache) = runs
    assert _equal(got, want) and _equal(got_cache, want_cache)
    assert all(torch.isfinite(x.float()).all() for x in got)


@pytest.mark.parametrize("arch", ["minicpm-2b", "whisper-small"])
def test_train_gradients_match_the_cast_first_order(arch):
    """smoke ``arch``'s train logits (batch 2 of 16 tokens, token ids
    repeating) on f32 params: the loss and every f32 gradient bit for
    bit those of casting the params to bf16 first, under autograd (the
    embedding gradient summed over repeated ids in bf16, as in JAX)."""
    from repro_torch.models.layers import cross_entropy
    cfg = smoke(get_config(arch))
    model = build_model(cfg)
    params = map_leaves(lambda x: x.requires_grad_(x.is_floating_point()),
                        model.init(4, device="cpu"))
    batch = _batch(model, "train", 16, 2, 1)
    out = []
    for first in (False, True):
        p = cast(params, BF16) if first else params
        logits, aux = model.train_logits(p, batch)
        loss = cross_entropy(logits, batch["labels"], cfg,
                             mask=batch.get("mask")) + 0.01 * aux
        grads = torch.autograd.grad(loss, list(leaves(params)),
                                    allow_unused=True,
                                    materialize_grads=True)
        out.append((loss.detach(), grads))
    (loss, grads), (want_loss, want) = out
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    assert all(g.dtype == torch.float32 for g in grads)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_in_place_matches_the_recorded_chain(norm):
    """``apply_norm`` under ``no_grad`` (the chain in place on one f32
    copy) against the same call recorded by autograd (the out-of-place
    chain), bit for bit, on bf16 rows and on f32 rows (whose copy must
    leave x as it was)."""
    cfg = dataclasses.replace(smoke(get_config("stablelm-1.6b")), norm=norm)
    rng = np.random.default_rng(7)
    p = {"scale": torch.from_numpy(rng.standard_normal(64).astype(
        np.float32)).to(BF16),
         "bias": torch.from_numpy(rng.standard_normal(64).astype(
             np.float32)).to(BF16)}
    for dtype in (BF16, torch.float32):
        x = torch.from_numpy(rng.standard_normal((3, 40, 64)).astype(
            np.float32) * 3 + 1).to(dtype)
        before = x.clone()
        with torch.no_grad():
            got = ll.apply_norm(p, x, cfg)
        want = ll.apply_norm(p, x.clone().requires_grad_(), cfg)
        assert want.requires_grad and not got.requires_grad
        assert got.dtype == dtype and torch.equal(got, want.detach())
        assert torch.equal(x, before)


def test_wkv6_plain_scan_backward_takes_each_chunk_once():
    """The plain chunked WKV6 scan (train mode's) on (2, 64, 2, 8) inputs
    in chunks of 8: its backward writes each input's chunk gradients
    into one tensor of the chunked input's shape (the ``unbind``'s
    stack), with no per-chunk ``select_backward`` of that shape and no
    add of two such tensors (before, one ``select_backward`` a chunk
    and 7 adds an input)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models.rwkv import wkv6_chunked_plain
    b, s, h, n, chunk = 2, 64, 2, 8, 8
    whole = (s // chunk, b, chunk, h, n)
    rng = np.random.default_rng(5)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).requires_grad_()
    r, k, v = (draw(b, s, h, n) for _ in range(3))
    lw = (-torch.exp(draw(b, s, h, n))).detach().requires_grad_()
    u, s0 = draw(h, n), draw(b, h, n, n)
    y, state = wkv6_chunked_plain(r, k, v, lw, u, s0, chunk)
    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor) and tuple(out.shape) == whole:
                ops.append(func.__name__)
            return out
    with Record():
        (y.square().sum() + state.square().sum()).backward()
    assert ops.count("stack.default") == 4, ops
    assert "select_backward.default" not in ops and "add.Tensor" not in ops
    assert all(torch.isfinite(x.grad).all() for x in (r, k, v, lw, u, s0))


@pytest.mark.parametrize("by", ["flops", "bytes"])
def test_op_flops_diff_ranks_ops_by_the_change(by):
    """``launch.op_flops.diff`` between two per-op records ranks the ops
    whose flops (or bytes) changed, largest change first, and leaves
    out the ops that did not change."""
    from repro_torch.launch.op_flops import diff
    a = {"flops_per_device": 10.0, "bytes_per_device": 100.0,
         "ops": [["add", 2, 4.0, 60.0], ["mm", 1, 6.0, 40.0]]}
    b = {"flops_per_device": 9.0, "bytes_per_device": 130.0,
         "ops": [["add", 4, 8.0, 120.0], ["mm", 1, 1.0, 10.0]]}
    lines = diff(a, b, by=by)
    assert lines[0].startswith(f"{by} a device")
    if by == "flops":
        assert lines[1].startswith("-5.0000e+00  1 -> 1 calls  mm")
        assert lines[2].startswith("+4.0000e+00  2 -> 4 calls  add")
    else:
        assert lines[1].startswith("+6.0000e+01  2 -> 4 calls  add")
        assert lines[2].startswith("-3.0000e+01  1 -> 1 calls  mm")
    assert len(lines) == 3
