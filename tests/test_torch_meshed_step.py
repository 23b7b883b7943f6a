"""The dry run of meshed smoke steps on a (2, 2) mesh of PyTorch's fake
process group: where the port's train and decode steps hold what XLA's
compiled step does not.

* olmoe's train step: the MoE combine gather runs on each rank's groups
  and its share of d_model (``models.moe._combine`` under
  ``layers.per_shard``), so no op of the costed stream, its backward's
  zero gradient included, holds the micro-batch's global group count,
  as DTensor's own gather backward makes that gradient.
* a train step's gradients are laid out like the params and summed into
  the accumulator leaf by leaf (``train.step._accumulate``), each leaf
  freed once added.
* a decode step whose cache's layers are split over "data" (the dry
  run's decode batch, ``batch_shardings``): each layer's slice moves to
  the batch split when the loop reaches it (``MeshSharder.
  decode_layer``) and the step returns its cache argument.  Its own
  bytes (outputs and temps beside the arguments) at 8 layers are those
  at 2.
"""

import dataclasses
import math

import torch

from repro_torch.configs import SHAPES, get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import op_cost
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import map_leaves


def _cell(monkeypatch, cfg, name, seq_batch, device, param_dtype=None):
    shape = ShapeConfig(name, *seq_batch, SHAPES[name].kind)
    monkeypatch.setattr(dr, "get_config", lambda a: cfg)
    monkeypatch.setattr(dr, "SHAPES", {**SHAPES, name: shape})
    with dr.fake_process_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device)
        res = dr.dryrun_cell(cfg.name, name, mesh=mesh, device=device,
                             serve_param_dtype=param_dtype)
    assert res["status"] == "ok", res.get("error")
    return res


def _shapes_of_stream(monkeypatch):
    """``op_cost.op_cost`` spied on: the output shapes of every costed op,
    in order."""
    seen = []
    real = op_cost.op_cost

    def spy(func, args, kwargs, out):
        seen.extend(tuple(t.shape) for t in op_cost._tensors(out))
        return real(func, args, kwargs, out)
    monkeypatch.setattr(op_cost, "op_cost", spy)
    return seen


def test_moe_combine_backward_keeps_the_group_split(monkeypatch):
    """smoke olmoe's train step at one layer (batch 4 of 32 tokens): each
    micro-batch of 4 / accum rows is as many groups, 2 ranks of "data"
    holding half each.  Every op of the costed stream with an output of
    the combine gather's operand's shape (G, E C, *) has the rank's G /
    2 groups, and the rank's share of d_model, (G / 2, E C, D / 2), is
    among them (DTensor's own gather on the global tensors makes its
    backward's zero gradient at the global G)."""
    cfg = dataclasses.replace(smoke(get_config("olmoe-1b-7b")), n_layers=1)
    seq, batch = 32, 4
    seen = _shapes_of_stream(monkeypatch)
    res = _cell(monkeypatch, cfg, "train_4k", (seq, batch), "cpu")
    g = batch // res["options"]["accum_steps"]
    k, e = cfg.top_k, cfg.n_experts
    c = min(max(1, math.ceil(k * seq * cfg.capacity_factor / e)), seq * k)
    groups = [s[0] for s in seen if len(s) == 3 and s[1] == e * c]
    assert g >= 2 and groups and set(groups) == {g // 2}, groups
    assert (g // 2, e * c, cfg.d_model // 2) in seen
    assert res["replicated_kernels"] == {}


def _decode_memory(monkeypatch, n_layers):
    cfg = dataclasses.replace(smoke(get_config("olmoe-1b-7b")),
                              n_layers=n_layers)
    res = _cell(monkeypatch, cfg, "decode_32k", (32, 4), "cuda",
                torch.bfloat16)
    mem = res["memory"]
    own = mem["per_device_total"] - mem["argument_bytes"]
    return res, own


def test_decode_moves_one_layer_and_returns_its_cache(monkeypatch):
    """smoke olmoe's decode step (batch 4, a 32-slot cache, bf16 params,
    so that no cast of them grows with the depth) at 2 and 8 layers:
    the cache's layers split over "data" (1 of 2, 4 of 8 a rank), its bytes all aliased by the outputs (the step returns its
    argument), the step's own bytes the same at both depths, two
    all-to-alls a layer and leaf (the layer out, the new rows back), no
    leaf moved whole (a move of every leaf whole before the loop would
    add the moved cache's local bytes, growing with the depth)."""
    shallow, own2 = _decode_memory(monkeypatch, 2)
    deep, own8 = _decode_memory(monkeypatch, 8)
    cfg = smoke(get_config("olmoe-1b-7b"))
    # a rank's layers of k and v: (L / 2, 4, kvh, 32, hd) each, bf16
    layer = 4 * cfg.n_kv_heads * 32 * cfg.head_dim * 2
    for res, n in ((shallow, 2), (deep, 8)):
        assert res["memory"]["alias_bytes"] == 2 * (n // 2) * layer
        assert res["collectives"]["all-to-all"]["count"] == 2 * 2 * n
        assert res["whole_stacked_moves"] == []
    assert own8 == own2, (own2, own8)


def test_gradients_are_laid_out_and_summed_leaf_by_leaf():
    """``train.step._accumulate`` on a tree of dicts and a tuple of
    dicts (a hybrid arch's layers): the sum of the accumulator and the
    laid-out gradients, bit for bit that of laying out the whole tree
    and adding; each gradient leaf is freed once laid out and added, so
    that the layout of leaf k sees only leaves k, k + 1, ... alive."""
    import weakref
    from repro_torch.models.common import leaves
    from repro_torch.train.step import _accumulate
    g = torch.Generator().manual_seed(0)

    def tree():
        return {"embed": {"table": torch.randn(6, 4, generator=g)},
                "layers": ({"w": torch.randn(3, 4, generator=g)},
                           {"w": torch.randn(3, 4, generator=g),
                            "b": torch.randn(4, generator=g)})}
    acc, grads = tree(), tree()
    want = map_leaves(lambda a, x: a + 2 * x, acc, grads)
    refs = [weakref.ref(x) for x in leaves(grads)]
    alive = []

    class Doubling:
        """A sharder whose layout doubles a leaf and counts the gradient
        leaves alive."""

        def ac(self, x, axes):
            alive.append(sum(r() is not None for r in refs))
            return 2 * x
    axes = map_leaves(lambda _: ("embed",), acc)
    got = _accumulate(acc, grads, axes, Doubling())
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))
    assert alive == [4, 3, 2, 1]
    assert grads == {} and acc == {}
