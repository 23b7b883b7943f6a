"""Context parallelism on each rank's rows: where the rules split the
query rows over "model" ("q_seq", the heads left whole), the q, k and v
projections run on the rank's rows in prefill and in training (k and v
then gathered over the rows), forward and backward, and where the vocab
is whole the unembedding and the loss run on the rank's rows too.

* On a (2, 2) mesh of PyTorch's fake process group, smoke stablelm's
  train step and prefill under ``Q_SEQ_RULES``: every projection dot of
  the costed stream, counted by its rows.  Its d_ff is set to 160 so
  that no MLP dot has a projection's shape.  With its vocab whole too,
  neither makes a ``_StridedShard`` from the model code (torch 2.11
  refuses the views that would).
* On 4 gloo ranks of the CPU, a (2, 2) mesh (one ``torch.multiprocessing``
  spawn for the file; the ranks' code is ``tests/_cp_gloo_worker.py``):
  the train gradients of smoke stablelm, qwen2-vl, whisper and minicpm
  under ``Q_SEQ_RULES``, the vocab split and whole, against the
  unsharded port; and sharded prefills' stacked caches, written layer by
  layer, against ``torch.stack`` of the layers' entries on DTensors.

JAX's per-device flops of the same smoke cells are held in
``tests/test_torch_dryrun.py`` (its module-scoped JAX subprocess).
"""

import collections
import dataclasses
import time
import traceback

import pytest
import torch
import torch.multiprocessing as mp
from torch.distributed.tensor import placement_types

import _cp_gloo_worker as cw
import _mesh_gloo_worker as gw
from repro_torch.configs import SHAPES, get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import op_cost
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_mesh

TIMEOUT_S = 240
# smoke stablelm: d_model 64 = 4 heads x 16, 4 layers; at 48 tokens a
# sequence the train cell's 4 sequences a "data" rank are 192 rows, 96 a
# "model" rank, the prefill's 2 sequences 96 and 48
ROWS_CELLS = {"train_4k": (48, 8), "prefill_32k": (48, 4)}
D_FF = 160


def _projection_dots(name, monkeypatch):
    """The costed stream's dots shaped as an attention projection of
    smoke stablelm (d_model = heads x head_dim = 64), by rows: forward
    and input-gradient dots (rows, 64) x (64, 64) under "rows", weight
    gradients (64, rows) x (rows, 64) under "weight"."""
    cfg = dataclasses.replace(smoke(get_config("stablelm-1.6b")), d_ff=D_FF)
    d = cfg.d_model
    assert cfg.n_heads * cfg.head_dim == d == 64
    shape = ShapeConfig(name, *ROWS_CELLS[name], SHAPES[name].kind)
    monkeypatch.setattr(dr, "get_config", lambda a: cfg)
    monkeypatch.setattr(dr, "SHAPES", {**SHAPES, name: shape})
    dots = collections.Counter()
    cost = op_cost.op_cost

    def spy(func, args, kwargs, out):
        if func.overloadpacket in op_cost._DOTS:
            a, b = (tuple(t.shape) for t in op_cost._tensors(args)[:2])
            if a[-1] == b[-2] == b[-1] == d:
                dots["rows", a[-2]] += 1
            elif a[-2] == b[-1] == d and a[-1] == b[-2]:
                dots["weight", a[-1]] += 1
        return cost(func, args, kwargs, out)
    monkeypatch.setattr(op_cost, "op_cost", spy)
    dev = dr.default_device(shape.kind)
    with dr.fake_process_group(4, 3):
        mesh = make_mesh((2, 2), ("data", "model"), dev)
        res = dr.dryrun_cell("stablelm-1.6b", name, mesh=mesh, device=dev,
                             rules_override=gw.Q_SEQ_RULES)
    assert res["status"] == "ok", res.get("error")
    assert res["rules"]["q_seq"] == ["model"] and res["rules"]["heads"] is None
    return cfg, dict(dots)


def test_train_projections_run_on_the_ranks_rows(monkeypatch):
    """The train step (each layer checkpointed): q, k and v's forward,
    recomputed forward and input-gradient dots on the rank's 96 rows
    (9 a layer) and their weight gradients contracting those rows (3 a
    layer); only the output projection runs on the 192 rows of the
    rank's batch (forward, recomputed forward and its input's gradient,
    and its weight's gradient), as JAX's dots of this layout do.  Each
    projection ran on all 192 rows before (12 and 4 a layer)."""
    cfg, dots = _projection_dots("train_4k", monkeypatch)
    n = cfg.n_layers
    assert dots == {("rows", 96): 9 * n, ("rows", 192): 3 * n,
                    ("weight", 96): 3 * n, ("weight", 192): n}, dots


def test_prefill_projections_run_on_the_ranks_rows(monkeypatch):
    """The prefill (the kernel path, fake CUDA tensors): q, k and v on the
    rank's 48 rows, the output projection on the 96 rows of its batch, as
    in JAX's dots (q alone ran on the rank's rows before)."""
    cfg, dots = _projection_dots("prefill_32k", monkeypatch)
    n = cfg.n_layers
    assert dots == {("rows", 48): 3 * n, ("rows", 96): n}, dots


@pytest.mark.parametrize("name", list(ROWS_CELLS))
def test_context_parallel_cells_make_no_strided_shard(monkeypatch, name):
    """torch 2.11's DTensor (the card's) refuses a view that merges two
    dims split over two mesh dims, where 2.13 makes a ``_StridedShard``:
    smoke stablelm's train step and prefill under ``Q_SEQ_RULES``, its
    vocab whole (the unembedding on the rows too), make none from the
    model code (each such product runs on the local shards).  Before the
    unembedding's product ran on them, the train step made some, and the
    card's matrix failed minicpm-2b's and whisper-small's train cells."""
    made = []
    init = placement_types._StridedShard.__init__

    def spy(self, *args, **kwargs):
        if any("repro_torch/models" in f.filename
               for f in traceback.extract_stack()):
            made.append(traceback.format_stack(limit=6))
        return init(self, *args, **kwargs)
    monkeypatch.setattr(placement_types._StridedShard, "__init__", spy)
    shape = ShapeConfig(name, *ROWS_CELLS[name], SHAPES[name].kind)
    monkeypatch.setattr(dr, "get_config",
                        lambda a: smoke(get_config("stablelm-1.6b")))
    monkeypatch.setattr(dr, "SHAPES", {**SHAPES, name: shape})
    dev = dr.default_device(shape.kind)
    with dr.fake_process_group(4, 3):
        mesh = make_mesh((2, 2), ("data", "model"), dev)
        res = dr.dryrun_cell("stablelm-1.6b", name, mesh=mesh, device=dev,
                             rules_override={**gw.Q_SEQ_RULES,
                                             "vocab": None})
    assert res["status"] == "ok", res.get("error")
    assert made == [], "".join(made[0])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the 4 ranks once; rank 0's results."""
    out = tmp_path_factory.mktemp("cp_gloo")
    ctx = mp.start_processes(cw._worker, args=(str(out / "store"), str(out)),
                             nprocs=cw.WORLD, start_method="spawn",
                             join=False)
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo ranks did not finish in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return torch.load(out / "results.pt")


def _ok(res, name):
    r = res[name]
    assert "error" not in r, f"{name}:\n{r['error']}"
    return r


@pytest.mark.parametrize("vocab", list(cw.VOCAB_RULES))
@pytest.mark.parametrize("arch", cw.TRAIN_ARCHS)
def test_context_parallel_train_gradients_match_unsharded(run, arch, vocab):
    """Under ``Q_SEQ_RULES`` (the query rows over "model", 2 ranks), the
    loss within 1e-5 of itself and every gradient within 1e-5 of the
    largest gradient of the unsharded port, as
    ``tests/test_torch_mesh_gloo.py`` holds the train rules' (seen
    ~6e-7).  Before the q, k and v projections' weights and the
    attention cores' keys and values took a partial-sum gradient
    (``per_shard``), each rank's gradient of a tensor left whole over the
    split rows held only its own rows' share: 0.45-0.80 of the largest
    gradient off."""
    r = _ok(run, f"train/{arch}/{vocab}")
    assert r["q_seq"] == 2, r
    assert r["vocab_split"] == (2 if vocab == "split" else 1), r
    assert r["loss"] <= 1e-5, r
    assert r["grad"] <= 1e-5, r


@pytest.mark.parametrize("arch,kind", [(a, "q_seq" if r else "prefill")
                                       for a, r in cw.STACK_CELLS])
def test_stacked_cache_is_the_stack_of_the_layers_entries(run, arch, kind):
    """A sharded prefill's stacked cache, written layer by layer on each
    rank's local shards, has the placements ``torch.stack`` of the
    layers' DTensor entries gives and equals it bit for bit, every leaf
    (the hybrid's per-position stacks, whisper's self and cross
    caches)."""
    r = _ok(run, f"stack/{arch}/{kind}")
    assert r["leaves"] >= 2, r
    assert r["placements"] and r["equal"], r
    assert r["split"], r
