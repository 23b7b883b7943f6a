"""A prefill writes each layer's cache entry into its stacked cache as the
layer returns it (``models.transformer._stack_layer``), as JAX's scan
writes its stacked output, instead of keeping every layer's entry for
one ``torch.stack`` after the last layer, which held the cache twice.

* Plain tensors, every family's smoke model (dense, MoE, RWKV, the
  hybrid's per-position stacks, the VLM, whisper's self and cross
  caches), f32 and bf16: the stacked cache equals ``torch.stack`` of the
  layers' entries bit for bit, each leaf allocated once and written
  layer by layer in order.
* The dry run (PyTorch's fake process group, a (2, 2) mesh, fake CUDA
  tensors, bf16 params) of a smoke prefill at 24 layers: its temp bytes
  are those at 2 layers (one layer's working set and cache entry beside
  the allocated cache); with the replaced formula they grow with the
  depth.

The DTensor path (a stacked cache laid out as the stack of its entries,
written on each rank's shards) is held on 4 gloo ranks in
``tests/test_torch_cp_rows.py``.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import SHAPES, get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model, encdec, transformer
from repro_torch.models.common import leaves

ARCHS = ("stablelm-1.6b", "olmoe-1b-7b", "rwkv6-7b", "jamba-v0.1-52b",
         "qwen2-vl-7b", "whisper-small")
B, S, CAP = 2, 16, 20


def _batch(cfg):
    g = torch.Generator().manual_seed(1)
    s_text = S - (cfg.n_vis if cfg.family == "vlm" else 0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, s_text),
                                     generator=g)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = 0.1 * torch.randn(B, cfg.n_vis, cfg.d_model,
                                                   generator=g)
    if cfg.family == "audio":
        batch["enc_embeds"] = 0.1 * torch.randn(B, cfg.enc_seq, cfg.d_model,
                                                generator=g)
    return batch


def _spy(monkeypatch):
    """``_stack_layer`` wrapped: per stacked leaf (by identity), the layer
    indices written and the entries, in call order."""
    real = transformer._stack_layer
    seen = {}

    def spy(stacked, i, n, entry):
        out = real(stacked, i, n, entry)
        if isinstance(out, torch.Tensor):
            rec = seen.setdefault(id(out), {"leaf": out, "i": [],
                                            "entries": []})
            rec["i"].append(i)
            rec["entries"].append(entry.clone())
        return out
    monkeypatch.setattr(transformer, "_stack_layer", spy)
    monkeypatch.setattr(encdec, "_stack_layer", spy)
    return seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_is_the_stack_of_the_layers_entries(monkeypatch, arch,
                                                          dtype):
    cfg = smoke(get_config(arch))
    model = build_model(cfg, dtype)
    params = model.init(0, "cpu")
    seen = _spy(monkeypatch)
    with torch.no_grad():
        _, cache = model.prefill(params, _batch(cfg), seq_capacity=CAP)
    cached = list(leaves(cache))
    assert len(seen) == len(cached) >= 2
    for leaf in cached:
        rec = seen[id(leaf)]
        n = leaf.shape[0]
        assert rec["leaf"] is leaf and rec["i"] == list(range(n)), rec["i"]
        want = torch.stack(rec["entries"])
        assert leaf.dtype == want.dtype and leaf.shape == want.shape
        assert torch.equal(leaf, want)


def _replaced_formula(monkeypatch):
    """The stack the prefill made before: each layer's entries kept (a
    list a leaf, passed back in as the stacked leaf), and ``torch.stack``
    of them once the last layer has returned."""
    def stack_at_the_end(stacked, i, n, entry):
        if isinstance(entry, dict):
            stacked = stacked or {}
            return {k: stack_at_the_end(stacked.get(k), i, n, v)
                    for k, v in entry.items()}
        entries = (stacked or []) + [entry]
        return torch.stack(entries) if len(entries) == n else entries
    monkeypatch.setattr(transformer, "_stack_layer", stack_at_the_end)
    monkeypatch.setattr(encdec, "_stack_layer", stack_at_the_end)


def _memory(arch, n_layers, monkeypatch):
    cfg = dataclasses.replace(smoke(get_config(arch)), n_layers=n_layers)
    name = "prefill_32k"
    shape = ShapeConfig(name, 256, 4, "prefill")
    monkeypatch.setattr(dr, "get_config", lambda a: cfg)
    monkeypatch.setattr(dr, "SHAPES", {**SHAPES, name: shape})
    with dr.fake_process_group(4, 3):
        mesh = make_mesh((2, 2), ("data", "model"), "cuda")
        res = dr.dryrun_cell(arch, name, mesh=mesh, device="cuda",
                             serve_param_dtype=torch.bfloat16)
    assert res["status"] == "ok", res.get("error")
    return res["memory"]


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "whisper-small"])
def test_dry_run_prefill_holds_its_cache_once(monkeypatch, arch):
    """The temp bytes of a 24-layer prefill are those of a 2-layer one:
    one layer's working set and its entry beside the allocated cache,
    whatever the depth.  The outputs grow by one entry a layer (the
    last position's logits do not); with the replaced formula the temp
    bytes grow with the depth, by 8 entries or more from 2 to 24 layers
    (the cache held twice at the stack)."""
    two = _memory(arch, 2, monkeypatch)
    deep = _memory(arch, 24, monkeypatch)
    entry = (deep["output_bytes"] - two["output_bytes"]) / 22
    assert entry > 0.9 * deep["output_bytes"] / 24
    assert deep["temp_bytes"] <= two["temp_bytes"], (two, deep)
    _replaced_formula(monkeypatch)
    old_two, old = _memory(arch, 2, monkeypatch), _memory(arch, 24,
                                                          monkeypatch)
    assert old["output_bytes"] == deep["output_bytes"]
    assert old["temp_bytes"] >= old_two["temp_bytes"] + 8 * entry, (old_two,
                                                                    old)
