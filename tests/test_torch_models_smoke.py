"""Per-arch smoke tests of the port, the twin of
``tests/test_models_smoke.py``: every arch of the registry, at its smoke
config on the CPU, computes finite train logits of the right shape,
takes a train step with a finite loss, and decodes after a prefill what
its train logits give.  PyTorch only (no JAX), and quick: eager PyTorch
compiles nothing.

The decode check uses the JAX test's bound: the prefill's and the decode
step's logits lie within 8% of the largest logit of the train logits at
the same positions (bf16 numerics and MoE capacity drops, which differ
between a whole sequence and a single token)."""

import numpy as np
import pytest
import torch

from repro_torch.configs import REGISTRY, get_config, smoke
from repro_torch.models import build_model
from repro_torch.models.layers import padded_vocab
from repro_torch.train import TrainOptions, build_train_step, init_train_state

B, S = 2, 32


def make_batch(cfg, seed: int = 0, kind: str = "train"):
    """Tokens (a VLM's ``S - n_vis`` of them) and its stub frontend's
    embeddings; a train batch adds labels (drawn apart from the tokens)
    and a mask over all ``S`` positions."""
    gen = torch.Generator().manual_seed(seed)
    s_text = S - (cfg.n_vis if cfg.family == "vlm" else 0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, s_text),
                                     generator=gen)}
    if kind == "train":
        batch["labels"] = torch.randint(0, cfg.vocab_size, (B, S),
                                        generator=gen)
        batch["mask"] = torch.ones(B, S)
    if cfg.family == "vlm":
        batch["vision_embeds"] = 0.1 * torch.randn(
            B, cfg.n_vis, cfg.d_model, generator=gen)
    if cfg.family == "audio":
        batch["enc_embeds"] = 0.1 * torch.randn(
            B, cfg.enc_seq, cfg.d_model, generator=gen)
    return batch


@pytest.fixture(scope="module", params=sorted(REGISTRY))
def arch(request):
    cfg = smoke(get_config(request.param))
    model = build_model(cfg)
    return cfg, model, model.init(0, "cpu")


def test_forward_shapes_no_nans(arch):
    cfg, model, params = arch
    with torch.no_grad():
        logits, aux = model.train_logits(params, make_batch(cfg))
    assert logits.shape == (B, S, padded_vocab(cfg))
    assert not bool(torch.isnan(logits.float()).any())
    assert not bool(torch.isnan(aux).any())


def test_one_train_step(arch):
    cfg, model, _ = arch
    opts = TrainOptions(peak_lr=1e-3, warmup=2, total_steps=10, chunk=16)
    state = init_train_state(model, 0, opts, "cpu")
    p0 = next(iter(state["params"]["embed"].values())).detach().clone()
    step = build_train_step(model, opts)
    batch = make_batch(cfg)
    state, metrics = step(state, batch)          # step 0: lr == 0 (warmup)
    state, metrics = step(state, batch)          # step 1: lr > 0
    assert float(metrics["loss"]) > 0
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert int(state["step"]) == 2
    p1 = next(iter(state["params"]["embed"].values()))
    assert not torch.allclose(p0, p1.detach())


def test_prefill_decode_consistency(arch):
    """Decode after a prefill of all but the last token matches the
    teacher-forced train logits at the last two positions."""
    cfg, model, params = arch
    batch = make_batch(cfg, seed=1, kind="prefill")
    toks = batch["tokens"]
    with torch.no_grad():
        full, _ = model.train_logits(params, batch)
        served = model.load(params, "cpu")
        pl, cache = model.prefill(served, dict(batch, tokens=toks[:, :-1]),
                                  seq_capacity=S)
        dl, _ = model.decode(served, {"tokens": toks[:, -1:]}, cache, S - 1)
    f = full.float()
    scale = float(f[:, -2:].abs().max()) + 1e-9
    err_p = float((pl.float()[:, 0] - f[:, -2]).abs().max())
    err_d = float((dl.float()[:, 0] - f[:, -1]).abs().max())
    assert err_p / scale < 0.08, err_p / scale
    assert err_d / scale < 0.08, err_d / scale
