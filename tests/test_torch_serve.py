"""The port's continuous-batching server against the JAX server.

* Same requests, same JAX-initialised parameters: the port's
  ``BatchServer`` takes the same scheduling decisions as
  ``repro.serve.BatchServer`` and, computing in f32, emits the same
  greedy tokens.  The JAX model is wrapped here to compute in f32
  (``lm_apply(..., compute_dtype=jnp.float32)``); both servers keep a
  bf16 cache.
* The port's server emits what its own sequential greedy decode emits
  (prefill, then one-token decode steps on a batch of one).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke as jax_smoke
from repro.models import Model as JaxModel
from repro.models import transformer as jtf
from repro.models.common import IDENTITY_SHARDER
from repro.serve import BatchServer as JaxBatchServer
from repro.serve import Request as JaxRequest
from repro_torch.configs import get_config, smoke
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.serve import BatchServer, Request

PROMPT_LENS = [4, 3, 2, 10, 3]
MAX_NEW = [5, 3, 6, 10, 2]        # request 3 stops at capacity (16 - 1)
SLOTS, CAP = 2, 16


class JaxF32Model(JaxModel):
    def prefill(self, params, batch, sharder=IDENTITY_SHARDER, chunk=2048,
                seq_capacity=0):
        logits, cache, _ = jtf.lm_apply(
            params, batch, self.cfg, sharder, mode="prefill", chunk=chunk,
            seq_capacity=seq_capacity, compute_dtype=jnp.float32)
        return logits, cache

    def decode(self, params, batch, cache, cur_len, sharder=IDENTITY_SHARDER):
        logits, cache, _ = jtf.lm_apply(
            params, batch, self.cfg, sharder, mode="decode", cache=cache,
            cur_len=cur_len, compute_dtype=jnp.float32)
        return logits, cache


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke(jax_get_config("stablelm-1.6b"))
    cfg = smoke(get_config("stablelm-1.6b"))
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(1))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    return jcfg, cfg, jparams, params, prompts


def port_serve(cfg, params, prompts, dtype):
    srv = BatchServer(build_model(cfg, dtype), params, slots=SLOTS,
                      seq_capacity=CAP, device="cpu")
    done = srv.serve([Request(rid=i, prompt=p, max_new_tokens=m)
                      for i, (p, m) in enumerate(zip(prompts, MAX_NEW))])
    return srv, done


def test_server_matches_jax_server_f32(setup):
    jcfg, cfg, jparams, params, prompts = setup
    jsrv = JaxBatchServer(model=JaxF32Model(jcfg), params=jparams,
                          slots=SLOTS, seq_capacity=CAP)
    jsrv.instantiate()
    jdone = jsrv.serve([JaxRequest(rid=i, prompt=p, max_new_tokens=m)
                        for i, (p, m) in enumerate(zip(prompts, MAX_NEW))])
    srv, done = port_serve(cfg, params, prompts, torch.float32)

    assert ([dataclasses.astuple(d) for d in srv.scheduler.decisions]
            == [dataclasses.astuple(d) for d in jsrv.scheduler.decisions])
    assert any(d.reason == "capacity" for d in srv.scheduler.decisions)
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r, jr in zip(done, jdone):
        assert r.output == jr.output, r.rid
    stats = jsrv.stats.flat()
    assert srv.tokens_out == stats["server.tokens_out"]
    assert srv.requests == stats["server.requests"] == len(prompts)
    assert srv.decode_steps == stats["server.decode_steps"]
    assert srv.tokens_per_decode_step == pytest.approx(
        stats["server.tokens_per_decode_step"])
    assert len(srv.latency) == len(prompts)
    assert len(srv.prefill_seconds) == len(prompts)
    assert len(srv.decode_seconds) == srv.decode_steps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_server_matches_sequential_decode(setup, dtype):
    jcfg, cfg, jparams, params, prompts = setup
    _, done = port_serve(cfg, params, prompts, dtype)
    model = build_model(cfg, dtype)
    p = model.load(params, "cpu")
    for req in done:
        logits, cache = model.prefill(
            p, {"tokens": torch.as_tensor(req.prompt)[None]},
            seq_capacity=CAP)
        cache = {n: c.to(torch.bfloat16) for n, c in cache.items()}
        toks = [int(torch.argmax(logits[0, -1].float()))]
        cur = len(req.prompt)
        while len(toks) < len(req.output):
            logits, cache = model.decode(
                p, {"tokens": torch.tensor([[toks[-1]]])}, cache, cur)
            toks.append(int(torch.argmax(logits[0, -1].float())))
            cur += 1
        assert req.output == toks, (req.rid, req.output, toks)
