"""The port's ``Trainer`` (``repro_torch.train.trainer``) against the JAX
package's on the CPU.

* ``run_ft`` on the seeded failure schedules of
  ``tests/test_train_ft_policy.py``: the port's trainer (a torch tiny
  step, real checkpoints on disk), the JAX ``Trainer`` and the
  simulator's ``TrainSim`` give the same decision log, row for row.
* The rewind: a declared pod death restores the last checkpoint and the
  lost step runs again.
* ``run`` with an injected failure on a smoke stablelm-1.6b ends with the
  state of an uninterrupted run, bit for bit (the CPU is deterministic,
  and a restore moves bits).
* A cross-package resume: the JAX ``Trainer`` checkpoints at step 3 and
  the port restores that checkpoint and trains 3 more steps; its losses
  match the JAX run's at ``tests/test_torch_train.py``'s f32 tolerance,
  1e-5 relative (both compute in f32 from the same state and batches;
  they differ by the ulps of other summation orders).
* The stats group: the same names and dump lines as the JAX Trainer's.
* ``examples/train_e2e_torch.py`` at a small size.
"""

import dataclasses
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke as jax_smoke
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.data import SyntheticPipeline as JaxPipeline
from repro.models import api as jax_api
from repro.models import transformer as jtf
from repro.models.common import IDENTITY_SHARDER
from repro.sim import Simulator, TrainSim, TrainStepCost, v5e_unreliable
from repro.train import step as jax_step
from repro.train import trainer as jax_trainer
from repro.train.ft_policy import FailureEvent as JaxFailureEvent
from repro.train.ft_policy import FailureSchedule as JaxFailureSchedule
from repro.train.ft_policy import FTPolicy as JaxFTPolicy
from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticPipeline
from repro_torch.models import build_model
from repro_torch.models.common import leaves, leaves_with_path, map_leaves
from repro_torch.train import (FailureEvent, FailureSchedule, FTPolicy,
                               SimulatedFailure, Trainer, TrainOptions,
                               build_train_step, init_train_state)

ROOT = Path(__file__).resolve().parents[1]
PODS, CHIPS_PER_POD = 4, 16
SEEDS = [7, 21, 1234]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs in parallel workers, one per
    core, and the example's (1024, 32768) logits thrash under eight
    threads a worker (224 s against 14 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# run_ft: the port's trainer, the JAX trainer and TrainSim
# ---------------------------------------------------------------------------

def _policy(policy_cls, cfg, num_steps=60, ckpt_interval=10, **kw):
    return policy_cls(cfg, num_steps=num_steps, ckpt_interval=ckpt_interval,
                      pods=PODS, chips_per_pod=CHIPS_PER_POD, **kw)


def _schedule(schedule_cls, seed, horizon=200):
    return schedule_cls.generate(
        seed=seed, horizon=horizon, pods=PODS, mtbf=40.0,
        straggler_mtbs=60.0, preemption_mtbs=150.0, repair=(10, 40))


class _TinyPipeline:
    """Duck-typed pipeline: deterministic per-step batches, no config."""

    def batch(self, step):
        return {"x": np.full((4,), float(step % 7), np.float32)}


def _tiny_train_step(state, batch):
    params = state["params"] * 0.9 + 0.01 * torch.sum(batch["x"])
    return ({"params": params, "step": state["step"] + 1},
            {"loss": torch.sum(params ** 2)})


def _tiny_state():
    return {"params": torch.ones(4), "step": torch.tensor(0, dtype=torch.int32)}


def _jax_tiny_train_step(state, batch):
    params = state["params"] * 0.9 + 0.01 * jnp.sum(batch["x"])
    return ({"params": params, "step": state["step"] + 1},
            {"loss": jnp.sum(params ** 2)})


def _jax_tiny_state():
    return {"params": jnp.ones((4,), jnp.float32),
            "step": jnp.asarray(0, jnp.int32)}


def _tiny_trainer(ckpt_dir):
    tr = Trainer(model=None, train_step=_tiny_train_step,
                 pipeline=_TinyPipeline(), state=_tiny_state(),
                 ckpt_dir=str(ckpt_dir))
    return tr.instantiate()


def _rows(decisions):
    return [d.to_row() for d in decisions]


@pytest.mark.parametrize("seed", SEEDS)
def test_port_trainer_jax_trainer_and_trainsim_decide_identically(seed,
                                                                  tmp_path):
    cfg, jcfg = get_config("deepseek-67b"), jax_get_config("deepseek-67b")

    port_pol = _policy(FTPolicy, cfg)
    res = _tiny_trainer(tmp_path / "port").run_ft(
        _schedule(FailureSchedule, seed), port_pol)
    assert res["final_step"] == 60           # it really recovered

    jtr = jax_trainer.Trainer(model=None, train_step=_jax_tiny_train_step,
                              pipeline=_TinyPipeline(),
                              state=_jax_tiny_state(),
                              ckpt_dir=str(tmp_path / "jax"))
    jtr.instantiate()
    jax_pol = _policy(JaxFTPolicy, jcfg)
    jres = jtr.run_ft(_schedule(JaxFailureSchedule, seed), jax_pol)

    board = v5e_unreliable(PODS, seed=0, mtbf=0.0, nx=4, ny=4)
    sim_pol = _policy(JaxFTPolicy, jcfg)
    cost = TrainStepCost.from_params(1e9, tokens_per_batch=100_000,
                                     chips=PODS * CHIPS_PER_POD)
    Simulator(board, TrainSim(cost=cost, policy=sim_pol,
                              schedule=_schedule(JaxFailureSchedule, seed))
              ).run_to_completion()

    want = _rows(sim_pol.decisions)
    assert any(r[0] == "checkpoint" for r in want)
    assert _rows(port_pol.decisions) == want == _rows(jax_pol.decisions)
    assert _rows(res["decisions"]) == want
    assert res["attempts"] == jres["attempts"]
    assert [h["step"] for h in res["history"]] == \
        [h["step"] for h in jres["history"]]
    np.testing.assert_allclose([h["loss"] for h in res["history"]],
                               [h["loss"] for h in jres["history"]],
                               rtol=1e-6)


def test_trainer_restores_through_real_checkpoints(tmp_path):
    """The decisions drive real restores: after a rollback the state
    rewinds (history shows the re-run step) and ends at num_steps."""
    sched = FailureSchedule(
        (FailureEvent(15, "pod_failed", pod=1, repair=0),), pods=PODS)
    tr = _tiny_trainer(tmp_path)
    pol = _policy(FTPolicy, get_config("deepseek-67b"), num_steps=30,
                  ckpt_interval=10)
    res = tr.run_ft(sched, pol)
    steps_run = [h["step"] for h in res["history"]]
    assert steps_run.count(14) == 2         # step 14 ran, was lost, re-ran
    assert res["final_step"] == 30
    assert tr.s_failures.value() == 1 and tr.s_stalls.value() >= 1
    assert tr.ckpt.latest_step() == 30      # the final state is on disk


def test_run_ft_requires_a_checkpoint_dir_and_the_policys_start():
    tr = Trainer(model=None, train_step=_tiny_train_step,
                 pipeline=_TinyPipeline(), state=_tiny_state()).instantiate()
    with pytest.raises(ValueError, match="ckpt_dir"):
        tr.run_ft(FailureSchedule((), pods=PODS),
                  _policy(FTPolicy, get_config("deepseek-67b")))


# ---------------------------------------------------------------------------
# run on a smoke model
# ---------------------------------------------------------------------------

SEQ, BATCH = 16, 2


def _smoke_trainer(arch, ckpt_dir, opts, ckpt_interval=2, **kw):
    cfg = smoke(get_config(arch))
    model = build_model(cfg, torch.float32)
    tr = Trainer(model=model, train_step=build_train_step(model, opts),
                 pipeline=SyntheticPipeline(
                     cfg, ShapeConfig("t", SEQ, BATCH, "train"), seed=3),
                 state=init_train_state(model, 1, opts, "cpu"),
                 ckpt_dir=ckpt_dir, ckpt_interval=ckpt_interval,
                 heartbeat_path=(os.path.join(ckpt_dir, "hb.json")
                                 if ckpt_dir else None), **kw)
    return tr.instantiate()


def test_run_with_a_failure_ends_bit_identical_to_an_uninterrupted_run(
        tmp_path):
    opts = TrainOptions(peak_lr=3e-3, warmup=2, total_steps=6,
                        grad_compress=True)
    clean = _smoke_trainer("stablelm-1.6b", None, opts)
    want = clean.run(6)
    tr = _smoke_trainer("stablelm-1.6b", str(tmp_path / "ck"), opts)
    tr.ckpt.keep_n = 1
    got = tr.run(6, fail_at={5: SimulatedFailure("injected")})
    assert got["final_step"] == want["final_step"] == 6
    steps = [h["step"] for h in got["history"]]
    assert steps == [0, 1, 2, 3, 4, 4, 5]     # step 4 replayed from ckpt 4
    assert tr.s_failures.value() == 1 and tr.s_steps.value() == 7
    assert got["history"][4]["loss"] == got["history"][5]["loss"]
    assert [h["loss"] for h in got["history"] if h is not got["history"][4]
            ] == [h["loss"] for h in want["history"]]
    for (k, a), b in zip(leaves_with_path(tr.state), leaves(clean.state)):
        assert torch.equal(a.detach(), b.detach()), k
    assert all(p.requires_grad for p in leaves(tr.state["params"]))
    assert tr.ckpt.available_steps() == [6]   # keep_n = 1
    assert tr.heartbeat.alive(max_age=60)
    restored = tr.ckpt.restore(tr.state)
    for a, b in zip(leaves(restored), leaves(tr.state)):
        assert torch.equal(a.detach(), b.detach())


def test_run_gives_up_after_max_retries(tmp_path):
    opts = TrainOptions(warmup=1, total_steps=4)
    tr = _smoke_trainer("stablelm-1.6b", str(tmp_path), opts, max_retries=0)
    with pytest.raises(SimulatedFailure):
        tr.run(3, fail_at={1: SimulatedFailure("first")})


class JaxModelF32(jax_api.Model):
    """The JAX model with f32 compute in ``train_logits`` (as in
    ``tests/test_torch_train.py``)."""

    def train_logits(self, params, batch, sharder=IDENTITY_SHARDER,
                     chunk=2048):
        logits, _, aux = jtf.lm_apply(params, batch, self.cfg, sharder,
                                      mode="train", chunk=chunk,
                                      compute_dtype=jnp.float32)
        return logits, aux


def test_port_resumes_a_jax_trainer_checkpoint(tmp_path):
    """The JAX Trainer runs 6 steps and checkpoints at step 3; the port
    restores step 3 and runs steps 3-5: the same losses at 1e-5."""
    arch = "stablelm-1.6b"
    opts = TrainOptions(peak_lr=3e-3, warmup=2, total_steps=6,
                        grad_compress=True)
    cfg, jcfg = smoke(get_config(arch)), jax_smoke(jax_get_config(arch))
    model = build_model(cfg, torch.float32)
    start = init_train_state(model, 1, opts, "cpu")
    # the same start in JAX: the port's draw, as arrays in JAX's tree
    jstate = jax.tree.map(jnp.asarray, map_leaves(
        lambda x: x.detach().numpy().copy(), start))
    jopts = jax_step.TrainOptions(**dataclasses.asdict(opts))
    jmodel = JaxModelF32(jcfg)
    jtr = jax_trainer.Trainer(
        model=jmodel, train_step=jax_step.build_train_step(jmodel, jopts),
        pipeline=JaxPipeline(jcfg, JaxShapeConfig("t", SEQ, BATCH, "train"),
                             seed=3),
        state=jstate, ckpt_dir=str(tmp_path), ckpt_interval=3)
    jtr.instantiate()
    jres = jtr.run(6)
    assert 3 in jtr.ckpt.available_steps()

    tr = Trainer(model=model, train_step=build_train_step(model, opts),
                 pipeline=SyntheticPipeline(
                     cfg, ShapeConfig("t", SEQ, BATCH, "train"), seed=3),
                 state=start).instantiate()
    from repro_torch.checkpoint import CheckpointManager
    tr.state = CheckpointManager(str(tmp_path)).restore(start, step=3)
    assert int(tr.state["step"]) == 3
    res = tr.run(3)
    assert res["final_step"] == 6
    got = [h["loss"] for h in res["history"]]
    want = [h["loss"] for h in jres["history"][3:]]
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

def test_stats_group_names_and_dump_match_the_jax_trainer(tmp_path):
    sched = FailureSchedule(
        (FailureEvent(5, "pod_failed", pod=1, repair=0),), pods=PODS)
    tr = _tiny_trainer(tmp_path / "port")
    tr.run_ft(sched, _policy(FTPolicy, get_config("deepseek-67b"),
                             num_steps=12, ckpt_interval=4))
    jtr = jax_trainer.Trainer(model=None, train_step=_jax_tiny_train_step,
                              pipeline=_TinyPipeline(),
                              state=_jax_tiny_state(),
                              ckpt_dir=str(tmp_path / "jax"))
    jtr.instantiate()
    jtr.run_ft(JaxFailureSchedule(
        (JaxFailureEvent(5, "pod_failed", pod=1, repair=0),), pods=PODS),
        _policy(JaxFTPolicy, jax_get_config("deepseek-67b"), num_steps=12,
                ckpt_interval=4))
    flat, jflat = tr.stats.flat(), jtr.stats.flat()
    assert list(flat) == list(jflat)
    assert list(flat) == [f"trainer.{n}" for n in (
        "loss", "steps", "failures", "stragglers", "stalls", "step_time")]
    # stragglers are slow steps on the host's clock: not compared
    for k in ("trainer.steps", "trainer.failures", "trainer.stalls"):
        assert flat[k] == jflat[k], k
    assert flat["trainer.failures"] == 1
    np.testing.assert_allclose(flat["trainer.loss"], jflat["trainer.loss"],
                               rtol=1e-6)
    assert flat["trainer.step_time"]["count"] == \
        jflat["trainer.step_time"]["count"]
    lines = tr.stats.dump_text().splitlines()
    jlines = jtr.stats.dump_text().splitlines()
    assert [ln.split()[0] for ln in lines] == [ln.split()[0] for ln in jlines]
    assert tr.params_dict() == jtr.params_dict()
    assert tr.describe() == jtr.describe()


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------

def test_train_e2e_example_recovers_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "train_e2e_torch", ROOT / "examples" / "train_e2e_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main(["--device", "cpu", "--steps", "6", "--dim", "128",
                    "--ckpt-interval", "2"])
    out = capsys.readouterr().out
    assert "train_e2e OK" in out and "recovered 1 failure" in out
    assert "trainer.failures" in out
    assert res["final_step"] == 6
    steps = [h["step"] for h in res["history"]]
    assert steps == [0, 1, 2, 2, 3, 4, 5]     # step 2 replayed from ckpt 2
    assert res["history"][-1]["loss"] < res["history"][0]["loss"]


def test_train_e2e_example_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    spec = importlib.util.spec_from_file_location(
        "train_e2e_torch", ROOT / "examples" / "train_e2e_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--steps", "2"])
