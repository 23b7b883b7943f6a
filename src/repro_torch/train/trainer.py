"""Trainer of the port: the training loop as a SimObject, as
``repro.train.trainer``.

The trainer is configured like every other component (``Param``s plus
a checkpoint manager, a straggler watchdog and a heartbeat) and exports
a stats group: ``loss``, ``steps``, ``failures``, ``stragglers``,
``stalls`` and the ``step_time`` distribution.  Fault injection for
tests: ``run(n, fail_at={step: SimulatedFailure(...)})`` restores the
latest checkpoint and replays from it; ``run_ft`` hands every recovery
decision to the pure ``FTPolicy`` that the simulator's ``TrainSim``
also drives.

The step is called as it is (the port's step updates params and moments
in place).  A batch goes to the params' device; reading the loss waits
for the step, so a step's time is the device's.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.simobject import Param, SimObject
from repro_torch.models.common import leaves
from repro_torch.train.ft import Heartbeat, StragglerWatchdog
from repro_torch.train.ft_policy import (FailureSchedule, FTPolicy,
                                         checkpoint_due)
from repro_torch.train.step import batch_to


class SimulatedFailure(RuntimeError):
    pass


class Trainer(SimObject):
    ckpt_interval = Param(int, 50, "steps between checkpoints")
    log_interval = Param(int, 10, "steps between metric logs")
    max_retries = Param(int, 3, "restore attempts after failures")

    def __init__(self, name: str = "trainer", *, model, train_step: Callable,
                 pipeline: Any, state: Any,
                 ckpt_dir: Optional[str] = None,
                 heartbeat_path: Optional[str] = None, **kw):
        """``pipeline``: a ``repro_torch.data.SyntheticPipeline`` or any
        object with ``batch(step)`` returning a dict of numpy arrays."""
        super().__init__(name, **kw)
        self.model = model
        self.train_step = train_step
        self.pipeline = pipeline
        self.state = state
        self.ckpt = (CheckpointManager(ckpt_dir) if ckpt_dir else None)
        self.watchdog = StragglerWatchdog()
        self.heartbeat = Heartbeat(heartbeat_path) if heartbeat_path else None
        # stats
        self.s_loss = self.stats.scalar("loss", "last loss")
        self.s_steps = self.stats.scalar("steps", "steps completed")
        self.s_failures = self.stats.scalar("failures", "failures recovered")
        self.s_stragglers = self.stats.scalar("stragglers", "slow steps")
        self.s_stalls = self.stats.scalar("stalls",
                                          "attempts hung on a silent pod")
        self.s_step_time = self.stats.distribution("step_time", unit="s")
        self.history: list = []

    # ------------------------------------------------------------------
    def _run_one_step(self, step: int) -> None:
        """One real training step with all its bookkeeping (stats,
        watchdog, history, heartbeat): the single copy both ``run``
        and ``run_ft`` execute."""
        device = next(leaves(self.state["params"])).device
        batch = batch_to(self.pipeline.batch(step), device)
        t0 = time.perf_counter()
        self.state, metrics = self.train_step(self.state, batch)
        loss = float(metrics["loss"])          # waits for the step
        dt = time.perf_counter() - t0
        if self.watchdog.record(step, dt):
            self.s_stragglers.inc()
        self.s_step_time.sample(dt)
        self.s_loss.set(loss)
        self.s_steps.inc()
        self.history.append({"step": step, "loss": loss, "time_s": dt})
        if self.heartbeat:
            self.heartbeat.beat(step)

    def run(self, num_steps: int,
            fail_at: Optional[Dict[int, Exception]] = None) -> Dict:
        """Run ``num_steps``; simulated failures trigger restore+retry."""
        fail_at = dict(fail_at or {})
        retries = 0
        step = int(self.state["step"])
        end = step + num_steps
        while step < end:
            try:
                if step in fail_at:
                    exc = fail_at.pop(step)
                    raise exc
                self._run_one_step(step)
                step += 1
                if self.ckpt and checkpoint_due(step, self.ckpt_interval):
                    self.ckpt.save(self.state, step)
            except SimulatedFailure:
                self.s_failures.inc()
                retries += 1
                if retries > self.max_retries:
                    raise
                if self.ckpt and self.ckpt.latest_step() is not None:
                    self.state = self.ckpt.restore(self.state)
                    step = int(self.state["step"])
                # else: continue from in-memory state (lost step)
        if self.ckpt:
            self.ckpt.save(self.state, step)
            self.ckpt.wait()
        return {"final_step": step, "history": self.history,
                "stragglers": self.watchdog.flagged}

    # ------------------------------------------------------------------
    def run_ft(self, schedule: FailureSchedule, policy: FTPolicy) -> Dict:
        """Run under a seeded :class:`FailureSchedule` with every
        recovery decision delegated to the pure :class:`FTPolicy`, the
        policy the simulator's ``TrainSim`` drives, so the two produce
        the same decision log on the same schedule.

        The trainer owns the side effects: it runs the steps, writes
        checkpoints through :class:`CheckpointManager`, and on a declared
        pod death restores the policy's chosen checkpoint.
        """
        if self.ckpt is None:
            raise ValueError("run_ft requires a CheckpointManager "
                             "(construct the Trainer with ckpt_dir=)")
        start = int(self.state["step"])
        if start != policy.start_step:
            raise ValueError(
                f"state is at step {start}, policy starts at "
                f"{policy.start_step}")
        policy.start()
        self.ckpt.save(self.state, policy.start_step)  # always restorable
        while not policy.done():
            plan = policy.execute_step(
                schedule.events_at(policy.attempt))
            if any(d.kind == "reshard" for d in plan.decisions):
                # step times legitimately change with the mesh: the
                # watchdog must re-learn its baseline, not flag every
                # post-reshard step against the old capacity's median
                self.watchdog.reset_window()
            if plan.pre_save is not None:
                # preemption notice: save before losing the pod
                self.ckpt.save(self.state, plan.pre_save)
            if plan.kind == "step":
                self._run_one_step(plan.step)
                if plan.post_save is not None:
                    self.ckpt.save(self.state, plan.post_save)
            elif plan.kind == "stall":
                self.s_stalls.inc()     # collective hung on a silent pod
            else:                       # "recover"
                self.s_failures.inc()
                self.ckpt.wait()        # surface async-save errors first
                self.state = self.ckpt.restore(self.state,
                                               step=plan.restore_to)
        self.ckpt.wait()
        final = int(self.state["step"])
        return {"final_step": final, "attempts": policy.attempt,
                "decisions": list(policy.decisions),
                "history": self.history}
