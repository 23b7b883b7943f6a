"""A copy of ``repro.train.ft_policy`` (pure Python): the port imports nothing of
the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

Pure fault-tolerance policy for pod-scale training (the TrainSim
tentpole).

This module factors the *recovery brain* out of ``repro.train.trainer``
+ ``repro.checkpoint.manager`` into one pure, step-indexed state
machine, exactly the way ``repro.serve.policy`` factored the slot
scheduler out of ``BatchServer``:

* **when to checkpoint** — the cadence rule (``checkpoint_due``) plus
  proactive saves on preemption notice;
* **when to declare a pod dead** — a failed pod goes *silent*; the
  policy declares it dead after ``dead_after_misses`` consecutive
  missed heartbeats (until then the collective hangs and steps stall);
* **which mesh to restore onto** — ``repro.train.ft.plan_elastic_mesh``
  over the surviving chip count (elastic reshard down on failure, back
  up when a repaired pod rejoins).

Every decision is logged as an :class:`FTDecision`, so "the real
``Trainer`` fault-tolerance stack and the DES ``TrainSim`` recover
identically" is a pure list-equality assertion
(tests/test_train_ft_policy.py) — no timing, no jax, no event engine
in this module.

Driver contract (both engines follow it verbatim)::

    for d in policy.start():            # logs the step-0 checkpoint
        <save the initial state>
    while not policy.done():
        plan = policy.execute_step(schedule.events_at(policy.attempt))
        if plan.pre_save is not None:  <save now (preemption notice)>
        if plan.kind == "step":        <run one training step>
            if plan.post_save is not None:  <save>
        elif plan.kind == "stall":     <a silent pod hangs the step>
        elif plan.kind == "recover":   <restore checkpoint plan.restore_to
                                        onto plan.mesh>

Time is counted in *attempts* (global step executions, including
re-runs after a rollback) — the one clock both a wall-clock trainer
and a tick-clock DES share, which is what makes the decision logs
comparable bit-for-bit.

Failure model (:class:`FailureSchedule`, fully determined by ``seed``):

* ``pod_failed``  — MTBF-driven hard failures.  The pod goes silent;
  after declaration the policy reshards onto the survivors and rolls
  back to the last checkpoint.  ``repair`` attempts later the pod (or
  with ``repair=0``, an immediately-available replacement) rejoins and
  the policy reshards back up.
* ``straggler``   — a transient slowdown of one pod for ``duration``
  attempts (the whole SPMD step runs at the straggler's pace).
* ``preemption``  — an eviction *with notice*: the policy checkpoints
  proactively, so the pod leaves without losing work.

``young_interval`` / ``daly_interval`` give the classic optimum
checkpoint-interval approximations the ``benchmarks/ft_sweep``
goodput frontier is validated against.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.train.ft import MeshPlan, plan_elastic_mesh


# ---------------------------------------------------------------------------
# cadence + optimum-interval formulas
# ---------------------------------------------------------------------------

def checkpoint_due(step: int, interval: int, start: int = 0) -> bool:
    """The checkpoint cadence rule: a checkpoint is due every
    ``interval`` completed steps (counted from ``start``).  Factored
    here so ``Trainer.run``, ``Trainer.run_ft`` and ``TrainSim`` all
    share one rule."""
    return interval > 0 and step > start and (step - start) % interval == 0


def young_interval(ckpt_cost: float, mtbf: float) -> float:
    """Young's first-order optimum checkpoint interval
    ``sqrt(2 * delta * M)`` (any consistent time unit)."""
    return math.sqrt(2.0 * ckpt_cost * mtbf)


def daly_interval(ckpt_cost: float, mtbf: float) -> float:
    """Daly's higher-order refinement of Young's formula,
    ``sqrt(2 * delta * M) - delta`` (valid for ``delta < M/2``)."""
    return max(math.sqrt(2.0 * ckpt_cost * mtbf) - ckpt_cost, ckpt_cost)


# ---------------------------------------------------------------------------
# the failure schedule
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FailureEvent:
    """One injected fault, fired when the driver reaches ``attempt``."""

    attempt: int
    kind: str            # "pod_failed" | "straggler" | "preemption"
    pod: int
    slowdown: float = 1.0   # straggler: step-time multiplier
    duration: int = 1       # straggler: attempts the slowdown lasts
    repair: int = 0         # attempts until the pod (or a replacement)
    #                         rejoins; 0 = replacement available at once


@dataclass
class FailureSchedule:
    """A seeded, immutable list of fault events indexed by attempt."""

    events: Tuple[FailureEvent, ...]
    seed: int = 0
    horizon: int = 0
    pods: int = 1

    def __post_init__(self):
        self.events = tuple(sorted(self.events,
                                   key=lambda e: (e.attempt, e.pod, e.kind)))
        by_attempt: Dict[int, List[FailureEvent]] = {}
        for ev in self.events:
            by_attempt.setdefault(ev.attempt, []).append(ev)
        self._by_attempt = {a: tuple(evs) for a, evs in by_attempt.items()}

    def events_at(self, attempt: int) -> Tuple[FailureEvent, ...]:
        return self._by_attempt.get(attempt, ())

    @classmethod
    def generate(cls, *, seed: int, horizon: int, pods: int,
                 mtbf: float = 0.0,
                 straggler_mtbs: float = 0.0,
                 straggler_slowdown: Tuple[float, float] = (2.0, 4.0),
                 straggler_duration: Tuple[int, int] = (2, 8),
                 preemption_mtbs: float = 0.0,
                 repair: Tuple[int, int] = (0, 0)) -> "FailureSchedule":
        """Draw a schedule over ``horizon`` attempts on ``pods`` pods.
        ``mtbf`` / ``straggler_mtbs`` / ``preemption_mtbs`` are mean
        attempts between events of each family (0 disables the family);
        ``repair`` is the inclusive range of pod repair times.  All
        randomness comes from ``seed``."""
        rng = random.Random(seed)
        out: List[FailureEvent] = []

        def poisson_times(mean: float) -> List[int]:
            ts, t = [], 0.0
            if mean <= 0:
                return ts
            while True:
                t += rng.expovariate(1.0 / mean)
                if t >= horizon:
                    return ts
                ts.append(int(t))

        for a in poisson_times(mtbf):
            out.append(FailureEvent(a, "pod_failed", rng.randrange(pods),
                                    repair=rng.randint(*repair)))
        for a in poisson_times(straggler_mtbs):
            out.append(FailureEvent(
                a, "straggler", rng.randrange(pods),
                slowdown=rng.uniform(*straggler_slowdown),
                duration=rng.randint(*straggler_duration)))
        for a in poisson_times(preemption_mtbs):
            out.append(FailureEvent(a, "preemption", rng.randrange(pods),
                                    repair=max(1, rng.randint(*repair))))
        return cls(tuple(out), seed=seed, horizon=horizon, pods=pods)


# ---------------------------------------------------------------------------
# decisions and per-attempt plans
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FTDecision:
    """One recovery decision, in decision order (the comparable log)."""

    kind: str          # "checkpoint" | "straggler" | "pod_dead" |
    #                    "pod_joined" | "preempt" | "reshard" | "restore"
    step: int          # training-step counter when the decision was taken
    attempt: int
    pod: int = -1
    mesh: Tuple[int, ...] = ()
    chips: int = 0
    note: str = ""

    def to_row(self) -> List[Any]:
        return [self.kind, self.step, self.attempt, self.pod,
                list(self.mesh), self.chips, self.note]

    @classmethod
    def from_row(cls, r: Sequence[Any]) -> "FTDecision":
        return cls(r[0], int(r[1]), int(r[2]), int(r[3]),
                   tuple(int(x) for x in r[4]), int(r[5]), r[6])


@dataclass(frozen=True)
class StepPlan:
    """What the driver must do for one attempt (in field order)."""

    attempt: int
    kind: str                       # "step" | "stall" | "recover"
    step: int                       # the training step attempted
    pre_save: Optional[int] = None  # save current state as this step now
    post_save: Optional[int] = None  # after the step completes
    restore_to: Optional[int] = None  # recover: checkpoint step to load
    lost_steps: int = 0             # recover: completed steps rolled back
    slowdown: float = 1.0           # straggler multiplier for this step
    capacity: float = 1.0           # mesh chips / full chips
    mesh: Tuple[int, ...] = ()
    decisions: Tuple[FTDecision, ...] = ()


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

class FTPolicy:
    """Deterministic recovery policy over a fixed pod fleet.

    Pure: consumes attempt-indexed fault events, produces
    :class:`StepPlan`s and an :class:`FTDecision` log.  The driver owns
    all side effects (running steps, writing/restoring checkpoints,
    advancing simulated time)."""

    def __init__(self, cfg: ArchConfig, *, num_steps: int,
                 ckpt_interval: int, pods: int, chips_per_pod: int,
                 start_step: int = 0, dead_after_misses: int = 2,
                 prefer_model: int = 16, max_attempts: int = 0):
        if num_steps < 1 or pods < 1 or chips_per_pod < 1:
            raise ValueError("num_steps, pods, chips_per_pod must be >= 1")
        if dead_after_misses < 1:
            raise ValueError("dead_after_misses must be >= 1")
        self.cfg = cfg
        self.num_steps = num_steps
        self.ckpt_interval = ckpt_interval
        self.pods = pods
        self.chips_per_pod = chips_per_pod
        self.start_step = start_step
        self.dead_after_misses = dead_after_misses
        self.prefer_model = prefer_model
        self.max_attempts = max_attempts or 50 * num_steps + 1000
        # mutable state
        self.attempt = 0
        self.step = start_step          # next training step to execute
        self.last_ckpt = start_step
        self.decisions: List[FTDecision] = []
        self._silent: Dict[int, Tuple[int, int]] = {}  # pod -> (at, repair)
        self._dead: List[int] = []
        self._returns: Dict[int, List[int]] = {}       # attempt -> pods
        self._stragglers: Dict[int, Tuple[float, int]] = {}  # pod ->
        #                                               (slowdown, until)
        self._started = False
        self.mesh: MeshPlan = self._plan_mesh()

    # -- internals -------------------------------------------------------
    @property
    def _end(self) -> int:
        return self.start_step + self.num_steps

    def _alive_pods(self) -> int:
        return self.pods - len(self._dead) - len(self._silent)

    def _plan_mesh(self) -> MeshPlan:
        return plan_elastic_mesh(self.cfg,
                                 self._alive_pods() * self.chips_per_pod,
                                 prefer_model=self.prefer_model)

    def _log(self, out: List[FTDecision], kind: str, *, pod: int = -1,
             mesh: Tuple[int, ...] = (), chips: int = 0,
             note: str = "") -> None:
        d = FTDecision(kind, self.step, self.attempt, pod, mesh, chips,
                       note)
        self.decisions.append(d)
        out.append(d)

    def _reshard(self, out: List[FTDecision]) -> None:
        plan = self._plan_mesh()
        if plan.shape != self.mesh.shape or plan.chips != self.mesh.chips:
            self.mesh = plan
            self._log(out, "reshard", mesh=plan.shape, chips=plan.chips,
                      note=plan.note)

    def capacity(self) -> float:
        return self.mesh.chips / float(self.pods * self.chips_per_pod)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> Tuple[FTDecision, ...]:
        """Log the step-``start_step`` checkpoint (the initial state is
        always restorable — the driver must actually save it)."""
        if self._started:
            return ()
        self._started = True
        out: List[FTDecision] = []
        self._log(out, "checkpoint", note="initial state")
        return tuple(out)

    def done(self) -> bool:
        return self.step >= self._end

    def execute_step(self, events: Sequence[FailureEvent] = ()
                     ) -> StepPlan:
        """Advance one attempt: absorb this attempt's fault events,
        decide, and return the plan the driver must execute."""
        if not self._started:
            raise RuntimeError("call start() before execute_step()")
        if self.done():
            raise RuntimeError("policy is done")
        if self.attempt >= self.max_attempts:
            raise RuntimeError(
                f"no progress after {self.attempt} attempts (failure "
                "rate too high for the checkpoint cadence?)")
        a = self.attempt
        out: List[FTDecision] = []
        pre_save: Optional[int] = None
        mesh_dirty = False

        # 1. repaired pods rejoin at the attempt boundary
        for at in sorted(k for k in self._returns if k <= a):
            for pod in self._returns.pop(at):
                if pod in self._dead:
                    self._dead.remove(pod)
                    self._log(out, "pod_joined", pod=pod)
                    mesh_dirty = True

        # 2. this attempt's fault events
        for ev in events:
            if ev.kind == "straggler":
                if ev.pod in self._dead or ev.pod in self._silent:
                    continue
                self._stragglers[ev.pod] = (ev.slowdown,
                                            a + max(1, ev.duration))
                self._log(out, "straggler", pod=ev.pod,
                          note=f"{ev.slowdown:.2f}x for {ev.duration}")
            elif ev.kind == "preemption":
                if (ev.pod in self._dead or ev.pod in self._silent
                        or self._alive_pods() <= 1):
                    continue          # never evict the last alive pod
                self._log(out, "preempt", pod=ev.pod,
                          note=f"notice, back in {ev.repair}")
                # proactive save: the pod leaves without losing work
                pre_save = self.step
                self.last_ckpt = self.step
                self._log(out, "checkpoint", note="preemption notice")
                self._dead.append(ev.pod)
                self._stragglers.pop(ev.pod, None)   # dies with the pod
                self._log(out, "pod_dead", pod=ev.pod, note="preempted")
                self._returns.setdefault(a + max(1, ev.repair),
                                         []).append(ev.pod)
                mesh_dirty = True
            elif ev.kind == "pod_failed":
                if ev.pod in self._dead or ev.pod in self._silent:
                    continue
                self._silent[ev.pod] = (a, ev.repair)
            else:
                raise ValueError(f"unknown failure kind {ev.kind!r}")

        # 3. silent pods hang the collective: stall until declared dead
        if self._silent:
            overdue = sorted(
                pod for pod, (at, _) in self._silent.items()
                if a - at + 1 >= self.dead_after_misses)
            if not overdue:
                if mesh_dirty:
                    self._reshard(out)
                plan = StepPlan(a, "stall", self.step,
                                pre_save=pre_save,
                                capacity=self.capacity(),
                                mesh=self.mesh.shape,
                                decisions=tuple(out))
                self.attempt += 1
                return plan
            for pod in overdue:
                _, repair = self._silent.pop(pod)
                # the slowdown was a property of the dead hardware; the
                # replacement (or the repaired pod) starts clean
                self._stragglers.pop(pod, None)
                self._log(out, "pod_dead", pod=pod,
                          note=f"missed {self.dead_after_misses} "
                               "heartbeats")
                if repair > 0 and self._alive_pods() > 1:
                    self._dead.append(pod)
                    self._returns.setdefault(a + repair, []).append(pod)
                else:
                    # a replacement pod is available immediately; it
                    # joins the restored mesh (state is still lost)
                    self._log(out, "pod_joined", pod=pod,
                              note="replacement")
            self._reshard(out)
            lost = self.step - self.last_ckpt
            self._log(out, "restore", note=f"step {self.last_ckpt}, "
                                           f"lost {lost} steps")
            self.step = self.last_ckpt
            plan = StepPlan(a, "recover", self.step, pre_save=pre_save,
                            restore_to=self.last_ckpt, lost_steps=lost,
                            capacity=self.capacity(),
                            mesh=self.mesh.shape, decisions=tuple(out))
            self.attempt += 1
            return plan

        if mesh_dirty:
            self._reshard(out)

        # 4. a normal step at the current capacity/slowdown
        for pod in sorted(p for p, (_, until) in self._stragglers.items()
                          if until <= a):
            del self._stragglers[pod]
        slowdown = max([1.0] + [s for p, (s, _) in self._stragglers.items()
                                if p not in self._dead])
        step = self.step
        self.step += 1
        post_save: Optional[int] = None
        if (checkpoint_due(self.step, self.ckpt_interval, self.start_step)
                or self.step == self._end):
            post_save = self.step
            self.last_ckpt = self.step
            self._log(out, "checkpoint")
        plan = StepPlan(a, "step", step, pre_save=pre_save,
                        post_save=post_save, slowdown=slowdown,
                        capacity=self.capacity(), mesh=self.mesh.shape,
                        decisions=tuple(out))
        self.attempt += 1
        return plan

    # -- checkpointing ---------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "attempt": self.attempt,
            "step": self.step,
            "last_ckpt": self.last_ckpt,
            "started": self._started,
            "dead": sorted(self._dead),
            "silent": sorted([p, at, rep] for p, (at, rep)
                             in self._silent.items()),
            "returns": sorted([at, sorted(pods)] for at, pods
                              in self._returns.items()),
            "stragglers": sorted([p, s, u] for p, (s, u)
                                 in self._stragglers.items()),
            "mesh": {"shape": list(self.mesh.shape),
                     "axes": list(self.mesh.axes),
                     "chips": self.mesh.chips, "note": self.mesh.note},
            "decisions": [d.to_row() for d in self.decisions],
        }

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.attempt = int(d["attempt"])
        self.step = int(d["step"])
        self.last_ckpt = int(d["last_ckpt"])
        self._started = bool(d["started"])
        self._dead = [int(p) for p in d["dead"]]
        self._silent = {int(p): (int(at), int(rep))
                        for p, at, rep in d["silent"]}
        self._returns = {int(at): [int(p) for p in pods]
                         for at, pods in d["returns"]}
        self._stragglers = {int(p): (float(s), int(u))
                            for p, s, u in d["stragglers"]}
        m = d["mesh"]
        self.mesh = MeshPlan(tuple(int(x) for x in m["shape"]),
                             tuple(m["axes"]), int(m["chips"]), m["note"])
        self.decisions = [FTDecision.from_row(r) for r in d["decisions"]]
