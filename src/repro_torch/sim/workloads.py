"""A copy of ``repro.sim.workloads`` (pure Python): the port imports
nothing of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

Dynamic workloads: ops generated in response to events (tentpole).

The gem5 paper's headline capability is running *full applications* —
work is created by the simulated system as it runs, not replayed from a
frozen trace.  This module brings that to g5x: a
:class:`DynamicWorkload` interface whose implementations inject ops
into a live :class:`~repro.core.desim.executor.TraceExecutor` run
(``inject_op``), driven by ``repro.sim.Simulator``'s exit-event loop.

Two flagship implementations:

* :class:`ServeSim` — request-level, vLLM-style continuous-batching
  LLM serving at pod scale (below);
* :class:`TrainSim` — fault-injected large-scale training: roofline-
  costed steps under a seeded failure schedule, with recovery driven
  by the pure ``repro.train.ft_policy.FTPolicy`` the real ``Trainer``
  uses (see the class docstring at the bottom of this module).

* **Arrivals are events** — open-loop (Poisson or a recorded trace of
  arrival times) or closed-loop (a fixed client population, each
  submitting its next request when the previous one finishes plus think
  time).  All randomness comes from one explicit ``seed``.
* **The scheduling policy is the real one** — each pod replica drives a
  :class:`repro.serve.policy.SlotScheduler`, the *identical* pure
  policy object ``repro.serve.server.BatchServer`` uses, so DES and
  real-server scheduling decisions match exactly (test-enforced).
* **Phases are roofline-costed** — an admitted request injects a
  prefill compute op; each engine iteration injects one batched decode
  op whose flops/bytes follow the standard LLM serving roofline
  (weight-read-bound decode, compute-bound prefill) via
  :class:`ServingCost`; execution time then comes from the machine
  model's ``compute_time_s`` like every other op in the DES.
* **KV-cache slots are the contended resource** — ``slots`` x
  ``seq_capacity`` tokens per replica; requests queue when slots are
  full (the queue wait shows up in TTFT).
* **SLOs are exit events** — TTFT/latency targets; violations count in
  stats and (with ``exit_on_slo``) surface as ``SLO_VIOLATION`` exit
  events from ``Simulator.run()``.

Checkpointing: ``state_dict``/``load_state_dict`` capture pending
arrivals, per-replica scheduler state (including the decision log),
in-flight request runtimes, and the percentile-stat accumulators; the
executor side (in-flight/deferred injected ops) rides in the normal
drain-then-serialize snapshot, so a run restored mid-serving finishes
bit-identically (tests/test_sim_checkpoint.py).

Fidelity: both workloads inject only per-pod *compute* ops, so they
are **tick-exact under AtomicTiming** (``timing="atomic"`` — same
makespan, same decision logs, ~zero engine events; test-enforced in
tests/test_timing_models.py).  The big serving/FT sweeps
(``benchmarks/serving_sweep.py``, ``benchmarks/ft_sweep.py``) default
to atomic with a detailed spot-check for exactly this reason; see
``docs/fidelity.md``.
"""

from __future__ import annotations

import hashlib
import heapq
import json
import random
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.desim.simnodes import TICKS_PER_S, to_ticks
from repro_torch.core.desim.trace import TraceOp
from repro_torch.core.simobject import Param, SimObject
from repro_torch.serve.policy import SlotScheduler
from repro_torch.train.ft_policy import (FailureSchedule, FTDecision, FTPolicy,
                                   StepPlan)


# ---------------------------------------------------------------------------
# requests and arrival processes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ServeRequest:
    """One simulated request.  ``rid`` equals its index in the request
    list (the stable identity used by schedulers and checkpoints)."""

    rid: int
    prompt_len: int
    decode_len: int          # max_new_tokens of the real server
    arrival_tick: int = 0    # open-loop arrival time (ignored closed-loop)


def poisson_requests(num_requests: int, rate_rps: float, *, seed: int,
                     prompt_len: Tuple[int, int] = (64, 512),
                     decode_len: Tuple[int, int] = (16, 128)
                     ) -> List[ServeRequest]:
    """Open-loop Poisson arrival stream with uniform prompt/decode
    lengths, fully determined by ``seed`` (reproducible sweeps)."""
    if rate_rps <= 0:
        raise ValueError("rate_rps must be positive")
    rng = random.Random(seed)
    t = 0.0
    out: List[ServeRequest] = []
    for i in range(num_requests):
        t += rng.expovariate(rate_rps)
        out.append(ServeRequest(
            rid=i,
            prompt_len=rng.randint(*prompt_len),
            decode_len=rng.randint(*decode_len),
            arrival_tick=to_ticks(t)))
    return out


def trace_requests(rows: Sequence[Tuple[float, int, int]]) -> List[ServeRequest]:
    """Trace-driven arrivals from ``(arrival_s, prompt_len, decode_len)``
    rows (e.g. replayed from production logs)."""
    ordered = sorted(rows, key=lambda r: r[0])
    return [ServeRequest(rid=i, prompt_len=int(p), decode_len=int(d),
                         arrival_tick=to_ticks(s))
            for i, (s, p, d) in enumerate(ordered)]


def uniform_requests(num_requests: int, *, seed: int,
                     prompt_len: Tuple[int, int] = (64, 512),
                     decode_len: Tuple[int, int] = (16, 128)
                     ) -> List[ServeRequest]:
    """Request dimensions without arrival times — the closed-loop pool
    (clients set the timing) or an all-at-tick-0 batch."""
    rng = random.Random(seed)
    return [ServeRequest(rid=i, prompt_len=rng.randint(*prompt_len),
                         decode_len=rng.randint(*decode_len))
            for i in range(num_requests)]


# ---------------------------------------------------------------------------
# serving roofline cost model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ServingCost:
    """Linear roofline cost model of one serving replica.

    The standard LLM inference model: a forward pass moves every
    resident weight byte once and touches each request's KV cache;
    flops scale with tokens processed.  Per-op times then come from
    ``ChipModel.compute_time_s`` (max of compute and HBM terms) — the
    same roofline machinery every compute op in the DES uses.

    All quantities are whole-model; ``chips`` shards them over the
    replica's chips (per-chip values are what ``TraceOp`` carries).
    """

    flops_per_token: float    # forward FLOPs per processed token (~2*params)
    weight_bytes: float       # resident weight bytes read per pass
    kv_bytes_per_token: float  # KV bytes appended/read per context token
    chips: int = 1

    def prefill_cost(self, prompt_len: int) -> Tuple[float, float]:
        """(flops, bytes) per chip to prefill ``prompt_len`` tokens."""
        flops = self.flops_per_token * prompt_len
        nbytes = self.weight_bytes + self.kv_bytes_per_token * prompt_len
        return flops / self.chips, nbytes / self.chips

    def decode_cost(self, batch: int, context_tokens: int
                    ) -> Tuple[float, float]:
        """(flops, bytes) per chip for one batched decode step over
        ``batch`` active slots with ``context_tokens`` total context."""
        flops = self.flops_per_token * batch
        nbytes = (self.weight_bytes
                  + self.kv_bytes_per_token * (context_tokens + batch))
        return flops / self.chips, nbytes / self.chips

    def kv_slot_bytes(self, seq_capacity: int) -> float:
        """HBM footprint of one full KV slot (capacity planning)."""
        return self.kv_bytes_per_token * seq_capacity

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_params(cls, num_params: float, *, layers: int, d_model: int,
                    dtype_bytes: float = 2.0, chips: int = 1
                    ) -> "ServingCost":
        """Analytic model from architecture shape: 2 flops per param per
        token, K+V rows of ``d_model`` per layer per token."""
        return cls(flops_per_token=2.0 * num_params,
                   weight_bytes=num_params * dtype_bytes,
                   kv_bytes_per_token=2.0 * layers * d_model * dtype_bytes,
                   chips=chips)

    @classmethod
    def from_hlo_cost(cls, decode_cost, *, batch: int, context_tokens: int,
                      weight_bytes: float, chips: int = 1) -> "ServingCost":
        """Fit the model from an analyzed decode step (a
        ``repro.core.desim.hlo_cost.Cost`` of one compiled batched
        decode): flops are per batch element; bytes beyond the known
        resident weights are attributed to KV traffic."""
        kv = max(0.0, decode_cost.bytes - weight_bytes) \
            / max(context_tokens + batch, 1)
        return cls(flops_per_token=decode_cost.flops / max(batch, 1),
                   weight_bytes=weight_bytes, kv_bytes_per_token=kv,
                   chips=chips)


# ---------------------------------------------------------------------------
# the dynamic-workload interface
# ---------------------------------------------------------------------------

class DynamicWorkload:
    """A workload that generates ops while the simulation runs.

    ``Simulator`` drives it as a co-simulation: the executor advances to
    the workload's next event tick, then ``poll(tick)`` lets the
    workload react (inject ops, submit requests).  Op completions reach
    the workload synchronously through the executor's
    ``injection_hook``, so the engine's internal feedback loops (e.g. a
    decode step triggering the next) never leave the event engine.
    """

    #: exit events for ``Simulator.run`` (dicts: tick/cause/payload)
    pending_exits: Deque[Dict[str, Any]]

    def bind(self, executor) -> None:
        raise NotImplementedError

    def start(self) -> None:
        raise NotImplementedError

    def next_event_tick(self) -> Optional[int]:
        raise NotImplementedError

    def poll(self, tick: int) -> None:
        raise NotImplementedError

    def done(self) -> bool:
        raise NotImplementedError

    def state_dict(self) -> Dict[str, Any]:
        raise NotImplementedError

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        raise NotImplementedError


class _Replica:
    """One serving replica (one pod): a slot scheduler plus in-flight
    tracking.  ``busy`` is True while a decode chain is in the engine;
    an idle replica is woken by the next arrival."""

    def __init__(self, pod: int, sched: SlotScheduler):
        self.pod = pod
        self.sched = sched
        self.busy = False


# ---------------------------------------------------------------------------
# ServeSim
# ---------------------------------------------------------------------------

class ServeSim(SimObject, DynamicWorkload):
    """Request-level continuous-batching serving on the event engine.

    One replica per pod of the board's machine; requests are dispatched
    round-robin by rid (a deterministic load balancer).  See the module
    docstring for the model; see ``docs/serving.md`` for the
    correspondence to ``repro.serve.server.BatchServer``.
    """

    slots = Param(int, 8, "KV-cache slots (decode batch) per replica",
                  check=lambda v: v >= 1)
    seq_capacity = Param(int, 2048, "KV capacity (tokens) per slot",
                         check=lambda v: v >= 2)
    slo_ttft_s = Param(float, 0.0, "TTFT SLO in seconds (0 = none)")
    slo_latency_s = Param(float, 0.0, "request-latency SLO (0 = none)")
    exit_on_slo = Param(bool, False,
                        "surface each SLO violation as an exit event")
    closed_loop_clients = Param(int, 0,
                                "closed-loop client population (0 = open loop)")
    think_time_s = Param(float, 0.0, "closed-loop think time per client")

    def __init__(self, name: str = "serve", *, cost: ServingCost,
                 requests: List[ServeRequest], **params):
        super().__init__(name, **params)
        if not requests:
            raise ValueError("ServeSim needs at least one request")
        for i, r in enumerate(requests):
            if r.rid != i:
                raise ValueError(f"request {i} has rid {r.rid}; rids must "
                                 "equal list indices")
            # fail at construction, not at the request's arrival tick
            # deep inside a long simulation
            if r.prompt_len >= self.seq_capacity:
                raise ValueError(
                    f"request {i}: prompt_len {r.prompt_len} does not fit "
                    f"seq_capacity {self.seq_capacity}")
            if r.decode_len < 1 or r.prompt_len < 1:
                raise ValueError(
                    f"request {i}: prompt_len/decode_len must be >= 1")
        self.cost = cost
        self._requests = list(requests)
        self._ex = None
        self._reps: Optional[List[_Replica]] = None
        self._heap: List[Tuple[int, int]] = []      # (arrival_tick, rid)
        self._cursor = 0           # next rid a closed-loop client takes
        self._done_count = 0
        self._started = False
        self.pending_exits: Deque[Dict[str, Any]] = deque()
        # rid -> runtime ticks (submit/first token/finish) + SLO verdict
        self._rt: Dict[int, Dict[str, Any]] = {}
        s = self.stats
        self.s_admitted = s.scalar("admitted", "requests admitted to slots")
        self.s_requests = s.scalar("requests_done", "requests completed")
        self.s_tokens = s.scalar("tokens_out", "decode tokens generated")
        self.s_decode_steps = s.scalar("decode_steps", "batched decode steps")
        self.s_prefills = s.scalar("prefills", "prefill ops run")
        self.s_slo_viol = s.scalar("slo_violations", "requests over SLO")
        self.p_ttft = s.percentiles("ttft", "time to first token", "s")
        self.p_tpot = s.percentiles("tpot", "time per output token", "s")
        self.p_latency = s.percentiles("latency", "request latency", "s")
        self.p_queue_wait = s.percentiles("queue_wait",
                                          "arrival-to-admission wait", "s")
        self.d_batch = s.distribution("decode_batch",
                                      "active slots per decode step")
        s.formula("tokens_per_step",
                  lambda: self.s_tokens.value()
                  / max(self.s_decode_steps.value(), 1.0))

    # -- DynamicWorkload: lifecycle --------------------------------------
    def bind(self, executor) -> None:
        """Attach to a (possibly freshly restored) executor.  Replica
        state is created once; re-binding after a checkpoint restore
        keeps it."""
        self._ex = executor
        executor.injection_hook = self._on_op_done
        if self._reps is None:
            pods = executor.machine.num_pods
            self._reps = [_Replica(p, SlotScheduler(self.slots,
                                                    self.seq_capacity))
                          for p in range(pods)]

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        if self.closed_loop_clients > 0:
            # each client submits its first request at tick 0
            first = min(self.closed_loop_clients, len(self._requests))
            self._heap = [(0, i) for i in range(first)]
            self._cursor = first
        else:
            self._heap = [(r.arrival_tick, r.rid) for r in self._requests]
            self._cursor = len(self._requests)
        heapq.heapify(self._heap)

    def next_event_tick(self) -> Optional[int]:
        return self._heap[0][0] if self._heap else None

    def poll(self, tick: int) -> None:
        self._catch_up(int(tick))

    def done(self) -> bool:
        return self._done_count == len(self._requests)

    # -- the serving engine ----------------------------------------------
    def _catch_up(self, t: int) -> None:
        """Submit every arrival with tick <= ``t``, in tick order,
        waking idle replicas at the exact arrival tick.  All arrivals
        sharing one tick are submitted *before* any replica wakes (the
        server submits its whole batch before the first fill).  Called
        from ``poll`` and from decode completions, so arrival
        interleaving is identical whether the run pauses/drains or not.
        """
        while self._heap and self._heap[0][0] <= t:
            tick = self._heap[0][0]
            touched: List[_Replica] = []
            while self._heap and self._heap[0][0] == tick:
                _, rid = heapq.heappop(self._heap)
                req = self._requests[rid]
                rep = self._reps[rid % len(self._reps)]
                rep.sched.submit(rid, req.prompt_len, req.decode_len)
                self._rt[rid] = {"submit": tick, "first": -1, "finish": -1,
                                 "ok": True}
                if rep not in touched:
                    touched.append(rep)
            for rep in touched:
                if not rep.busy:
                    self._iteration(rep, tick)

    def _iteration(self, rep: _Replica, now: int) -> None:
        """One continuous-batching iteration: admit waiting requests
        (injecting their prefills), then inject the batched decode step
        over all active slots.  Mirrors the BatchServer loop body."""
        sched = rep.sched
        prefill_deps = []
        for slot, rid in sched.fill():
            req = self._requests[rid]
            self.s_admitted.inc()
            self.s_prefills.inc()
            self.p_queue_wait.sample(
                (now - self._rt[rid]["submit"]) / TICKS_PER_S)
            fl, by = self.cost.prefill_cost(req.prompt_len)
            prefill_deps.append(self._ex.inject_op(
                TraceOp("compute", flops=fl, bytes=by,
                        name=f"serve/p{rep.pod}/prefill/r{rid}"),
                ready=now, pod=rep.pod))
        active = sched.active_slots()
        if not active:
            rep.busy = False
            return
        ctx = sum(sched.context_len(s) for s in active)
        fl, by = self.cost.decode_cost(len(active), ctx)
        self.d_batch.sample(len(active))
        self._ex.inject_op(
            TraceOp("compute", flops=fl, bytes=by, deps=tuple(prefill_deps),
                    name=f"serve/p{rep.pod}/decode/s{sched.steps}"),
            ready=now, pod=rep.pod)
        rep.busy = True

    def _on_op_done(self, op: TraceOp, idx: int, pod: int, start: int,
                    end: int) -> None:
        parts = (op.name or "").split("/")
        if len(parts) < 3 or parts[0] != "serve":
            return
        rep = self._reps[pod]
        if parts[2] == "prefill":
            rid = int(parts[3][1:])
            rt = self._rt[rid]
            rt["first"] = end
            self.p_ttft.sample((end - rt["submit"]) / TICKS_PER_S)
            return
        # one batched decode step completed: advance every active slot
        sched = rep.sched
        sched.note_step()
        self.s_decode_steps.inc()
        for slot in sched.active_slots():
            rid = sched.active[slot]
            self.s_tokens.inc()
            fin = sched.complete_token(slot)
            if fin is not None:
                self._finish(rid, end, sched)
        # arrivals up to this tick join the queue before the next fill
        self._catch_up(end)
        self._iteration(rep, end)

    def _finish(self, rid: int, end: int, sched: SlotScheduler) -> None:
        rt = self._rt[rid]
        rt["finish"] = end
        latency = (end - rt["submit"]) / TICKS_PER_S
        tokens = sched.requests[rid].tokens_out
        ttft = (rt["first"] - rt["submit"]) / TICKS_PER_S
        tpot = ((end - rt["first"]) / TICKS_PER_S) / max(tokens - 1, 1)
        self.p_latency.sample(latency)
        self.p_tpot.sample(tpot)
        self.s_requests.inc()
        self._done_count += 1
        violated = ((self.slo_ttft_s > 0 and ttft > self.slo_ttft_s)
                    or (self.slo_latency_s > 0
                        and latency > self.slo_latency_s))
        if violated:
            rt["ok"] = False
            self.s_slo_viol.inc()
            if self.exit_on_slo:
                self.pending_exits.append({
                    "tick": end, "cause": f"slo violation: request {rid}",
                    "payload": {"rid": rid, "ttft_s": ttft,
                                "latency_s": latency}})
        if self.closed_loop_clients > 0 and self._cursor < len(self._requests):
            nxt = self._cursor
            self._cursor += 1
            heapq.heappush(self._heap,
                           (end + to_ticks(self.think_time_s), nxt))

    # -- results -----------------------------------------------------------
    @property
    def schedulers(self) -> List[SlotScheduler]:
        """Per-replica schedulers (decision logs live here)."""
        if self._reps is None:
            raise RuntimeError("ServeSim not bound to an executor yet")
        return [rep.sched for rep in self._reps]

    def summary(self) -> Dict[str, float]:
        """Serving-level result row (the goodput/SLO frontier point).

        ``span_s`` is the active window — first *submitted* request to
        last finish — not tick 0 to last finish: a trace replayed with
        an arrival offset (say production logs starting at t=1000 s)
        must report its real throughput, not one diluted by the idle
        lead-in.  Percentile keys are NaN when no sample landed, so a
        zero-finish run can never masquerade as a perfect one.
        """
        finished = [rt for rt in self._rt.values() if rt["finish"] >= 0]
        if finished:
            first = min(rt["submit"] for rt in finished)
            span_s = (max(rt["finish"] for rt in finished)
                      - first) / TICKS_PER_S
        else:
            span_s = 0.0
        ok = sum(1 for rt in finished if rt["ok"])

        def nan_if_empty(stat, value: float) -> float:
            return value if stat.count else float("nan")

        return {
            "requests": float(len(finished)),
            "span_s": span_s,
            "throughput_rps": len(finished) / span_s if span_s else 0.0,
            "goodput_rps": ok / span_s if span_s else 0.0,
            "slo_violations": self.s_slo_viol.value(),
            "tokens_out": self.s_tokens.value(),
            "p50_ttft_s": nan_if_empty(self.p_ttft,
                                       self.p_ttft.quantile(0.50)),
            "p99_ttft_s": nan_if_empty(self.p_ttft,
                                       self.p_ttft.quantile(0.99)),
            "p50_latency_s": nan_if_empty(self.p_latency,
                                          self.p_latency.quantile(0.50)),
            "p99_latency_s": nan_if_empty(self.p_latency,
                                          self.p_latency.quantile(0.99)),
            "mean_tpot_s": nan_if_empty(self.p_tpot, self.p_tpot.mean),
            "mean_batch": nan_if_empty(self.d_batch, self.d_batch.mean),
        }

    # -- checkpointing -----------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "num_requests": len(self._requests),
            "started": self._started,
            "cursor": self._cursor,
            "done_count": self._done_count,
            "heap": sorted([t, r] for t, r in self._heap),
            "runtime": {str(rid): dict(rt) for rid, rt in self._rt.items()},
            "reps": [{"pod": rep.pod, "busy": rep.busy,
                      "sched": rep.sched.state_dict()}
                     for rep in (self._reps or [])],
            "pending_exits": [dict(e) for e in self.pending_exits],
            "stats": self.stats.state_dict(),
        }

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        if int(d["num_requests"]) != len(self._requests):
            raise ValueError(
                f"checkpoint has {d['num_requests']} requests, this "
                f"ServeSim {len(self._requests)} — rebuild the workload "
                "with the same request stream (same seed/params)")
        if self._reps is None:
            raise RuntimeError("bind() the ServeSim before loading state")
        if len(d["reps"]) != len(self._reps):
            raise ValueError(
                f"checkpoint has {len(d['reps'])} replicas, machine has "
                f"{len(self._reps)} pods")
        self._started = bool(d["started"])
        self._cursor = int(d["cursor"])
        self._done_count = int(d["done_count"])
        self._heap = [(int(t), int(r)) for t, r in d["heap"]]
        heapq.heapify(self._heap)
        self._rt = {int(rid): dict(rt) for rid, rt in d["runtime"].items()}
        for rep, rd in zip(self._reps, d["reps"]):
            rep.busy = bool(rd["busy"])
            rep.sched = SlotScheduler(self.slots, self.seq_capacity)
            rep.sched.load_state_dict(rd["sched"])
        self.pending_exits = deque(dict(e) for e in d["pending_exits"])
        self.stats.load_state_dict(d["stats"])


# ---------------------------------------------------------------------------
# training roofline cost model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainStepCost:
    """Roofline cost of one training step (and its FT overheads).

    All quantities are PER CHIP at full-fleet capacity; when the
    elastic mesh shrinks to a fraction ``capacity`` of the chips, the
    surviving chips each carry ``1/capacity`` of these (the sharded
    work redistributes).  Per-op times come from the machine model's
    ``compute_time_s`` roofline like every other op in the DES.
    """

    step_flops: float        # training-step FLOPs per chip (fwd+bwd)
    step_bytes: float        # HBM bytes per chip per step
    ckpt_bytes: float        # checkpoint write bytes per chip
    restore_bytes: float = 0.0   # restore read + restart bytes per chip

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_hlo_cost(cls, step_cost, *, state_bytes: float,
                      chips: int = 1, restore_factor: float = 1.5
                      ) -> "TrainStepCost":
        """From an analyzed compiled train step (a
        ``repro.core.desim.hlo_cost.Cost``, already per-device) plus the
        whole-model optimizer-state size.  ``restore_factor`` covers
        restore read + re-init being slower than the write."""
        per = state_bytes / max(chips, 1)
        return cls(step_flops=step_cost.flops, step_bytes=step_cost.bytes,
                   ckpt_bytes=per, restore_bytes=per * restore_factor)

    @classmethod
    def from_params(cls, num_params: float, *, tokens_per_batch: int,
                    dtype_bytes: float = 2.0, optim_bytes: float = 12.0,
                    chips: int = 1, restore_factor: float = 1.5
                    ) -> "TrainStepCost":
        """Analytic model: 6 flops per param per token (fwd+bwd),
        ~3 weight passes of HBM traffic per step, and a checkpoint of
        weights + optimizer state (``optim_bytes`` per param: fp32
        master + two Adam moments by default).  ``restore_factor``
        covers restore read + re-init being slower than the write."""
        state = num_params * (dtype_bytes + optim_bytes) / max(chips, 1)
        return cls(
            step_flops=6.0 * num_params * tokens_per_batch / max(chips, 1),
            step_bytes=3.0 * num_params * dtype_bytes / max(chips, 1),
            ckpt_bytes=state, restore_bytes=restore_factor * state)


# ---------------------------------------------------------------------------
# TrainSim
# ---------------------------------------------------------------------------

class TrainSim(SimObject, DynamicWorkload):
    """Fault-injected large-scale training on the event engine.

    The training counterpart of :class:`ServeSim`: steps are injected
    into the live run one at a time (``inject_op``), costed by the
    :class:`TrainStepCost` roofline, and a seeded
    :class:`~repro.train.ft_policy.FailureSchedule` drives
    checkpoint / declare-dead / elastic-reshard decisions through the
    *identical* pure :class:`~repro.train.ft_policy.FTPolicy` the real
    ``Trainer.run_ft`` loop uses — so DES and real-trainer recovery
    decision logs match exactly (tests/test_train_ft_policy.py).

    Timeline model (one op chain on pod 0; the SPMD fleet is folded
    into the per-chip roofline costs, scaled by the elastic mesh's
    ``capacity``):

    * a ``step`` attempt costs ``step_flops/bytes * slowdown /
      capacity`` (stragglers slow the whole SPMD step);
    * a checkpoint (cadence or preemption notice) costs
      ``ckpt_bytes / capacity`` of HBM traffic;
    * a ``stall`` attempt (a silent pod hangs the collective until the
      policy declares it dead) costs one nominal step;
    * a ``recover`` attempt costs ``restore_bytes / capacity``.

    Pod deaths and mesh reshards surface as ``POD_FAILED`` / ``RESHARD``
    exit events from ``Simulator.run()`` (``exit_on_fault``).
    Checkpoint/restore of the *simulation* (``state_dict`` /
    ``load_state_dict`` + the executor snapshot) is bit-identical even
    mid-failure-recovery, like every other workload.
    """

    exit_on_fault = Param(bool, True,
                          "surface pod deaths / reshards as exit events")

    def __init__(self, name: str = "train", *, cost: TrainStepCost,
                 policy: FTPolicy, schedule: FailureSchedule, **params):
        super().__init__(name, **params)
        self.cost = cost
        self.policy = policy
        self.schedule = schedule
        self._ex = None
        self._chip = None
        self._started = False
        self._phases: Deque[List[Any]] = deque()   # [tag, flops, bytes]
        self._seq = 0
        self._last_end = 0
        self._done_steps = 0     # step ops COMPLETED, net of rollbacks
        self.pending_exits: Deque[Dict[str, Any]] = deque()
        s = self.stats
        self.s_attempts = s.scalar("attempts", "step executions attempted")
        self.s_steps = s.scalar("steps_done", "step executions completed")
        self.s_stalls = s.scalar("stalls", "attempts hung on a silent pod")
        self.s_failures = s.scalar("pods_dead", "pods declared dead")
        self.s_preempts = s.scalar("preemptions", "pods preempted")
        self.s_joins = s.scalar("pods_joined", "pods (re)joined")
        self.s_stragglers = s.scalar("stragglers", "straggler episodes")
        self.s_ckpts = s.scalar("checkpoints", "checkpoints written")
        self.s_restores = s.scalar("restores", "checkpoint restores")
        self.s_reshards = s.scalar("reshards", "elastic mesh reshards")
        self.s_lost = s.scalar("lost_steps", "completed steps rolled back")
        self.p_step = s.percentiles("step_time", "per-step sim time", "s")
        s.formula("goodput", lambda: self.goodput())

    # -- DynamicWorkload: lifecycle --------------------------------------
    def bind(self, executor) -> None:
        self._ex = executor
        self._chip = executor.machine.pod.chip
        executor.injection_hook = self._on_op_done

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for d in self.policy.start():
            self._note(d, 0)
        # the policy's initial checkpoint is a real (costed) write
        self._phases.append(["ckpt", 0.0,
                             self.cost.ckpt_bytes
                             / max(self.policy.capacity(), 1e-9)])
        self._advance_chain(0)

    def next_event_tick(self) -> Optional[int]:
        return None          # self-driving: completions trigger injection

    def poll(self, tick: int) -> None:
        pass

    def done(self) -> bool:
        return (self._started and self.policy.done()
                and not self._phases)

    # -- the training engine ---------------------------------------------
    def _advance_chain(self, now: int) -> None:
        while not self._phases and not self.policy.done():
            plan = self.policy.execute_step(
                self.schedule.events_at(self.policy.attempt))
            self._account(plan)
            for d in plan.decisions:
                self._note(d, now)
            self._plan_phases(plan)
        if self._phases:
            tag, fl, by = self._phases.popleft()
            self._seq += 1
            self._ex.inject_op(
                TraceOp("compute", flops=fl, bytes=by,
                        name=f"train/{tag}/{self._seq}"),
                ready=int(now), pod=0)

    def _plan_phases(self, plan: StepPlan) -> None:
        cap = max(plan.capacity, 1e-9)
        c = self.cost
        if plan.pre_save is not None:
            self._phases.append(["ckpt", 0.0, c.ckpt_bytes / cap])
        if plan.kind == "step":
            self._phases.append(["step", c.step_flops * plan.slowdown / cap,
                                 c.step_bytes * plan.slowdown / cap])
            if plan.post_save is not None:
                self._phases.append(["ckpt", 0.0, c.ckpt_bytes / cap])
        elif plan.kind == "stall":
            # the collective hangs for one heartbeat (~one step time)
            self._phases.append(["stall", c.step_flops / cap,
                                 c.step_bytes / cap])
        else:                                    # "recover"
            self._phases.append(["restore", 0.0, c.restore_bytes / cap])

    def _account(self, plan: StepPlan) -> None:
        # "step" completions count in _on_op_done, so a mid-run stats
        # snapshot never includes the in-flight step
        self.s_attempts.inc()
        if plan.kind == "stall":
            self.s_stalls.inc()
        elif plan.kind == "recover":
            self.s_lost.inc(plan.lost_steps)
            # the rolled-back steps all finished executing (ops run
            # sequentially), so the completed counter rewinds exactly
            self._done_steps -= plan.lost_steps

    def _note(self, d: FTDecision, tick: int) -> None:
        kind_stat = {"checkpoint": self.s_ckpts,
                     "pod_dead": self.s_failures,
                     "pod_joined": self.s_joins,
                     "preempt": self.s_preempts,
                     "straggler": self.s_stragglers,
                     "restore": self.s_restores,
                     "reshard": self.s_reshards}.get(d.kind)
        if kind_stat is not None:
            kind_stat.inc()
        if not self.exit_on_fault:
            return
        if d.kind == "pod_dead":
            self.pending_exits.append({
                "tick": tick, "kind": "pod_failed",
                "cause": f"pod {d.pod} dead at step {d.step} "
                         f"(attempt {d.attempt})",
                "payload": {"pod": d.pod, "step": d.step,
                            "attempt": d.attempt, "note": d.note}})
        elif d.kind == "reshard":
            self.pending_exits.append({
                "tick": tick, "kind": "reshard",
                "cause": f"reshard to {'x'.join(map(str, d.mesh))} "
                         f"({d.chips} chips) at step {d.step}",
                "payload": {"mesh": list(d.mesh), "chips": d.chips,
                            "step": d.step, "attempt": d.attempt}})

    def _on_op_done(self, op: TraceOp, idx: int, pod: int, start: int,
                    end: int) -> None:
        name = op.name or ""
        if not name.startswith("train/"):
            return
        self._last_end = max(self._last_end, end)
        if name.split("/")[1] == "step":
            self._done_steps += 1
            self.s_steps.inc()
            self.p_step.sample((end - start) / TICKS_PER_S)
        self._advance_chain(end)

    # -- results -----------------------------------------------------------
    def ideal_step_s(self) -> float:
        """Full-capacity fault-free step time on the bound machine."""
        if self._chip is None:
            raise RuntimeError("TrainSim not bound to an executor yet")
        return self._chip.compute_time_s(self.cost.step_flops,
                                         self.cost.step_bytes)

    def goodput(self) -> float:
        """Useful work over wall time: ``completed_steps *
        ideal_step_time / makespan`` (1.0 = fault-free, full-capacity
        perfection).  Counts *net* completed steps (rollbacks
        subtract), so a mid-run read — a stats dump at a pause, a
        checkpoint — is honest, not scaled to the full plan."""
        if self._chip is None or self._last_end <= 0:
            return 0.0
        ideal = self._done_steps * self.ideal_step_s()
        return ideal / (self._last_end / TICKS_PER_S)

    def summary(self) -> Dict[str, float]:
        """Training-run result row (the goodput frontier point)."""
        return {
            "steps": float(self.policy.num_steps),
            "attempts": self.s_attempts.value(),
            "makespan_s": self._last_end / TICKS_PER_S,
            "ideal_step_s": self.ideal_step_s(),
            "goodput": self.goodput(),
            "pods_dead": self.s_failures.value(),
            "stalls": self.s_stalls.value(),
            "checkpoints": self.s_ckpts.value(),
            "restores": self.s_restores.value(),
            "reshards": self.s_reshards.value(),
            "lost_steps": self.s_lost.value(),
        }

    # -- checkpointing -----------------------------------------------------
    def _schedule_digest(self) -> str:
        rows = [[e.attempt, e.kind, e.pod, e.slowdown, e.duration,
                 e.repair] for e in self.schedule.events]
        return hashlib.sha1(json.dumps(rows).encode()).hexdigest()[:16]

    def state_dict(self) -> Dict[str, Any]:
        return {
            "num_events": len(self.schedule.events),
            "schedule_digest": self._schedule_digest(),
            "started": self._started,
            "seq": self._seq,
            "last_end": self._last_end,
            "done_steps": self._done_steps,
            "phases": [list(p) for p in self._phases],
            "policy": self.policy.state_dict(),
            "pending_exits": [dict(e) for e in self.pending_exits],
            "stats": self.stats.state_dict(),
        }

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        mine = self._schedule_digest()
        if int(d["num_events"]) != len(self.schedule.events) \
                or d.get("schedule_digest", mine) != mine:
            raise ValueError(
                "checkpoint was taken under a different failure "
                f"schedule ({d['num_events']} events, digest "
                f"{d.get('schedule_digest')}) than this TrainSim's "
                f"({len(self.schedule.events)} events, digest {mine}) "
                "— rebuild with the same seed/params")
        self._started = bool(d["started"])
        self._seq = int(d["seq"])
        self._last_end = int(d["last_end"])
        self._done_steps = int(d.get("done_steps", 0))
        self._phases = deque([p[0], float(p[1]), float(p[2])]
                             for p in d["phases"])
        self.policy.load_state_dict(d["policy"])
        self.pending_exits = deque(dict(e) for e in d["pending_exits"])
        self.stats.load_state_dict(d["stats"])
