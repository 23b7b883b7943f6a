"""A copy of ``repro.sim.fleet`` (pure Python): the port imports
nothing of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

FleetSim: autoscaled datacenter-scale serving on the event engine.

The layer above :class:`repro.sim.workloads.ServeSim` the ROADMAP's
"millions of users" story needs: a *fleet* of continuous-batching
replicas (one per pod of a ``v5e_fleet`` board) behind a request
router and an autoscaler, both driven by the pure
:class:`repro.serve.fleet_policy.FleetPolicy` — the *identical* policy
object the real :class:`repro.serve.fleet.FleetController` wraps, so
DES and real-controller decision logs match exactly (test-enforced,
tests/test_fleet_sim.py).

The model, in one paragraph: seeded traffic (diurnal curves, flash
crowds, heavy-tailed lognormal prompt/decode lengths, multi-tenant
priority classes) arrives as tick-stamped :class:`FleetRequest`s; the
policy routes each to a replica (round-robin / least-loaded /
power-of-two-choices / prefix-cache-affinity), where it runs through
the same ``SlotScheduler`` continuous-batching loop and
:class:`~repro.sim.workloads.ServingCost` roofline ops as ServeSim; at
every control boundary the policy compares load and SLO pressure
against its watermarks and scales the fleet — a scaled-up replica
spends ``cold_start_ticks`` *warming* (it queues work but does not
execute: the cold start is a first-class simulated cost that shows up
in TTFT), and only idle replicas are retired, so no drain protocol
exists.  Scale actions surface as ``SCALE_UP`` / ``SCALE_DOWN`` exit
events from ``Simulator.run()``.

Liveness: ``next_event_tick`` is the earlier of the next arrival and
``policy.next_wake()`` (the next control boundary or warming-replica
promotion), so the co-simulation always has a wake point while
requests remain; every queued request is eventually served because
routing only targets live/warming replicas and every promotion gets a
wake at its exact ready tick.

The run records a ``feed`` — the ordered, tick-stamped policy event
stream (routes, finishes with SLO verdicts, observation ticks).
Replaying it through a fresh ``FleetController`` (its ``replay``) is
the decision-log identity test: the controller re-makes every routing
and scaling decision from events alone and must match bit-for-bit.

Like ServeSim, only per-pod compute ops are injected, so FleetSim is
tick-exact under ``timing="atomic"`` — the fleet sweeps
(``benchmarks/fleet_sweep.py``) default to atomic with a detailed
spot-check.  ``span_s`` in ``summary()`` is measured from the first
submitted request to the last finish (not from tick 0), and empty
percentile sketches report NaN, never a fake 0.0.
"""

from __future__ import annotations

import hashlib
import heapq
import json
import math
import random
from collections import deque
from dataclasses import dataclass
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

from repro_torch.core.desim.simnodes import TICKS_PER_S, to_ticks
from repro_torch.core.desim.trace import TraceOp
from repro_torch.core.simobject import Param, SimObject
from repro_torch.serve.fleet_policy import LIVE, FleetPolicy
from repro_torch.serve.policy import SlotScheduler
from repro_torch.sim.workloads import DynamicWorkload, ServingCost


# ---------------------------------------------------------------------------
# requests and traffic models
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FleetRequest:
    """One fleet request.  ``rid`` equals its index in the request
    list; ``tenant`` picks the priority class and SLO multiplier;
    ``prefix_group`` (>= 0) marks requests sharing a cacheable prompt
    prefix (what the affinity router keys on)."""

    rid: int
    prompt_len: int
    decode_len: int
    arrival_tick: int = 0
    tenant: str = "interactive"
    prefix_group: int = -1


def _lognormal(rng: random.Random, median: float, sigma: float,
               lo: int, hi: int) -> int:
    """Heavy-tailed length draw: lognormal with the given median,
    clamped to ``[lo, hi]`` (production length distributions are
    famously lognormal-ish with a hard context cap)."""
    return max(lo, min(hi, int(rng.lognormvariate(math.log(median), sigma))))


def _pick_tenant(rng: random.Random,
                 tenants: Sequence[Tuple[str, float]]) -> str:
    u = rng.random() * sum(w for _, w in tenants)
    for name, w in tenants:
        u -= w
        if u <= 0:
            return name
    return tenants[-1][0]


def _thinned_requests(num_requests: int, *, seed: int, peak_rps: float,
                      rate_fn: Callable[[float], float],
                      prompt_lognorm: Tuple[float, float, int, int],
                      decode_lognorm: Tuple[float, float, int, int],
                      tenants: Sequence[Tuple[str, float]],
                      prefix_groups: int) -> List[FleetRequest]:
    """Non-homogeneous Poisson arrivals by thinning a homogeneous
    ``peak_rps`` process (Lewis–Shedler): exact, and fully determined
    by ``seed``."""
    if peak_rps <= 0:
        raise ValueError("peak rate must be positive")
    rng = random.Random(seed)
    out: List[FleetRequest] = []
    t = 0.0
    while len(out) < num_requests:
        t += rng.expovariate(peak_rps)
        accept = rng.random() < rate_fn(t) / peak_rps
        # draw attributes unconditionally so the stream at one seed is
        # a prefix-stable function of the arrival index
        p = _lognormal(rng, *prompt_lognorm)
        d = _lognormal(rng, *decode_lognorm)
        tenant = _pick_tenant(rng, tenants)
        group = rng.randrange(prefix_groups) if prefix_groups > 0 else -1
        if accept:
            out.append(FleetRequest(
                rid=len(out), prompt_len=p, decode_len=d,
                arrival_tick=to_ticks(t), tenant=tenant,
                prefix_group=group))
    return out


DEFAULT_TENANTS: Tuple[Tuple[str, float], ...] = (("interactive", 0.8),
                                                  ("batch", 0.2))
DEFAULT_PROMPT = (128.0, 1.0, 8, 768)     # (median, sigma, lo, hi)
DEFAULT_DECODE = (32.0, 0.8, 4, 192)


def diurnal_requests(num_requests: int, *, seed: int, base_rps: float,
                     peak_rps: float, period_s: float,
                     prompt_lognorm: Tuple[float, float, int, int]
                     = DEFAULT_PROMPT,
                     decode_lognorm: Tuple[float, float, int, int]
                     = DEFAULT_DECODE,
                     tenants: Sequence[Tuple[str, float]] = DEFAULT_TENANTS,
                     prefix_groups: int = 0) -> List[FleetRequest]:
    """A diurnal rate curve: sinusoid from ``base_rps`` (trough, at
    t=0) to ``peak_rps`` over ``period_s``-second days."""
    if peak_rps < base_rps:
        raise ValueError("peak_rps must be >= base_rps")

    def rate(t: float) -> float:
        phase = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / period_s))
        return base_rps + (peak_rps - base_rps) * phase

    return _thinned_requests(num_requests, seed=seed, peak_rps=peak_rps,
                             rate_fn=rate, prompt_lognorm=prompt_lognorm,
                             decode_lognorm=decode_lognorm,
                             tenants=tenants, prefix_groups=prefix_groups)


def flash_crowd_requests(num_requests: int, *, seed: int, base_rps: float,
                         crowd_rps: float, crowd_start_s: float,
                         crowd_len_s: float,
                         prompt_lognorm: Tuple[float, float, int, int]
                         = DEFAULT_PROMPT,
                         decode_lognorm: Tuple[float, float, int, int]
                         = DEFAULT_DECODE,
                         tenants: Sequence[Tuple[str, float]]
                         = DEFAULT_TENANTS,
                         prefix_groups: int = 0) -> List[FleetRequest]:
    """A flash crowd: steady ``base_rps`` with a burst to ``crowd_rps``
    during ``[crowd_start_s, crowd_start_s + crowd_len_s)``."""
    if crowd_rps < base_rps:
        raise ValueError("crowd_rps must be >= base_rps")

    def rate(t: float) -> float:
        in_crowd = crowd_start_s <= t < crowd_start_s + crowd_len_s
        return crowd_rps if in_crowd else base_rps

    return _thinned_requests(num_requests, seed=seed, peak_rps=crowd_rps,
                             rate_fn=rate, prompt_lognorm=prompt_lognorm,
                             decode_lognorm=decode_lognorm,
                             tenants=tenants, prefix_groups=prefix_groups)


# ---------------------------------------------------------------------------
# FleetSim
# ---------------------------------------------------------------------------

class _FleetReplica:
    """One replica (one pod): scheduler + in-flight tracking, exactly
    ServeSim's per-pod shape.  Whether the replica may *execute* is the
    policy's call (``state == live``), not stored here."""

    def __init__(self, pod: int, sched: SlotScheduler):
        self.pod = pod
        self.sched = sched
        self.busy = False


def _nan_if_empty(stat, value: float) -> float:
    return value if stat.count else float("nan")


class FleetSim(SimObject, DynamicWorkload):
    """Autoscaled fleet serving as a :class:`DynamicWorkload`.

    Replica ``r`` runs on pod ``r`` of the bound machine (a
    ``v5e_fleet`` board sized to ``policy.max_replicas``); decode batch
    size per replica is ``policy.slots_per_replica``.  See the module
    docstring for the model and ``docs/serving.md`` for the exactness
    bar.
    """

    seq_capacity = Param(int, 2048, "KV capacity (tokens) per slot",
                         check=lambda v: v >= 2)
    slo_ttft_s = Param(float, 0.0, "TTFT SLO in seconds (0 = none)")
    slo_latency_s = Param(float, 0.0, "request-latency SLO (0 = none)")
    exit_on_slo = Param(bool, False,
                        "surface each SLO violation as an exit event")
    exit_on_scale = Param(bool, True,
                          "surface autoscaler actions as exit events")

    def __init__(self, name: str = "fleet", *, cost: ServingCost,
                 requests: List[FleetRequest], policy: FleetPolicy,
                 tenant_slo: Optional[Dict[str, float]] = None,
                 tenant_priority: Sequence[str] = ("interactive", "batch"),
                 **params):
        super().__init__(name, **params)
        if not requests:
            raise ValueError("FleetSim needs at least one request")
        for i, r in enumerate(requests):
            if r.rid != i:
                raise ValueError(f"request {i} has rid {r.rid}; rids must "
                                 "equal list indices")
            if r.prompt_len >= self.seq_capacity:
                raise ValueError(
                    f"request {i}: prompt_len {r.prompt_len} does not fit "
                    f"seq_capacity {self.seq_capacity}")
            if r.decode_len < 1 or r.prompt_len < 1:
                raise ValueError(
                    f"request {i}: prompt_len/decode_len must be >= 1")
        self.cost = cost
        self.policy = policy
        self._requests = list(requests)
        self._tenant_slo = dict(tenant_slo or {})
        self._rank = {t: i for i, t in enumerate(tenant_priority)}
        self._ex = None
        self._reps: Optional[List[_FleetReplica]] = None
        self._heap: List[Tuple[int, int, int]] = []  # (tick, rank, rid)
        self._done_count = 0
        self._started = False
        self._pcursor = 0          # policy decisions already drained
        self._peak_serving = 0
        self.feed: List[List[Any]] = []   # the replayable event stream
        self.pending_exits: Deque[Dict[str, Any]] = deque()
        self._rt: Dict[int, Dict[str, Any]] = {}
        s = self.stats
        self.s_admitted = s.scalar("admitted", "requests admitted to slots")
        self.s_requests = s.scalar("requests_done", "requests completed")
        self.s_tokens = s.scalar("tokens_out", "decode tokens generated")
        self.s_decode_steps = s.scalar("decode_steps", "batched decode steps")
        self.s_prefills = s.scalar("prefills", "prefill ops run")
        self.s_slo_viol = s.scalar("slo_violations", "requests over SLO")
        self.s_scale_ups = s.scalar("scale_ups", "replicas scaled up")
        self.s_scale_downs = s.scalar("scale_downs", "replicas scaled down")
        self.p_ttft = s.percentiles("ttft", "time to first token", "s")
        self.p_tpot = s.percentiles("tpot", "time per output token", "s")
        self.p_latency = s.percentiles("latency", "request latency", "s")
        self.p_queue_wait = s.percentiles("queue_wait",
                                          "arrival-to-admission wait", "s")
        self.d_batch = s.distribution("decode_batch",
                                      "active slots per decode step")
        self.p_ttft_tenant = {
            t: s.percentiles(f"ttft_{t}", f"TTFT of tenant {t}", "s")
            for t in sorted({r.tenant for r in requests})}

    # -- DynamicWorkload: lifecycle --------------------------------------
    def bind(self, executor) -> None:
        self._ex = executor
        executor.injection_hook = self._on_op_done
        if self._reps is None:
            pods = executor.machine.num_pods
            if pods < self.policy.max_replicas:
                raise ValueError(
                    f"policy allows up to {self.policy.max_replicas} "
                    f"replicas but the machine has {pods} pods — use a "
                    "v5e_fleet board sized to max_replicas")
            self._reps = [
                _FleetReplica(p, SlotScheduler(
                    self.policy.slots_per_replica, self.seq_capacity))
                for p in range(self.policy.max_replicas)]

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self.policy.start()
        self._drain_policy()
        # same-tick arrivals are routed in priority order (then rid) —
        # the multi-tenant classes' only scheduling privilege
        self._heap = [(r.arrival_tick,
                       self._rank.get(r.tenant, len(self._rank)), r.rid)
                      for r in self._requests]
        heapq.heapify(self._heap)

    def next_event_tick(self) -> Optional[int]:
        arrival = self._heap[0][0] if self._heap else None
        wake = self.policy.next_wake()
        return wake if arrival is None else min(arrival, wake)

    def poll(self, tick: int) -> None:
        t = int(tick)
        self.feed.append(["tick", t])
        self.policy.observe(t)
        self._drain_policy()
        self._catch_up(t)
        self._reconcile(t)

    def done(self) -> bool:
        return self._done_count == len(self._requests)

    # -- the fleet engine -------------------------------------------------
    def _catch_up(self, t: int) -> None:
        """Route + submit every arrival with tick <= ``t`` in
        (tick, priority, rid) order, then wake idle live replicas that
        received work, at the exact arrival tick (ServeSim's contract,
        with the policy replacing rid-round-robin dispatch)."""
        while self._heap and self._heap[0][0] <= t:
            tick = self._heap[0][0]
            touched: List[_FleetReplica] = []
            while self._heap and self._heap[0][0] == tick:
                _, _, rid = heapq.heappop(self._heap)
                req = self._requests[rid]
                self.feed.append(["route", tick, rid])
                ridx = self.policy.route(tick, rid, tenant=req.tenant,
                                         prefix=req.prefix_group)
                self._drain_policy()
                rep = self._reps[ridx]
                rep.sched.submit(rid, req.prompt_len, req.decode_len)
                self._rt[rid] = {"submit": tick, "first": -1, "finish": -1,
                                 "ok": True}
                if rep not in touched:
                    touched.append(rep)
            for rep in touched:
                if not rep.busy and self.policy.state(rep.pod) == LIVE:
                    self._iteration(rep, tick)

    def _reconcile(self, t: int) -> None:
        """Wake any idle live replica holding queued work — how a
        freshly-promoted (warming -> live) replica starts serving its
        cold-start queue at exactly its ready tick."""
        for rep in self._reps:
            if (not rep.busy and not rep.sched.idle()
                    and self.policy.state(rep.pod) == LIVE):
                self._iteration(rep, t)

    def _iteration(self, rep: _FleetReplica, now: int) -> None:
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
                        name=f"fleet/p{rep.pod}/prefill/r{rid}"),
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
                    name=f"fleet/p{rep.pod}/decode/s{sched.steps}"),
            ready=now, pod=rep.pod)
        rep.busy = True

    def _on_op_done(self, op: TraceOp, idx: int, pod: int, start: int,
                    end: int) -> None:
        parts = (op.name or "").split("/")
        if len(parts) < 3 or parts[0] != "fleet":
            return
        rep = self._reps[pod]
        if parts[2] == "prefill":
            rid = int(parts[3][1:])
            rt = self._rt[rid]
            rt["first"] = end
            ttft = (end - rt["submit"]) / TICKS_PER_S
            self.p_ttft.sample(ttft)
            self.p_ttft_tenant[self._requests[rid].tenant].sample(ttft)
            return
        sched = rep.sched
        sched.note_step()
        self.s_decode_steps.inc()
        for slot in sched.active_slots():
            rid = sched.active[slot]
            self.s_tokens.inc()
            fin = sched.complete_token(slot)
            if fin is not None:
                self._finish_request(rid, end, rep)
        self._catch_up(end)
        if self.policy.state(rep.pod) == LIVE:
            self._iteration(rep, end)
        else:
            rep.busy = False     # retired while idle: stays parked
        self._reconcile(end)

    def _finish_request(self, rid: int, end: int,
                        rep: _FleetReplica) -> None:
        rt = self._rt[rid]
        rt["finish"] = end
        req = self._requests[rid]
        latency = (end - rt["submit"]) / TICKS_PER_S
        tokens = rep.sched.requests[rid].tokens_out
        ttft = (rt["first"] - rt["submit"]) / TICKS_PER_S
        tpot = ((end - rt["first"]) / TICKS_PER_S) / max(tokens - 1, 1)
        self.p_latency.sample(latency)
        self.p_tpot.sample(tpot)
        self.s_requests.inc()
        self._done_count += 1
        factor = self._tenant_slo.get(req.tenant, 1.0)
        violated = ((self.slo_ttft_s > 0
                     and ttft > self.slo_ttft_s * factor)
                    or (self.slo_latency_s > 0
                        and latency > self.slo_latency_s * factor))
        if violated:
            rt["ok"] = False
            self.s_slo_viol.inc()
            if self.exit_on_slo:
                self.pending_exits.append({
                    "tick": end, "cause": f"slo violation: request {rid}",
                    "payload": {"rid": rid, "tenant": req.tenant,
                                "ttft_s": ttft, "latency_s": latency}})
        self.feed.append(["finish", end, rid, rep.pod, int(not violated)])
        self.policy.finish(end, rid, ok=not violated)
        self._drain_policy()

    def _drain_policy(self) -> None:
        """Mirror fresh policy decisions into stats + exit events."""
        new = self.policy.decisions[self._pcursor:]
        self._pcursor = len(self.policy.decisions)
        if new:
            self._peak_serving = max(
                self._peak_serving, len(self.policy.serving_replicas()))
        for d in new:
            if d.kind == "scale_up":
                self.s_scale_ups.inc()
                if self.exit_on_scale:
                    self.pending_exits.append({
                        "tick": d.tick, "kind": "scale_up",
                        "cause": f"scale up: replica {d.replica} warming "
                                 f"({d.note})",
                        "payload": {"replica": d.replica, "note": d.note,
                                    "ready_tick": d.tick
                                    + self.policy.cold_start_ticks}})
            elif d.kind == "scale_down":
                self.s_scale_downs.inc()
                if self.exit_on_scale:
                    self.pending_exits.append({
                        "tick": d.tick, "kind": "scale_down",
                        "cause": f"scale down: replica {d.replica} retired "
                                 f"({d.note})",
                        "payload": {"replica": d.replica, "note": d.note}})

    # -- results -----------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        """Fleet-level result row.  ``span_s`` runs from the first
        *submitted* request to the last finish; percentile keys are NaN
        when no sample landed (a zero-finish run must not look
        perfect)."""
        finished = [rt for rt in self._rt.values() if rt["finish"] >= 0]
        if finished:
            first = min(rt["submit"] for rt in finished)
            span_s = (max(rt["finish"] for rt in finished)
                      - first) / TICKS_PER_S
        else:
            span_s = 0.0
        ok = sum(1 for rt in finished if rt["ok"])
        out = {
            "requests": float(len(finished)),
            "span_s": span_s,
            "throughput_rps": len(finished) / span_s if span_s else 0.0,
            "goodput_rps": ok / span_s if span_s else 0.0,
            "slo_violations": self.s_slo_viol.value(),
            "tokens_out": self.s_tokens.value(),
            "p50_ttft_s": _nan_if_empty(self.p_ttft,
                                        self.p_ttft.quantile(0.50)),
            "p99_ttft_s": _nan_if_empty(self.p_ttft,
                                        self.p_ttft.quantile(0.99)),
            "p50_latency_s": _nan_if_empty(self.p_latency,
                                           self.p_latency.quantile(0.50)),
            "p99_latency_s": _nan_if_empty(self.p_latency,
                                           self.p_latency.quantile(0.99)),
            "mean_tpot_s": _nan_if_empty(self.p_tpot, self.p_tpot.mean),
            "mean_batch": _nan_if_empty(self.d_batch, self.d_batch.mean),
            "scale_ups": self.s_scale_ups.value(),
            "scale_downs": self.s_scale_downs.value(),
            "replicas_peak": float(self._peak_serving),
            "replicas_final": float(len(self.policy.live_replicas())),
            "cold_start_s": self.policy.cold_start_ticks / TICKS_PER_S,
        }
        for tenant, p in self.p_ttft_tenant.items():
            out[f"p99_ttft_{tenant}_s"] = _nan_if_empty(
                p, p.quantile(0.99))
        return out

    def slo_ok_frac(self, after_s: float = 0.0) -> float:
        """Fraction of finished requests *submitted after* ``after_s``
        that met their SLO — the recovery metric (did the fleet return
        to compliance once the autoscaler reacted?).  NaN when nothing
        in the window finished."""
        after = to_ticks(after_s)
        rts = [rt for rt in self._rt.values()
               if rt["finish"] >= 0 and rt["submit"] >= after]
        if not rts:
            return float("nan")
        return sum(1 for rt in rts if rt["ok"]) / len(rts)

    # -- checkpointing -----------------------------------------------------
    def _requests_digest(self) -> str:
        rows = [[r.rid, r.prompt_len, r.decode_len, r.arrival_tick,
                 r.tenant, r.prefix_group] for r in self._requests]
        return hashlib.sha1(json.dumps(rows).encode()).hexdigest()[:16]

    def state_dict(self) -> Dict[str, Any]:
        return {
            "num_requests": len(self._requests),
            "requests_digest": self._requests_digest(),
            "started": self._started,
            "done_count": self._done_count,
            "pcursor": self._pcursor,
            "peak_serving": self._peak_serving,
            "heap": sorted([t, k, r] for t, k, r in self._heap),
            "runtime": {str(rid): dict(rt) for rid, rt in self._rt.items()},
            "reps": [{"pod": rep.pod, "busy": rep.busy,
                      "sched": rep.sched.state_dict()}
                     for rep in (self._reps or [])],
            "policy": self.policy.state_dict(),
            "feed": [list(row) for row in self.feed],
            "pending_exits": [dict(e) for e in self.pending_exits],
            "stats": self.stats.state_dict(),
        }

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        mine = self._requests_digest()
        if int(d["num_requests"]) != len(self._requests) \
                or d.get("requests_digest", mine) != mine:
            raise ValueError(
                "checkpoint was taken under a different request stream "
                f"({d['num_requests']} requests, digest "
                f"{d.get('requests_digest')}) than this FleetSim's "
                f"({len(self._requests)}, digest {mine}) — rebuild with "
                "the same seed/params")
        if self._reps is None:
            raise RuntimeError("bind() the FleetSim before loading state")
        # validate the policy configuration first: its mismatch message
        # names the offending knob, which a per-replica scheduler shape
        # error downstream would obscure
        self.policy.load_state_dict(d["policy"])
        self._started = bool(d["started"])
        self._done_count = int(d["done_count"])
        self._pcursor = int(d["pcursor"])
        self._peak_serving = int(d["peak_serving"])
        self._heap = [(int(t), int(k), int(r)) for t, k, r in d["heap"]]
        heapq.heapify(self._heap)
        self._rt = {int(rid): dict(rt) for rid, rt in d["runtime"].items()}
        for rep, rd in zip(self._reps, d["reps"]):
            rep.busy = bool(rd["busy"])
            rep.sched = SlotScheduler(self.policy.slots_per_replica,
                                      self.seq_capacity)
            rep.sched.load_state_dict(rd["sched"])
        self.feed = [list(row) for row in d["feed"]]
        self.pending_exits = deque(dict(e) for e in d["pending_exits"])
        self.stats.load_state_dict(d["stats"])
