"""A copy of ``repro.sim.instrument`` (pure Python): the port imports
nothing of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

m5out, Perfetto timelines, and host telemetry (paper §2.21, §3).

gem5 drops every run's artifacts into an output directory (``m5out/``
by default): ``stats.txt`` with one *section* per dump (bracketed by
``Begin/End Simulation Statistics``), ``config.json`` describing the
instantiated SimObject graph, and a closing banner reporting how fast
the host simulated (simSeconds, hostSeconds, simRate).  This module is
that layer for the desim stack, plus a Chrome/Perfetto trace-event
exporter gem5 never had but its users keep rebuilding (see PAPERS.md
on call-stack profiling — *seeing where simulated time goes is itself
a research instrument*):

* :class:`OutDir` — the m5out analogue the Simulator can own.
* :func:`render_stats_txt` — gem5-format stats sections from the
  existing :class:`~repro.core.stats.StatGroup` tree (``path.stat
  value  # desc (unit)``; dict/vector values expand as ``::key`` rows).
* :class:`TraceEventRecorder` — collects op issue/complete, DCN
  rendezvous, and quantum barriers as compact rows during the run and
  renders them to trace-event JSON (`ui.perfetto.dev` /
  ``chrome://tracing``) with per-pod compute/ICI lanes, a coordinator
  lane for DCN transactions + barriers, and — under the
  ParallelEngine — one process group per worker, merged into a single
  coherent file.
* :func:`host_record` / :func:`format_host_banner` — the machine-
  readable exit record and the human banner line.

House rule: everything here only *reads* simulation state (recorder
hooks append to Python lists; stats rendering walks the tree).  A run
with tracing fully enabled is bit-identical to a silent one —
``tests/test_observability.py`` enforces it, serial and workers=4.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.desim.simnodes import TICKS_PER_S
from repro_torch.core.stats import StatGroup

# ---------------------------------------------------------------------------
# gem5-format stats.txt rendering
# ---------------------------------------------------------------------------

_BEGIN = "---------- Begin Simulation Statistics ----------"
_END = "---------- End Simulation Statistics    ----------"


def _fmt_value(v: Any) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, float):
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return f"{v:.6f}"
    return str(v)


def _stat_lines(key: str, value: Any, desc: str, unit: str) -> List[str]:
    comment = ""
    if desc or unit:
        comment = f" # {desc}" if desc else " #"
        if unit:
            comment += f" ({unit})"
    if isinstance(value, dict):
        return [f"{f'{key}::{k}':<56} {_fmt_value(v):>14}{comment}"
                for k, v in value.items()]
    if isinstance(value, (list, tuple)):
        return [f"{f'{key}::{i}':<56} {_fmt_value(v):>14}{comment}"
                for i, v in enumerate(value)]
    return [f"{key:<56} {_fmt_value(value):>14}{comment}"]


def render_stats_txt(groups: Iterable[StatGroup],
                     extra: Optional[Dict[str, Any]] = None,
                     reason: str = "") -> str:
    """One gem5 ``stats.txt`` section: every stat in the given trees as
    ``path.stat  value  # desc (unit)``, in tree order, between the
    Begin/End markers.  ``extra`` rows (host telemetry, final tick)
    come first, like gem5's simSeconds/hostSeconds block."""
    lines = [_BEGIN + (f" // {reason}" if reason else "")]
    for k, v in (extra or {}).items():
        lines.extend(_stat_lines(k, v, "", ""))

    def walk(g: StatGroup, prefix: str) -> None:
        path = f"{prefix}{g.name}"
        for name, stat in g.stats().items():
            lines.extend(_stat_lines(f"{path}.{name}", stat.value(),
                                     stat.desc, stat.unit))
        for child in g._children:
            walk(child, f"{path}.")

    for g in groups:
        walk(g, "")
    lines.append(_END)
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the m5out directory
# ---------------------------------------------------------------------------

class OutDir:
    """gem5's ``m5out/``: a per-run artifact directory owning
    ``stats.txt`` (appended a section per dump), ``config.json`` (the
    instantiated configuration), ``telemetry.json`` (the host-perf
    record), and ``trace.json`` (the Perfetto timeline).  Created
    eagerly; ``stats.txt`` is truncated so every run starts clean,
    exactly like gem5 re-running into the same m5out."""

    STATS = "stats.txt"
    CONFIG = "config.json"
    TELEMETRY = "telemetry.json"
    TRACE = "trace.json"

    def __init__(self, path: str, truncate: bool = True):
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)
        self.dumps = 0
        if truncate:
            open(self.file(self.STATS), "w").close()

    def file(self, name: str) -> str:
        return os.path.join(self.path, name)

    def dump_stats(self, groups: Iterable[StatGroup],
                   extra: Optional[Dict[str, Any]] = None,
                   reason: str = "") -> str:
        """Append one stats section; returns the rendered text."""
        text = render_stats_txt(groups, extra=extra, reason=reason)
        with open(self.file(self.STATS), "a") as f:
            f.write(text + "\n\n")
        self.dumps += 1
        return text

    def write_json(self, name: str, doc: Any) -> str:
        p = self.file(name)
        with open(p, "w") as f:
            json.dump(doc, f, indent=1, default=str)
            f.write("\n")
        return p

    def write_config(self, doc: Dict[str, Any]) -> str:
        return self.write_json(self.CONFIG, doc)


# ---------------------------------------------------------------------------
# host telemetry (the gem5 exit banner, in record + banner form)
# ---------------------------------------------------------------------------

def host_record(final_tick: int, host_seconds: float,
                events: int) -> Dict[str, Any]:
    """The machine-readable exit record: what gem5 prints at the end of
    every run (simSeconds, hostSeconds, simRate) plus the engine's
    event throughput.  Wired into ``benchmarks.run --json`` rows."""
    sim_seconds = final_tick / TICKS_PER_S
    host = max(float(host_seconds), 0.0)
    return {
        "final_tick": int(final_tick),
        "sim_seconds": sim_seconds,
        "host_seconds": host,
        "sim_rate": (sim_seconds / host) if host > 0 else 0.0,
        "events": int(events),
        "events_per_host_sec": (events / host) if host > 0 else 0.0,
    }


def format_host_banner(rec: Dict[str, Any]) -> str:
    return (f"simSeconds {rec['sim_seconds']:.6f}  "
            f"hostSeconds {rec['host_seconds']:.3f}  "
            f"simRate {rec['sim_rate']:.2f}x  "
            f"events {rec['events']}  "
            f"({rec['events_per_host_sec']:.0f}/s)")


# ---------------------------------------------------------------------------
# Perfetto / Chrome trace-event exporter
# ---------------------------------------------------------------------------

# op row layout (kept as flat lists: the executor hook runs per op x pod)
_R_POD, _R_IDX, _R_NAME, _R_KIND, _R_READY, _R_START, _R_END, _R_DCN, \
    _R_DUR = range(9)

#: pid layout of the exported trace
PID_ENGINE = 1          # serial TraceExecutor rows
PID_COORD = 2           # DCN transactions + quantum barriers
PID_WORKER0 = 10        # ParallelEngine worker w -> pid 10 + w


class TraceEventRecorder:
    """Collects timeline rows during a run; renders Chrome trace-event
    JSON afterwards.  The hot hook is :meth:`op_event` (called from
    ``TraceExecutor._on_done`` — one append per completed op per pod);
    the coordinator-side hooks (:meth:`dcn_event`, :meth:`barrier_event`,
    :meth:`add_worker`) fire per rendezvous / quantum / collect.

    The same recorder object serves serial and parallel runs, and
    survives checkpoint/restore cycles (the Simulator threads it into
    every executor it builds), so a run that switches timing models or
    worker counts mid-flight still lands in one merged file.
    """

    def __init__(self):
        self.rows: List[list] = []            # serial / facade op rows
        self.barriers: List[int] = []         # quantum barrier ticks
        self.dcn_tx: List[list] = []          # [idx, name, start, dur,
        #                                        deliver, [(pod, ready)..]]
        self.worker_rows: Dict[int, List[list]] = {}   # widx -> op rows

    # -- hot hooks (must only read + append) ---------------------------
    def op_event(self, pod: int, payload: Dict[str, Any], start: int,
                 end: int) -> None:
        """One completed op on one pod.  ``payload`` is the executor's
        in-flight record (name/kind/ready/dcn/dur...)."""
        self.rows.append([
            pod, payload.get("op_idx", -1), payload.get("name", "op"),
            payload.get("kind", "compute"), payload.get("ready", start),
            start, end, bool(payload.get("dcn")), payload.get("dur"),
        ])

    def barrier_event(self, tick: int) -> None:
        self.barriers.append(int(tick))

    def dcn_event(self, idx: int, name: str, start: int, dur: int,
                  deliver: int,
                  arrivals: Sequence[Tuple[int, int]]) -> None:
        """A cross-pod rendezvous completing (coordinator side):
        transaction occupies ``[start, start+dur)``, results delivered
        at ``deliver``; ``arrivals`` are (pod, ready-tick) pairs."""
        self.dcn_tx.append([int(idx), name, int(start), int(dur),
                            int(deliver), list(arrivals)])

    def add_worker(self, widx: int, labels: Sequence[int],
                   members: Sequence[Sequence[int]],
                   rows: Sequence[list]) -> None:
        """Merge one worker's op rows (ParallelEngine collect).  Worker
        rows are keyed by representative pod label; SPMD clone folding
        means one row stands for every member of its replica group —
        expand so the merged trace shows all pods, matching serial."""
        out = self.worker_rows.setdefault(widx, [])
        expand = {int(labels[i]): [int(g) for g in members[i]]
                  for i in range(len(labels))}
        for r in rows:
            for g in expand.get(int(r[_R_POD]), [int(r[_R_POD])]):
                rr = list(r)
                rr[_R_POD] = g
                out.append(rr)

    # -- rendering ------------------------------------------------------
    @staticmethod
    def _us(tick: int) -> float:
        return tick / 1_000.0          # 1 tick = 1 ns; trace ts is in us

    def _emit_rows(self, events: List[dict], rows: List[list],
                   pid: int) -> None:
        pods = sorted({r[_R_POD] for r in rows})
        for g in pods:
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": 2 * g,
                           "args": {"name": f"pod{g}/compute"}})
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": 2 * g + 1,
                           "args": {"name": f"pod{g}/ici+dcn"}})
        for r in rows:
            tid = 2 * r[_R_POD] + (0 if r[_R_KIND] == "compute" else 1)
            events.append({
                "name": r[_R_NAME], "cat": r[_R_KIND], "ph": "X",
                "ts": self._us(r[_R_START]),
                "dur": max(self._us(r[_R_END]) - self._us(r[_R_START]), 0.0),
                "pid": pid, "tid": tid,
                "args": {"op": r[_R_IDX], "ready_tick": r[_R_READY],
                         "start_tick": r[_R_START], "end_tick": r[_R_END]},
            })
            if r[_R_DCN]:
                # rendezvous flow arrow: this pod's arrival -> transaction
                events.append({"ph": "s", "id": int(r[_R_IDX]),
                               "name": r[_R_NAME], "cat": "dcn",
                               "pid": pid, "tid": tid,
                               "ts": self._us(r[_R_READY])})
                events.append({"ph": "f", "bp": "e", "id": int(r[_R_IDX]),
                               "name": r[_R_NAME], "cat": "dcn",
                               "pid": PID_COORD, "tid": 0,
                               "ts": self._us(r[_R_START])})

    def _derived_dcn_tx(self) -> List[list]:
        """Serial runs have no coordinator: reconstruct one transaction
        per DCN op from its (identical-across-pods) start/dur rows."""
        seen: Dict[int, list] = {}
        for rows in [self.rows, *self.worker_rows.values()]:
            for r in rows:
                if r[_R_DCN] and r[_R_IDX] not in seen:
                    dur = r[_R_DUR]
                    if dur is None:
                        dur = r[_R_END] - r[_R_START]
                    seen[r[_R_IDX]] = [r[_R_IDX], r[_R_NAME], r[_R_START],
                                       int(dur), r[_R_END], []]
        return [seen[k] for k in sorted(seen)]

    def to_chrome(self) -> Dict[str, Any]:
        """Render everything recorded so far as a trace-event document
        (``{"traceEvents": [...]}``) loadable by ui.perfetto.dev."""
        events: List[dict] = []

        def pname(pid: int, name: str) -> None:
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "args": {"name": name}})

        if self.rows:
            pname(PID_ENGINE, "engine")
            self._emit_rows(events, self.rows, PID_ENGINE)
        for widx in sorted(self.worker_rows):
            pid = PID_WORKER0 + widx
            pods = sorted({r[_R_POD] for r in self.worker_rows[widx]})
            pname(pid, f"worker{widx} (pods {pods[0]}..{pods[-1]})"
                  if pods else f"worker{widx}")
            self._emit_rows(events, self.worker_rows[widx], pid)

        pname(PID_COORD, "coordinator (dcn + quantum)")
        events.append({"ph": "M", "name": "thread_name", "pid": PID_COORD,
                       "tid": 0, "args": {"name": "dcn transactions"}})
        events.append({"ph": "M", "name": "thread_name", "pid": PID_COORD,
                       "tid": 1, "args": {"name": "quantum barriers"}})
        tx = self.dcn_tx if self.dcn_tx else self._derived_dcn_tx()
        for idx, name, start, dur, deliver, arrivals in tx:
            events.append({
                "name": name, "cat": "dcn", "ph": "X",
                "ts": self._us(start), "dur": max(self._us(dur), 0.0),
                "pid": PID_COORD, "tid": 0,
                "args": {"op": idx, "deliver_tick": deliver,
                         "arrivals": [list(a) for a in arrivals]},
            })
        for t in self.barriers:
            events.append({"name": "quantum barrier", "cat": "quantum",
                           "ph": "i", "s": "p", "pid": PID_COORD, "tid": 1,
                           "ts": self._us(t)})

        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "format": "repro.sim trace-event export",
                "ticks_per_second": TICKS_PER_S,
                "workers": sorted(self.worker_rows),
            },
        }

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, default=str)
            f.write("\n")
        return path


def validate_trace_events(doc: Dict[str, Any]) -> List[str]:
    """Schema check for an exported trace (ci.sh trace tier): returns a
    list of problems, empty when the document is valid trace-event
    JSON.  Checks the envelope, per-event required keys by phase, and
    that every event's pid/tid/ts are numeric."""
    problems: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    need = {"X": ("name", "ts", "dur", "pid", "tid"),
            "i": ("name", "ts", "pid", "tid"),
            "s": ("id", "ts", "pid", "tid"),
            "f": ("id", "ts", "pid", "tid"),
            "M": ("name", "pid")}
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict) or "ph" not in ev:
            problems.append(f"event {i}: not an object with ph")
            continue
        ph = ev["ph"]
        if ph not in need:
            problems.append(f"event {i}: unknown phase {ph!r}")
            continue
        for k in need[ph]:
            if k not in ev:
                problems.append(f"event {i} (ph={ph}): missing {k!r}")
        for k in ("ts", "dur", "pid", "tid"):
            if k in ev and not isinstance(ev[k], (int, float)):
                problems.append(f"event {i}: {k} not numeric")
    return problems
