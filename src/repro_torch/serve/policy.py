"""Pure continuous-batching slot-scheduler policy (vLLM-style).

A copy of ``repro.serve.policy`` (``Decision``, ``SlotScheduler``): the
port imports nothing of the JAX package.  ``repro_torch.serve.server``
drives it under the same engine contract as the JAX server, so the two
servers' decision logs compare as lists:

    sched.submit(rid, prompt_len, max_new_tokens)   # request arrives
    loop:
        admits = sched.fill()                       # iteration start
        <prefill admitted requests; prefill emits the FIRST token>
        <one batched decode step over all active slots>
        sched.note_step()
        for slot in sched.active_slots():           # ascending order
            sched.complete_token(slot, is_eos=...)

Token accounting: prefill contributes one output token, each decode step
one more; a request finishes when ``tokens_out >= max_new_tokens``, on
EOS, or when its context reaches ``seq_capacity - 1``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class Decision:
    """One scheduling decision, in decision order.

    ``step`` is the number of completed decode steps when the decision
    was taken (admissions at iteration k and finishes caused by decode
    step k both carry ``step == k``).
    """

    kind: str          # "admit" | "finish"
    rid: int
    slot: int
    step: int
    reason: str = ""   # finishes: "max_tokens" | "eos" | "capacity"


@dataclass
class _Slot:
    """Per-request scheduling state while queued or active."""

    rid: int
    prompt_len: int
    max_new_tokens: int
    tokens_out: int = 0     # output tokens produced (prefill emits 1)
    decode_steps: int = 0   # decode steps this request took part in

    @property
    def context_len(self) -> int:
        return self.prompt_len + self.decode_steps


class SlotScheduler:
    """Deterministic continuous-batching policy over ``num_slots``."""

    def __init__(self, num_slots: int, seq_capacity: int):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.num_slots = num_slots
        self.seq_capacity = seq_capacity
        self.queue: Deque[int] = deque()
        self.active: List[Optional[int]] = [None] * num_slots
        self.requests: Dict[int, _Slot] = {}
        self.decisions: List[Decision] = []
        self.steps = 0

    # -- request intake -------------------------------------------------
    def submit(self, rid: int, prompt_len: int, max_new_tokens: int) -> None:
        if rid in self.requests:
            raise ValueError(f"duplicate rid {rid}")
        if prompt_len >= self.seq_capacity:
            raise ValueError(
                f"rid {rid}: prompt_len {prompt_len} does not fit "
                f"seq_capacity {self.seq_capacity}")
        self.requests[rid] = _Slot(rid, int(prompt_len), int(max_new_tokens))
        self.queue.append(rid)

    # -- iteration boundary ---------------------------------------------
    def fill(self) -> List[Tuple[int, int]]:
        """Admit waiting requests into free slots (FIFO queue, lowest
        slot first — the server's fill loop).  Returns ``(slot, rid)``
        admissions in decision order.  Admission models the prefill:
        the request's first output token is accounted here."""
        out: List[Tuple[int, int]] = []
        for slot in range(self.num_slots):
            if self.active[slot] is None and self.queue:
                rid = self.queue.popleft()
                self.active[slot] = rid
                self.requests[rid].tokens_out = 1
                self.decisions.append(Decision("admit", rid, slot, self.steps))
                out.append((slot, rid))
        return out

    def note_step(self) -> None:
        """One batched decode step completed (before ``complete_token``
        calls for its slots)."""
        self.steps += 1

    def complete_token(self, slot: int, is_eos: bool = False
                       ) -> Optional[Decision]:
        """Account one decoded token for ``slot``; frees the slot and
        returns the finish Decision if the request completed."""
        rid = self.active[slot]
        if rid is None:
            raise ValueError(f"slot {slot} is not active")
        st = self.requests[rid]
        st.tokens_out += 1
        st.decode_steps += 1
        reason = ""
        if st.tokens_out >= st.max_new_tokens:
            reason = "max_tokens"
        elif is_eos:
            reason = "eos"
        elif st.context_len >= self.seq_capacity - 1:
            reason = "capacity"
        if not reason:
            return None
        self.active[slot] = None
        d = Decision("finish", rid, slot, self.steps, reason)
        self.decisions.append(d)
        return d

    # -- views -----------------------------------------------------------
    def active_slots(self) -> List[int]:
        """Occupied slot indices, ascending (the decode batch)."""
        return [s for s in range(self.num_slots) if self.active[s] is not None]

    def context_len(self, slot: int) -> int:
        rid = self.active[slot]
        if rid is None:
            raise ValueError(f"slot {slot} is not active")
        return self.requests[rid].context_len

    def idle(self) -> bool:
        return not self.queue and not self.active_slots()

    # -- checkpointing ----------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "num_slots": self.num_slots,
            "seq_capacity": self.seq_capacity,
            "queue": list(self.queue),
            "active": list(self.active),
            "steps": self.steps,
            "requests": {str(rid): [st.prompt_len, st.max_new_tokens,
                                    st.tokens_out, st.decode_steps]
                         for rid, st in self.requests.items()},
            "decisions": [[d.kind, d.rid, d.slot, d.step, d.reason]
                          for d in self.decisions],
        }

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        if (int(d["num_slots"]) != self.num_slots
                or int(d["seq_capacity"]) != self.seq_capacity):
            raise ValueError(
                "scheduler shape mismatch: checkpoint is "
                f"{d['num_slots']} slots x {d['seq_capacity']} capacity, "
                f"this scheduler {self.num_slots} x {self.seq_capacity}")
        self.queue = deque(int(r) for r in d["queue"])
        self.active = [None if a is None else int(a) for a in d["active"]]
        self.steps = int(d["steps"])
        self.requests = {
            int(rid): _Slot(int(rid), int(p), int(m), int(t), int(s))
            for rid, (p, m, t, s) in d["requests"].items()}
        self.decisions = [Decision(k, int(r), int(sl), int(st), re)
                          for k, r, sl, st, re in d["decisions"]]
