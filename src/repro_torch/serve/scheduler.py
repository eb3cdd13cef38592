"""Slot lifecycle and admission policy for the continuous-batching engine.

The port's own copy of ``repro/serve/scheduler.py`` (numpy only; the JAX
package's ``repro.serve`` cannot be imported without JAX).

The scheduler is pure host-side bookkeeping: it never touches a device
value.  That is what lets the engine's decode loop run with zero per-token
host syncs — a request's lifetime is fully determined at admit time
(``max_new`` decode steps; there is no data-dependent stop condition), so
the host always *knows* when each slot finishes instead of reading the
device to find out.  The engine mirrors the device-side ``remaining``
counters here and only transfers data back at completion boundaries.

Lifecycle of a slot::

      submit ──> queue ──admit──> active ──(remaining hits 0)──> finished
                   │                 │                              │
                   │ deadline passed │ deadline passed              │
                   └────> evicted <──┘                        slot freed,
                      (partial/empty                        output fetched
                       output returned)

Admission policies:
  * ``fifo``            — strict arrival order.
  * ``shortest-prompt`` — shortest prompt first (stable within equal
    lengths), the classic SJF throughput heuristic for prefill waves.

``same_length_waves`` restricts a wave to requests with identical prompt
lengths.  Attention caches tolerate right-padded prefill (padded positions
are causally masked and later overwritten by decode writes), but Mamba's
recurrent state would absorb the pad tokens, so hybrid/SSM architectures
must batch equal-length prompts only.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(eq=False)     # identity semantics: the queue holds
class Request:                       # objects, and ndarray __eq__ would
    uid: int                         # make membership tests ambiguous
    prompt: np.ndarray               # (T,) int32
    max_new: int = 16
    temperature: float = 0.0         # 0 -> greedy
    deadline: Optional[float] = None  # absolute time (scheduler clock units)
    out_tokens: Optional[List[int]] = None
    submit_time: float = 0.0
    user: Optional[str] = None       # tenant id for the privacy ledger
    charge: Optional[object] = None  # ledger.RequestCharge override


@dataclasses.dataclass
class Slot:
    request: Request
    remaining: int                   # decode steps left after the first token
    emitted: int                     # tokens emitted so far (1 at admit)
    admit_time: float = 0.0


class Scheduler:
    POLICIES = ("fifo", "shortest-prompt")

    def __init__(self, max_batch: int, cache_len: int, policy: str = "fifo",
                 same_length_waves: bool = False,
                 clock: Callable[[], float] = time.monotonic):
        assert policy in self.POLICIES, policy
        self.B = max_batch
        self.S = cache_len
        self.policy = policy
        self.same_length_waves = same_length_waves
        self.clock = clock
        self.queue: List[Request] = []
        self.slots: List[Optional[Slot]] = [None] * max_batch

    # -- queue -------------------------------------------------------------
    def validate(self, req: Request) -> None:
        """Shape checks only (no queue mutation) — callers that park a
        request outside the queue (the engine's ledger-deferred list) run
        the same validation a normal submit would."""
        T = len(req.prompt)
        if T < 1:
            raise ValueError(f"req {req.uid}: empty prompt")
        if req.max_new < 1:
            raise ValueError(f"req {req.uid}: max_new must be >= 1")
        if T + req.max_new > self.S:
            raise ValueError(f"req {req.uid}: prompt ({T}) + max_new "
                             f"({req.max_new}) exceeds cache_len ({self.S})")

    def submit(self, req: Request) -> None:
        self.validate(req)
        req.submit_time = self.clock()
        self.queue.append(req)

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    # -- deadlines ---------------------------------------------------------
    def evict_expired_queued(self, now: float) -> List[Request]:
        """Drop queued requests whose deadline passed before admission."""
        expired = [r for r in self.queue
                   if r.deadline is not None and now > r.deadline]
        if expired:
            self.queue = [r for r in self.queue if r not in expired]
        return expired

    def evict_overdue_active(self, now: float) -> List[Tuple[int, Slot]]:
        """Free active slots whose deadline passed mid-decode (deadlines are
        checked at chunk boundaries; that is the eviction granularity)."""
        out = []
        for i, s in enumerate(self.slots):
            if (s is not None and s.request.deadline is not None
                    and now > s.request.deadline and s.remaining > 0):
                out.append((i, s))
                self.slots[i] = None
        return out

    # -- admission ---------------------------------------------------------
    def next_wave(self, gate=None) -> List[Tuple[int, Request]]:
        """Pick up to ``len(free_slots)`` queued requests for one prefill
        wave and pop them from the queue.  Call ``admit`` once the wave has
        been dispatched.  Deadline eviction is the caller's job
        (``evict_expired_queued``) so evicted requests are never silently
        discarded.

        ``gate(req)`` turns slot-count admission into resource admission
        (the paged engine admits on *blocks free*, the ledger on ε budget):

        * ``True``   — admit: the request joins the wave.
        * ``"stop"`` — resource backpressure (e.g. block pool exhausted):
          the request stays queued and the wave closes; skipping *past* it
          would let small requests starve a large head-of-queue request of
          blocks forever.
        * ``"skip"`` — the caller took ownership of the request's
          disposition (ledger refusal/deferral): pop it from the queue,
          don't admit, keep scanning — one exhausted tenant must not block
          every other user's traffic."""
        free = self.free_slots()
        if not free or not self.queue:
            return []
        if self.policy == "shortest-prompt":
            order = sorted(self.queue, key=lambda r: len(r.prompt))
        else:
            order = list(self.queue)
        if self.same_length_waves and order:
            # gather the first pick's length class from the whole queue so
            # equal-length requests further back still fill the wave
            L = len(order[0].prompt)
            order = [r for r in order if len(r.prompt) == L]
        picked: List[Request] = []
        dropped: List[Request] = []
        for r in order:
            if len(picked) >= len(free):
                break
            verdict = True if gate is None else gate(r)
            if verdict is True:
                picked.append(r)
            elif verdict == "skip":
                dropped.append(r)
            else:                       # "stop": backpressure, close wave
                break
        for r in picked + dropped:
            self.queue.remove(r)
        return list(zip(free, picked))

    def admit(self, wave: List[Tuple[int, Request]],
              now: Optional[float] = None) -> None:
        """Mark a dispatched wave active.  The prefill itself emits the
        first token, so ``remaining`` = max_new - 1; a max_new=1 request is
        complete the moment it is admitted (``pop_finished`` frees it on
        the next call — the slot is never left occupied with remaining=0,
        which is the bug that used to hang the host-loop engine)."""
        now = self.clock() if now is None else now
        for slot, req in wave:
            assert self.slots[slot] is None, f"slot {slot} already active"
            self.slots[slot] = Slot(request=req, remaining=req.max_new - 1,
                                    emitted=1, admit_time=now)

    # -- decode-time bookkeeping -------------------------------------------
    def advance(self, n: int) -> None:
        """Mirror ``n`` device decode steps: every active slot emits
        min(n, remaining) tokens (the device applies the same live-mask)."""
        for s in self.slots:
            if s is not None:
                took = min(n, s.remaining)
                s.emitted += took
                s.remaining -= took

    def steps_to_next_completion(self) -> Optional[int]:
        rem = [s.remaining for s in self.slots if s is not None]
        return min(rem) if rem else None

    def max_remaining(self) -> int:
        rem = [s.remaining for s in self.slots if s is not None]
        return max(rem) if rem else 0

    def pop_finished(self) -> List[Tuple[int, Slot]]:
        done = [(i, s) for i, s in enumerate(self.slots)
                if s is not None and s.remaining <= 0]
        for i, _ in done:
            self.slots[i] = None
        return done
