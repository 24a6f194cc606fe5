"""Request scheduler for the continuous-batching serving engine (a copy of
``repro.serving.scheduler``, pure Python, the same semantics).

A :class:`FIFOScheduler` owns the queue and the slot map; the engine owns
the device-resident state. The contract the property tests pin down
(``tests/test_torch_serving.py``, ported from the reference's):

* **No silent drops.** Every submitted request reaches exactly one terminal
  status — ``done``, ``expired``, ``evicted``, ``faulted`` — or is
  *explicitly* rejected at submit time (``rejected`` + a reason) when the
  queue is at capacity. The accounting invariant ``done + rejected +
  expired + evicted + faulted == submitted`` holds even when the fused
  launch itself raises mid-drain (the engine's step is failure-atomic).
* **Slot exclusivity.** A slot holds at most one request at a time;
  double-booking or double-freeing raises :class:`SlotError` instead of
  corrupting neighbouring state.
* **Progress.** Admission is FIFO into freed slots every step, so as long
  as the engine steps, the queue drains (every running request's slot
  occupancy is bounded by its token budget).

Deadlines are measured in *engine steps since submission* (queue wait
included), the scheduler's only clock; the engine maps steps to wall time
in its reported stats.
"""
from __future__ import annotations

import dataclasses
from collections import deque


class SlotError(RuntimeError):
    """A slot-map invariant was about to be violated."""


@dataclasses.dataclass
class Request:
    """One generation request and its full lifecycle record.

    ``status`` transitions: ``queued`` -> ``running`` -> ``done``; any
    non-terminal state may instead end ``expired`` (deadline) or
    ``evicted`` (explicit cancel), a running request may end ``faulted``
    (non-finite logits in its slot, reason ``numeric_fault`` — the engine's
    slot quarantine), and ``submit`` may end it ``rejected``.
    Step counters are engine step counts (-1 = not reached).
    """

    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    deadline: int | None = None       # max engine steps from submission
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = "queued"
    reason: str | None = None
    submit_step: int = -1
    admit_step: int = -1
    first_token_step: int = -1
    finish_step: int = -1

    @property
    def latency_steps(self) -> int | None:
        """Submit-to-finish latency in engine steps (None while in flight)."""
        if self.finish_step < 0 or self.submit_step < 0:
            return None
        return self.finish_step - self.submit_step


class FIFOScheduler:
    """FIFO queue + slot map with capacity and deadline handling."""

    def __init__(self, slots: int, max_queue: int | None = None):
        self.queue: deque[Request] = deque()
        self.slot_map: list[Request | None] = [None] * slots
        self.max_queue = max_queue

    @property
    def slots(self) -> int:
        return len(self.slot_map)

    @property
    def running(self) -> list[Request]:
        return [r for r in self.slot_map if r is not None]

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_map) if r is None]

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_map)

    def submit(self, req: Request, now: int) -> bool:
        """Queue ``req``; False (+ ``rejected`` status and reason) when the
        queue is at capacity — over-capacity is explicit, never silent."""
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            req.status, req.reason = "rejected", "queue_full"
            return False
        req.status, req.submit_step = "queued", now
        self.queue.append(req)
        return True

    def admit(self, now: int) -> list[tuple[int, Request]]:
        """FIFO-fill the free slots; returns the (slot, request) admissions."""
        admitted = []
        for i in self.free_slots():
            if not self.queue:
                break
            req = self.queue.popleft()
            if self.slot_map[i] is not None:       # pragma: no cover
                raise SlotError(f"slot {i} double-booked")
            self.slot_map[i] = req
            req.status, req.admit_step = "running", now
            admitted.append((i, req))
        return admitted

    def release(self, slot: int) -> Request:
        req = self.slot_map[slot]
        if req is None:
            raise SlotError(f"slot {slot} is already free")
        self.slot_map[slot] = None
        return req

    def find(self, uid: int) -> tuple[int | None, Request | None]:
        """Locate a live request: (slot, req) if running, (None, req) if
        queued, (None, None) if unknown/terminal."""
        for i, r in enumerate(self.slot_map):
            if r is not None and r.uid == uid:
                return i, r
        for r in self.queue:
            if r.uid == uid:
                return None, r
        return None, None

    def expire(self, now: int
               ) -> tuple[list[Request], list[tuple[int, Request]]]:
        """Deadline sweep: expire overdue queued requests and evict overdue
        running ones (their slots are freed here; the engine resets the
        slot state). Returns (expired_queued, [(slot, expired_running)])."""

        def overdue(r: Request) -> bool:
            return r.deadline is not None and now - r.submit_step >= r.deadline

        expired_queued = [r for r in self.queue if overdue(r)]
        for r in expired_queued:
            self.queue.remove(r)
            r.status, r.reason, r.finish_step = "expired", "deadline", now
        expired_running = []
        for i, r in enumerate(self.slot_map):
            if r is not None and overdue(r):
                self.release(i)
                r.status, r.reason, r.finish_step = "expired", "deadline", now
                expired_running.append((i, r))
        return expired_queued, expired_running
