"""Continuous-batching serving engine with a persistent neuron-state cache
(the counterpart of ``repro.serving.engine``).

* **Persistent slot-indexed state cache.** One device-resident cache of
  ``slots`` entries holds every slot's decode state: the attention KV and,
  for spiking LMs (``cfg.lif``), the per-layer LIF ``(U, S)`` membrane
  carry, the KV-cache analogue for neurons. It is created once by
  ``init_cache`` and survives across steps.
* **Per-step admit/evict.** Each step, finished or evicted slots are freed
  and queued requests are admitted into them. An admitted slot's state is
  reset to init *inside the same fused step* (a masked zero-fill along the
  slot axis, ``models.lm.reset_cache_slots``), so neighbours are never
  disturbed: prefill-into-slot happens while other slots keep generating.
* **One fused step of fixed shapes.** The step (slot reset + batched
  one-token decode) serves prefill (teacher-forcing prompt tokens) and
  generation for all slots. Its inputs' shapes and dtypes never change over
  the engine's life: the engine records them at the first step
  (``step_signature``) and raises if a later step differs. This is the
  reference's single-trace contract; a CUDA graph of the step is ROADMAP
  work.
* **Scheduler.** A FIFO queue + slot map (``serving.scheduler``) with
  per-request deadlines, max-token budgets and explicit (never silent)
  over-capacity and over-length rejection.
* **Slot quarantine.** Non-finite logits in a slot finish that request with
  the explicit ``faulted``/``numeric_fault`` status, evict it and flush the
  slot state to init, so one bad slot never poisons its neighbours or the
  next occupant.

The reference's chaos hooks are not ported yet (ROADMAP A13).
"""
from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.backend import resolve_device
from repro_torch.core.spikingformer import tree_leaves
from repro_torch.models.lm import (cache_slot_state, init_cache,
                                   lm_decode_step, reset_cache_slots)
from repro_torch.serving.scheduler import FIFOScheduler, Request, SlotError

__all__ = ["Request", "ServingEngine", "SlotError"]


def _signature(*trees) -> tuple:
    """(shape, dtype, device) of every tensor of ``trees``, in order."""
    return tuple((tuple(t.shape), t.dtype, t.device)
                 for t in tree_leaves(list(trees)))


class ServingEngine:
    """Continuous-batching LM server over a fixed number of decode slots.

    ``params``/``cfg`` as from ``init_lm`` (after ``split_tree``) or
    ``convert.lm_from_jax``, on ``device``; ``slots`` is the decode batch
    width; ``max_seq`` bounds prompt + new tokens per request;
    ``max_queue`` caps the waiting queue (None = unbounded; over-capacity
    submits are rejected explicitly). ``device=None`` means the card, and
    raises without one.
    """

    def __init__(self, params: Any, cfg: ArchConfig, *, slots: int = 8,
                 max_seq: int = 512, temperature: float = 0.0, seed: int = 0,
                 cache_dtype=torch.float32, max_queue: int | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, the engine on "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        self.temperature = temperature
        self._rng = np.random.default_rng(seed)

        self.sched = FIFOScheduler(slots, max_queue)
        self.finished: list[Request] = []
        self.rejected: list[Request] = []
        self.expired: list[Request] = []
        self.evicted: list[Request] = []
        #: Requests quarantined for non-finite logits (status "faulted",
        #: reason "numeric_fault"): the slot was evicted and its state
        #: flushed to init; the engine itself keeps serving.
        self.faulted: list[Request] = []

        # Device-resident persistent state: created once, never rebuilt.
        self.cache = init_cache(cfg, slots, max_seq, cache_dtype, self.device)
        #: (shape, dtype, device) of every input of the fused step, from
        #: the first step on; a step whose inputs differ raises.
        self.step_signature: tuple | None = None

        # Host-side per-slot bookkeeping.
        self._pos = np.zeros(slots, np.int32)
        self._next_tok = np.zeros((slots, 1), np.int32)
        self._prefill_idx = [0] * slots
        self._pending_reset: set[int] = set()

        # Counters (a bench reads these).
        self.step_count = 0
        self.active_slot_steps = 0
        self.generated_tokens = 0
        self.decode_seconds = 0.0

    def _step(self, params, cache, tokens, pos, reset_mask):
        """The fused step: admitted slots are zero-filled, then every slot
        advances one token. Returns (logits (slots, V), new cache)."""
        with torch.inference_mode():
            cache = reset_cache_slots(cache, reset_mask, self.cfg)
            return lm_decode_step(params, cache, tokens, pos, self.cfg)

    # -- submission / cancellation ------------------------------------------

    def submit(self, req: Request) -> bool:
        """Queue a request. Returns False, with ``req.status ==
        "rejected"`` and a reason and the request recorded in
        ``self.rejected``, when the prompt + token budget cannot fit in
        ``max_seq`` or the queue is at capacity. Never drops silently."""
        if not req.prompt or len(req.prompt) + req.max_new_tokens > \
                self.max_seq:
            req.status, req.reason = "rejected", "too_long"
            self.rejected.append(req)
            return False
        if not self.sched.submit(req, self.step_count):
            self.rejected.append(req)
            return False
        return True

    def evict(self, uid: int) -> Request | None:
        """Cancel a queued or running request. A running request's slot is
        freed and its state reset to init *immediately*, so nothing leaks
        into the next occupant even if the engine idles. Returns the
        request, or None if it is not live."""
        slot, req = self.sched.find(uid)
        if req is None:
            return None
        if slot is None:
            self.sched.queue.remove(req)
        else:
            self.sched.release(slot)
            self._clear_slot(slot)
            self.flush_resets()
        req.status, req.reason = "evicted", "evicted"
        req.finish_step = self.step_count
        self.evicted.append(req)
        return req

    # -- the engine step -----------------------------------------------------

    def step(self) -> None:
        """One engine step: deadline sweep -> admit queued requests into
        free slots -> ONE fused batched step (masked slot reset + decode)
        -> per-slot teacher-force/sample bookkeeping -> free finished slots.
        """
        now = self.step_count
        expired_queued, expired_running = self.sched.expire(now)
        self.expired.extend(expired_queued)
        for slot, req in expired_running:
            self._clear_slot(slot)
            self.expired.append(req)

        reset_mask = np.zeros(self.slots, bool)
        for slot in self._pending_reset:
            reset_mask[slot] = True
        self._pending_reset.clear()
        for slot, req in self.sched.admit(now):
            reset_mask[slot] = True
            self._pos[slot] = 0
            self._next_tok[slot, 0] = req.prompt[0]
            self._prefill_idx[slot] = 1

        t0 = time.perf_counter()
        # torch.tensor copies: the bookkeeping below mutates the host arrays.
        inputs = (torch.tensor(self._next_tok, device=self.device),
                  torch.tensor(self._pos, device=self.device),
                  torch.tensor(reset_mask, device=self.device))
        sig = _signature(self.cache, *inputs)
        if self.step_signature is None:
            self.step_signature = sig
        elif sig != self.step_signature:
            raise RuntimeError("fused step inputs changed shape or dtype: "
                               f"{sig} != {self.step_signature}")
        try:
            logits, self.cache = self._step(self.params, self.cache, *inputs)
        except BaseException:
            # Failure atomicity: the step consumed nothing (self.cache is
            # unchanged) but the pending resets were already drained into
            # reset_mask; put them back so a retried step re-applies them.
            self._pending_reset.update(
                s for s in range(self.slots) if reset_mask[s])
            raise
        self.step_count += 1
        lg = None   # fetched lazily: pure-prefill steps skip the transfer
        for slot, req in enumerate(self.sched.slot_map):
            if req is None:
                self._pos[slot] = 0
                self._next_tok[slot, 0] = 0
                continue
            self.active_slot_steps += 1
            self._pos[slot] += 1
            if self._prefill_idx[slot] < len(req.prompt):
                self._next_tok[slot, 0] = req.prompt[self._prefill_idx[slot]]
                self._prefill_idx[slot] += 1
                continue
            if lg is None:
                lg = logits.cpu().numpy()
            row = lg[slot]
            if not np.all(np.isfinite(row)):
                self._quarantine(slot, req)
                continue
            tok = self._sample(row)
            if req.first_token_step < 0:
                req.first_token_step = self.step_count
            req.output.append(tok)
            self.generated_tokens += 1
            self._next_tok[slot, 0] = tok
            if len(req.output) >= req.max_new_tokens or \
                    int(self._pos[slot]) >= self.max_seq:
                self._finish(slot, req)
        self.decode_seconds += time.perf_counter() - t0

    def run_to_completion(self, max_steps: int = 100_000) -> list[Request]:
        """Step until queue and slots drain (or ``max_steps``); returns the
        completed requests."""
        while self.sched.has_work() and self.step_count < max_steps:
            self.step()
        return self.finished

    # -- inspection ----------------------------------------------------------

    @property
    def occupancy(self) -> float:
        """Fraction of slot-steps so far that served a live request."""
        return self.active_slot_steps / max(1, self.step_count * self.slots)

    def flush_resets(self) -> None:
        """Apply pending slot resets now. Normal operation folds them into
        the next fused step; eviction (and state inspection) calls this
        eagerly so freed slots verifiably hold init state."""
        if not self._pending_reset:
            return
        mask = np.zeros(self.slots, bool)
        mask[list(self._pending_reset)] = True
        with torch.inference_mode():
            self.cache = reset_cache_slots(
                self.cache, torch.tensor(mask, device=self.device), self.cfg)
        self._pending_reset.clear()

    def slot_state(self, slot: int):
        """One slot's decode-state slice (pending resets applied first)."""
        self.flush_resets()
        return cache_slot_state(self.cache, slot, self.cfg)

    # -- internals -----------------------------------------------------------

    def _clear_slot(self, slot: int) -> None:
        self._pending_reset.add(slot)
        self._pos[slot] = 0
        self._next_tok[slot, 0] = 0
        self._prefill_idx[slot] = 0

    def _quarantine(self, slot: int, req: Request) -> None:
        """Non-finite logits in a slot (kernel bug, state corruption):
        evict the request with the explicit ``numeric_fault`` status and
        flush the slot's state to init *eagerly*, so the corruption cannot
        leak into the next occupant."""
        req.status, req.reason = "faulted", "numeric_fault"
        req.finish_step = self.step_count
        self.sched.release(slot)
        self._clear_slot(slot)
        self.flush_resets()
        self.faulted.append(req)

    def _finish(self, slot: int, req: Request) -> None:
        req.done = True
        req.status = "done"
        req.finish_step = self.step_count
        self.sched.release(slot)
        self._clear_slot(slot)
        self.finished.append(req)

    def _sample(self, logits_row: np.ndarray) -> int:
        if self.temperature == 0.0:
            return int(np.argmax(logits_row))
        z = logits_row / self.temperature
        e = np.exp(z - z.max())
        return int(self._rng.choice(len(z), p=e / e.sum()))
