"""The process-wide chaos injector and the hooks production code calls.

The counterpart of ``repro.chaos.inject``. Production call sites
(``launch.train._drive`` and its ``step_once``s, ``core.policy.dispatch_site``,
``train.checkpoint``, ``serving.engine``) invoke the module-level hook
functions below unconditionally; each hook returns immediately when no
injector is active, so a process without chaos pays one global read and an
``is None`` test per hook. An injector only comes into existence through an
explicit :func:`activate` / :func:`activate_from_env` (``CHAOS_SCHEDULE``):
there is no ambient or default-on path.

The injector records every fault it fires into ``events`` (deterministic
strings, file paths reduced to basenames, letter for letter the
reference's) so two replays of the same schedule can be compared for
identical recovery behaviour.
"""
from __future__ import annotations

import contextlib
import os
import random
import signal
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.chaos.schedule import FaultSchedule, FaultSpec

__all__ = [
    "ChaosInjector", "ChaosKernelFault", "ChaosStepFault", "activate",
    "activate_from_env", "active", "chaos", "ckpt_fault", "deactivate",
    "kernel_fault", "load_schedule", "poison_batch", "serving_fault",
    "step_fault",
]


class ChaosStepFault(RuntimeError):
    """Raised by a scheduled ``chaos.step``/``raise`` fault."""


class ChaosKernelFault(RuntimeError):
    """Raised at a site's dispatch by ``chaos.kernel.<site>``: the one
    exception the circuit breaker (``core.policy.dispatch_site``)
    catches."""

    def __init__(self, site: str):
        super().__init__(f"injected kernel fault at site {site!r}")
        self.site = site


def _named_leaves(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` of every leaf of nested dicts, lists and tuples,
    in the reference's flatten order (dict keys sorted); a path is a tuple
    of keys and indices."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _named_leaves(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _named_leaves(v, prefix + (i,))]
    return [(prefix, tree)]


def _replace_leaf(tree: Any, path: tuple, leaf: Any) -> Any:
    """A copy of ``tree``'s containers along ``path`` with ``leaf`` at its
    end; every other leaf is the same object."""
    if not path:
        return leaf
    head, rest = path[0], path[1:]
    if isinstance(tree, dict):
        return {**tree, head: _replace_leaf(tree[head], rest, leaf)}
    items = list(tree)
    items[head] = _replace_leaf(items[head], rest, leaf)
    return type(tree)(items) if isinstance(tree, tuple) else items


def _poisoned(leaf: Any, bad: float) -> Any | None:
    """A copy of ``leaf`` with element 0 set to ``bad`` (a tensor stays a
    tensor on its device, anything else becomes a numpy array); None where
    the leaf is not floating point."""
    if isinstance(leaf, torch.Tensor):
        if not leaf.is_floating_point():
            return None
        out = leaf.clone(memory_format=torch.contiguous_format)
        out.view(-1)[0] = bad
        return out
    arr = np.asarray(leaf)
    if not np.issubdtype(arr.dtype, np.floating):
        return None
    arr = np.array(arr, copy=True)
    arr.reshape(-1)[0] = bad
    return arr


class ChaosInjector:
    """Executes a :class:`FaultSchedule`. ``fired`` tracks one-shot faults
    by their index in the schedule; ``events`` is the replay-comparable
    fault log."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self.fired: set[int] = set()
        self.events: list[str] = []
        self._site_dispatch: dict[str, int] = {}
        self._lock = threading.Lock()

    def _record(self, spec: FaultSpec, detail: str = "") -> None:
        tail = f" {detail}" if detail else ""
        self.events.append(f"{spec.scope}@{spec.step}:{spec.action}{tail}")

    def _one_shot(self, idx: int) -> bool:
        """Claim a one-shot fault; False if it already fired."""
        with self._lock:
            if idx in self.fired:
                return False
            self.fired.add(idx)
            return True

    # -- scope handlers ---------------------------------------------------
    def step_fault(self, step: int) -> None:
        for idx, spec in enumerate(self.schedule.faults):
            if spec.scope != "chaos.step" or spec.step != step:
                continue
            if spec.action == "delay":
                self._record(spec)
                time.sleep(spec.value)
            elif spec.action == "raise":
                if self._one_shot(idx):
                    self._record(spec)
                    raise ChaosStepFault(f"injected crash at step {step}")
            elif spec.action == "sigterm":
                if self._one_shot(idx):
                    self._record(spec)
                    os.kill(os.getpid(), signal.SIGTERM)

    def poison_batch(self, batch: Any, step: int) -> Any:
        """``batch`` (nested dicts / lists / tuples of numpy arrays or
        tensors) with element 0 of its first floating leaf, by ``"/"``-joined
        path name, set to NaN or +Inf for each ``chaos.grad`` fault of
        ``step``; the poisoned leaf is a copy, the input is never written.
        ``batch`` itself where no fault is due."""
        specs = [s for s in self.schedule.faults
                 if s.scope == "chaos.grad" and s.step == step]
        if not specs:
            return batch
        flat = _named_leaves(batch)
        named = sorted((("/".join(str(p) for p in path), i)
                        for i, (path, _) in enumerate(flat)),
                       key=lambda t: t[0])
        leaves = [leaf for _, leaf in flat]
        for spec in specs:
            bad = np.nan if spec.action == "nan" else np.inf
            for name, i in named:
                out = _poisoned(leaves[i], bad)
                if out is None:
                    continue
                leaves[i] = out
                batch = _replace_leaf(batch, flat[i][0], out)
                self._record(spec, f"leaf={name or i}")
                break
        return batch

    def kernel_fault(self, site: str) -> None:
        with self._lock:
            count = self._site_dispatch.get(site, 0)
            self._site_dispatch[site] = count + 1
        scope = f"chaos.kernel.{site}"
        for idx, spec in enumerate(self.schedule.faults):
            if spec.scope == scope and count >= spec.step:
                if self._one_shot(idx):
                    self._record(spec)
                    raise ChaosKernelFault(site)

    def ckpt_fault(self, path: str, step: int, mode: str) -> None:
        """Damage one array file of the checkpoint at ``path`` for each
        due ``chaos.ckpt`` fault. The file and the byte are drawn from
        ``random.Random(f"{schedule.seed}:{step}")``: the reference seeds
        with the tuple ``(seed, step)``, which Python 3.11 and later refuse
        (``TypeError``; ROADMAP C8), so the victim differs from the one the
        reference would pick on an older Python, and is as deterministic.
        Every rank of a mesh would draw the same byte, so under a mesh
        ``train.checkpoint`` runs the read hook on rank 0 alone."""
        for idx, spec in enumerate(self.schedule.faults):
            if (spec.scope != "chaos.ckpt" or spec.step != step
                    or spec.mode != mode):
                continue
            if not self._one_shot(idx):
                continue
            files = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
            if not files:
                continue
            rng = random.Random(f"{self.schedule.seed}:{step}")
            victim = os.path.join(path, rng.choice(files))
            size = os.path.getsize(victim)
            if spec.action == "truncate":
                with open(victim, "r+b") as f:
                    f.truncate(max(1, size // 2))
            else:
                with open(victim, "r+b") as f:
                    # Flip a byte in the data region (past the npy header)
                    # so the damage surfaces as a checksum mismatch, not a
                    # load error.
                    off = rng.randrange(size // 2, size)
                    f.seek(off)
                    byte = f.read(1)
                    f.seek(off)
                    f.write(bytes([byte[0] ^ 0xFF]))
            self._record(spec, f"file={os.path.basename(victim)}")

    def serving_fault(self, logits: np.ndarray, step: int) -> np.ndarray:
        for spec in self.schedule.faults:
            if spec.scope != "chaos.serving.slot" or spec.step != step:
                continue
            slot = int(spec.value) % max(1, logits.shape[0])
            logits = np.array(logits, copy=True)
            logits[slot] = np.nan
            self._record(spec, f"slot={slot}")
        return logits


_ACTIVE: ChaosInjector | None = None


def active() -> ChaosInjector | None:
    return _ACTIVE


def activate(schedule: FaultSchedule) -> ChaosInjector:
    """Install ``schedule`` process-wide; returns the injector (whose
    ``events`` log the caller can inspect after the run)."""
    global _ACTIVE
    _ACTIVE = ChaosInjector(schedule)
    return _ACTIVE


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


@contextlib.contextmanager
def chaos(schedule: FaultSchedule):
    """``with chaos(schedule) as injector: ...``: scoped activation."""
    injector = activate(schedule)
    try:
        yield injector
    finally:
        deactivate()


def load_schedule(raw: str) -> FaultSchedule:
    """A schedule from a JSON file's path, or from inline JSON."""
    if os.path.exists(raw):
        return FaultSchedule.from_file(raw)
    return FaultSchedule.from_json(raw)


def activate_from_env(environ=os.environ) -> ChaosInjector | None:
    """Activate from ``CHAOS_SCHEDULE`` (a JSON file path, or inline JSON).
    Returns None (and installs nothing) when the variable is unset."""
    raw = environ.get("CHAOS_SCHEDULE")
    if not raw:
        return None
    return activate(load_schedule(raw))


# -- hooks called from production code (no-ops without an injector) -------
def step_fault(step: int) -> None:
    if _ACTIVE is not None:
        _ACTIVE.step_fault(step)


def poison_batch(batch: Any, step: int) -> Any:
    if _ACTIVE is not None:
        return _ACTIVE.poison_batch(batch, step)
    return batch


def kernel_fault(site: str) -> None:
    if _ACTIVE is not None:
        _ACTIVE.kernel_fault(site)


def ckpt_fault(path: str, step: int, mode: str) -> None:
    if _ACTIVE is not None:
        _ACTIVE.ckpt_fault(path, step, mode)


def serving_fault(logits: np.ndarray, step: int) -> np.ndarray:
    if _ACTIVE is not None:
        return _ACTIVE.serving_fault(logits, step)
    return logits
