"""Seeded, serializable fault schedules.

A :class:`FaultSchedule` is a plain value: a seed plus a tuple of
:class:`FaultSpec` entries, each naming a scope (*where* in the stack the
fault fires), a trigger index (*when*), and an action (*what* breaks).
The schedule round-trips through JSON so the exact same failure sequence
can be replayed in CI, attached to a bug report, or fed to
``python -m repro_torch.chaos.runner`` via the ``CHAOS_SCHEDULE`` env var.
This module is the reference's ``repro.chaos.schedule``, copied (it is
pure Python, but importing it from the reference would import JAX):
``generate`` gives, for the same arguments, the same schedule and the same
``to_json()`` text.

Scopes and their trigger semantics:

``chaos.step``
    ``step`` is the global train step (as seen by ``launch.train._drive``).
    Actions: ``raise`` (crash the process loop), ``delay`` (sleep
    ``value`` seconds — exercises the straggler monitor), ``sigterm``
    (deliver SIGTERM to this process — exercises PreemptionGuard).
    ``raise``/``sigterm`` fire at most once per injector so a restarted
    run can make progress past the fault.
``chaos.grad``
    ``step`` is the global train step. The first floating-point leaf of
    that step's input batch (sorted by path name) gets one element set to
    NaN (``action="nan"``) or +Inf (``action="inf"``), which propagates
    into loss and gradients. Re-fires on replay of the same step: it
    models a data-dependent fault, and the non-finite guard must skip it
    deterministically every time.
``chaos.kernel.<site>``
    ``step`` is the per-site *dispatch index* (0 = first dispatch of that
    site through ``policy.dispatch_site`` since the injector was
    activated). The reference counts trace-time dispatches: a jitted step
    dispatches each site once when it is traced. This package has no
    trace and counts calls: every call of the site is one dispatch, a
    recompute under ``torch.utils.checkpoint`` included (the neuron
    layer's replay in its backward launches without dispatching). Index 0
    is the site's first dispatch in both. Action ``raise`` throws
    :class:`~repro_torch.chaos.inject.ChaosKernelFault` at dispatch,
    before the selected impl launches anything; the circuit breaker
    catches that fault (and no other exception) and demotes the site to
    its eager arm. Fires at most once per injector.
``chaos.ckpt``
    ``step`` is the checkpoint step number. ``action`` is ``corrupt``
    (flip one byte of one array file) or ``truncate`` (cut one array file
    in half); ``mode`` selects whether the damage lands right after the
    atomic publish (``write``) or just before a restore reads the step
    (``read``). The damaged leaf is chosen deterministically from the
    schedule seed.
``chaos.serving.slot``
    ``step`` is the serving engine's step count. The logits row of slot
    ``int(value)`` is overwritten with NaN before sampling, which must
    trip the slot quarantine (request finishes with status ``faulted``,
    reason ``numeric_fault``).
"""
from __future__ import annotations

import dataclasses
import json
import random
from pathlib import Path

__all__ = ["FaultSchedule", "FaultSpec", "SCOPES"]

#: Scope prefixes the injector understands (``chaos.kernel.`` is a prefix;
#: the remainder is the dispatch-site name).
SCOPES = ("chaos.step", "chaos.grad", "chaos.kernel.", "chaos.ckpt",
          "chaos.serving.slot")

_ACTIONS = {
    "chaos.step": ("raise", "delay", "sigterm"),
    "chaos.grad": ("nan", "inf"),
    "chaos.kernel.": ("raise",),
    "chaos.ckpt": ("corrupt", "truncate"),
    "chaos.serving.slot": ("nan",),
}


def _scope_key(scope: str) -> str:
    if scope.startswith("chaos.kernel."):
        return "chaos.kernel."
    return scope


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault. ``step`` is scope-dependent (see module doc);
    ``value`` carries the delay seconds (``chaos.step``/``delay``) or the
    slot index (``chaos.serving.slot``); ``mode`` is ``write``/``read``
    for ``chaos.ckpt`` and ignored elsewhere."""
    scope: str
    step: int
    action: str
    value: float = 0.0
    mode: str = "write"

    def __post_init__(self) -> None:
        key = _scope_key(self.scope)
        if key not in _ACTIONS:
            raise ValueError(f"unknown chaos scope {self.scope!r} "
                             f"(known: {SCOPES})")
        if self.action not in _ACTIONS[key]:
            raise ValueError(
                f"action {self.action!r} invalid for scope {self.scope!r} "
                f"(allowed: {_ACTIONS[key]})")
        if key == "chaos.ckpt" and self.mode not in ("write", "read"):
            raise ValueError(f"chaos.ckpt mode must be write|read, "
                             f"got {self.mode!r}")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """An immutable, replayable set of faults (plus the seed that picks
    any remaining random choices, e.g. which checkpoint byte to flip)."""
    seed: int = 0
    faults: tuple[FaultSpec, ...] = ()

    def matching(self, scope: str) -> tuple[FaultSpec, ...]:
        return tuple(f for f in self.faults if f.scope == scope)

    # -- serialization ----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "faults": [dataclasses.asdict(f) for f in self.faults],
        }, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        raw = json.loads(text)
        return cls(seed=int(raw.get("seed", 0)),
                   faults=tuple(FaultSpec(**f)
                                for f in raw.get("faults", ())))

    def to_file(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def from_file(cls, path: str | Path) -> "FaultSchedule":
        return cls.from_json(Path(path).read_text())

    # -- generation -------------------------------------------------------
    @classmethod
    def generate(cls, seed: int, *, steps: int, ckpt_every: int = 0,
                 kernel_sites: tuple[str, ...] = (), slots: int = 0,
                 n_faults: int = 4) -> "FaultSchedule":
        """Draw a mixed schedule from ``seed``. Deterministic: the same
        arguments always yield the same schedule. Faults land in the
        middle 80% of the run so early-step bootstrap (trace, first
        checkpoint) and the final step are exercised fault-free. The
        first ``len(kinds)`` draws cycle through every enabled scope so
        a 4-fault schedule covers 4 distinct failure modes; exact
        duplicate faults are dropped (a one-shot fault scheduled twice
        is just one fault)."""
        rng = random.Random(seed)
        lo, hi = max(1, steps // 10), max(2, steps - steps // 10)
        kinds = ["chaos.step", "chaos.grad"]
        if ckpt_every > 0:
            kinds.append("chaos.ckpt")
        if kernel_sites:
            kinds.append("chaos.kernel")
        if slots > 0:
            kinds.append("chaos.serving.slot")
        faults: list[FaultSpec] = []
        for i in range(n_faults):
            kind = kinds[i % len(kinds)] if i < len(kinds) \
                else rng.choice(kinds)
            if kind == "chaos.step":
                action = rng.choice(["raise", "delay", "sigterm"])
                faults.append(FaultSpec("chaos.step", rng.randrange(lo, hi),
                                        action,
                                        value=0.01 if action == "delay"
                                        else 0.0))
            elif kind == "chaos.grad":
                faults.append(FaultSpec("chaos.grad", rng.randrange(lo, hi),
                                        rng.choice(["nan", "inf"])))
            elif kind == "chaos.ckpt":
                save_steps = [s for s in range(ckpt_every, steps + 1,
                                               ckpt_every) if s < hi]
                faults.append(FaultSpec(
                    "chaos.ckpt", rng.choice(save_steps or [ckpt_every]),
                    rng.choice(["corrupt", "truncate"]),
                    mode=rng.choice(["write", "read"])))
            elif kind == "chaos.kernel":
                faults.append(FaultSpec(
                    f"chaos.kernel.{rng.choice(list(kernel_sites))}",
                    0, "raise"))
            else:
                faults.append(FaultSpec("chaos.serving.slot",
                                        rng.randrange(lo, hi), "nan",
                                        value=float(rng.randrange(slots))))
        deduped = tuple(dict.fromkeys(faults))
        return cls(seed=seed, faults=deduped)
