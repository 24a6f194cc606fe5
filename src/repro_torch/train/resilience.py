"""Fault-tolerance helpers of the training driver (the counterpart of
``repro.train.resilience``).

* :class:`StragglerMonitor`: per-step wall time; a step slower than
  ``threshold`` times the trailing median is flagged and fires a callback.
* :class:`PreemptionGuard`: turns SIGTERM into a "checkpoint now" flag the
  driver polls between steps.
* :class:`NonFiniteGuard`: the host-side budget for the train step's
  non-finite skip (``make_train_step(guard_nonfinite=True)``): one poisoned
  batch is absorbed and logged, a run whose every step is NaN aborts with
  :class:`NonFiniteBudgetExceeded`.
* :class:`ElasticPlan`: the mesh to shrink to after a failure, and the
  global batch's scale on it; ``train.checkpoint.restore_checkpoint``
  re-resolves a checkpoint's specs against the new mesh.
"""
from __future__ import annotations

import dataclasses
import signal
import statistics
import time
from typing import Callable


class StragglerMonitor:
    """``clock`` is the time source (seconds, monotonic); tests inject
    one."""

    def __init__(self, window: int = 32, threshold: float = 2.0,
                 on_straggler: Callable[[float, float], None] | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.window = window
        self.threshold = threshold
        self.on_straggler = on_straggler
        self.clock = clock
        self.durations: list[float] = []
        self.flagged: list[int] = []
        self._t0: float | None = None
        self._step = 0

    def step_start(self) -> None:
        self._t0 = self.clock()

    def step_end(self) -> bool:
        """Record a step; returns True when the step is a straggler."""
        assert self._t0 is not None
        dt = self.clock() - self._t0
        self._t0 = None
        self._step += 1
        hist = self.durations[-self.window:]
        self.durations.append(dt)
        if len(hist) >= 8:
            med = statistics.median(hist)
            if dt > self.threshold * med:
                self.flagged.append(self._step)
                if self.on_straggler:
                    self.on_straggler(dt, med)
                return True
        return False

    @property
    def median(self) -> float:
        return statistics.median(self.durations) if self.durations else 0.0


class NonFiniteBudgetExceeded(RuntimeError):
    """Too many *consecutive* steps skipped for non-finite loss/grads."""


class NonFiniteGuard:
    """Tracks the step's skip flag (``metrics["nonfinite"]``) on the host.

    ``observe(nonfinite, step)`` returns True when the step was skipped;
    after more than ``budget`` consecutive skips it raises
    :class:`NonFiniteBudgetExceeded`: consecutive, not total, because a
    transient poisoned batch must not count against a long run while a
    diverged model (every step NaN) must die fast.
    """

    def __init__(self, budget: int = 3):
        self.budget = budget
        self.consecutive = 0
        self.total = 0
        self.skipped_steps: list[int] = []

    def observe(self, nonfinite: bool, step: int) -> bool:
        if not nonfinite:
            self.consecutive = 0
            return False
        self.consecutive += 1
        self.total += 1
        self.skipped_steps.append(step)
        if self.consecutive > self.budget:
            raise NonFiniteBudgetExceeded(
                f"{self.consecutive} consecutive non-finite steps "
                f"(budget {self.budget}); last skipped step {step}. The "
                f"model has likely diverged: refusing to spin with frozen "
                f"parameters.")
        return True


class PreemptionGuard:
    """SIGTERM -> graceful 'save and exit' flag. :meth:`uninstall` puts the
    handlers that were there before back."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.requested = False
        self._signals = signals
        self._previous: dict = {}

    def install(self) -> "PreemptionGuard":
        for s in self._signals:
            self._previous[s] = signal.signal(s, self._handler)
        return self

    def uninstall(self) -> None:
        for s, handler in self._previous.items():
            signal.signal(s, handler)
        self._previous = {}

    def _handler(self, signum, frame):
        self.requested = True


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Mesh-resize decision after a failure or a capacity change (the
    reference's, number for number)."""

    old_shape: tuple[int, ...]
    new_shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    @staticmethod
    def after_failure(shape: tuple[int, ...], axis_names: tuple[str, ...],
                      healthy_devices: int) -> "ElasticPlan":
        """Shrink the mesh to fit the surviving devices: drop whole pods
        first, then halve the data axis (model parallelism is preserved: it
        is baked into weight layouts)."""
        new = list(shape)
        names = list(axis_names)

        def total(s):
            t = 1
            for v in s:
                t *= v
            return t

        # drop pods one by one
        while total(new) > healthy_devices and "pod" in names:
            i = names.index("pod")
            if new[i] > 1:
                new[i] -= 1
            else:
                names.pop(i)
                new.pop(i)
        # then halve data
        while total(new) > healthy_devices:
            i = names.index("data")
            if new[i] <= 1:
                raise RuntimeError(
                    f"cannot shrink below model parallelism: {new}")
            new[i] //= 2
        return ElasticPlan(shape, tuple(new), tuple(names))

    @property
    def batch_scale(self) -> float:
        """Keep the per-device batch constant: the global batch scales with
        the data-like axes."""
        def data_size(shape, names):
            t = 1
            for v, n in zip(shape, names):
                if n in ("pod", "data"):
                    t *= v
            return t
        old = data_size(self.old_shape, self.axis_names)
        new = data_size(self.new_shape, self.axis_names)
        return new / old
