"""Signature guards: fail loudly when a hot path's inputs change shape, or
when a kernel library is built where none was planned (the counterpart of
``repro.analysis.tracing``).

The reference pins its jit trace counts: one trace of the serving step for
the engine's life, one of the train step across same-shape steps. The port
has no jit, but the contract behind those counts holds all the same: a hot
path's inputs never change shape, dtype, device or layout from one call to
the next (that is what a CUDA graph of the step, or a tuned table keyed by
shape, relies on), and nothing is compiled while it runs. This module
states that contract as a guard:

    step = track_signatures(make_train_step(cfg, opt_cfg))
    with assert_signature_count(1, step):
        for images, labels in batches:
            step(params, state, opt_state, images, labels)

Two forms:

* with tracked callables (:func:`track_signatures`), each one's count of
  distinct input signatures (:func:`signature_of` of its arguments: shape,
  dtype, device and strides of every tensor leaf) before and after the
  block;
* with no callables, the process-wide count of kernel-library builds
  (``repro_torch.kernels.build.load`` compiling the CUDA sources) in the
  block.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Iterator

import torch

__all__ = ["SignatureTracker", "assert_signature_count", "build_counter",
           "signature_count", "signature_of", "track_signatures"]


def _leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, dict):
        for key in sorted(tree, key=str):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _leaves(item)
    else:
        yield tree


def signature_of(*trees: Any) -> tuple:
    """``(shape, dtype, device, strides)`` of every tensor leaf of
    ``trees`` (nested dicts, lists and tuples), in order. Leaves that are
    not tensors are not part of it."""
    return tuple((tuple(t.shape), t.dtype, t.device, t.stride())
                 for t in _leaves(list(trees)) if isinstance(t, torch.Tensor))


class SignatureTracker:
    """A callable that records the input signature of every call and
    forwards it to the wrapped function."""

    def __init__(self, fn: Callable[..., Any]):
        functools.update_wrapper(self, fn)
        self.fn = fn
        self.signatures: set[tuple] = set()

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        self.signatures.add(signature_of(args, kwargs))
        return self.fn(*args, **kwargs)


def track_signatures(fn: Callable[..., Any]) -> SignatureTracker:
    """``fn`` wrapped so that :func:`signature_count` can read it."""
    return SignatureTracker(fn)


def signature_count(fn: Callable[..., Any]) -> int | None:
    """Distinct input signatures a tracked callable has seen so far; None
    for a callable that :func:`track_signatures` did not wrap."""
    sigs = getattr(fn, "signatures", None)
    return len(sigs) if isinstance(sigs, set) else None


@contextlib.contextmanager
def build_counter() -> Iterator[Callable[[], int]]:
    """Context manager yielding a zero-argument callable that returns the
    number of kernel-library builds (compiles by ``build.load``) since the
    block was entered, in this process."""
    from repro_torch.kernels import build

    start = build.compiles
    yield lambda: build.compiles - start


@contextlib.contextmanager
def assert_signature_count(n: int, *fns: Callable[..., Any],
                           exact: bool = True) -> Iterator[None]:
    """Assert the block adds exactly (``exact=True``, default) or at most
    (``exact=False``) ``n`` input signatures to each tracked callable in
    ``fns``; with none, ``n`` kernel-library builds in the process.

    An untracked callable raises ``TypeError``: a guard that cannot count
    never passes in silence.
    """
    if fns:
        before = [signature_count(f) for f in fns]
        for f, b in zip(fns, before):
            if b is None:
                raise TypeError(f"{getattr(f, '__name__', f)!r} is not a "
                                f"tracked callable: wrap it with "
                                f"track_signatures()")
        yield
        for f, b in zip(fns, before):
            _check(signature_count(f) - b, n, exact,
                   getattr(f, "__name__", repr(f)), "input signature(s)")
    else:
        with build_counter() as count:
            yield
            _check(count(), n, exact, "block", "kernel-library build(s)")


def _check(got: int, want: int, exact: bool, what: str, unit: str) -> None:
    if got != want if exact else got > want:
        bound = "exactly" if exact else "at most"
        raise AssertionError(
            f"signature guard: {what} saw {got} {unit}, expected {bound} "
            f"{want}: inputs that vary per call (a shape, dtype or layout "
            f"that changes from step to step), or a build on the hot path")
