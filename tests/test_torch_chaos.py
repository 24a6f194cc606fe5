"""The port's chaos harness (``repro_torch.chaos``) and the guardrails that
absorb it, on the CPU, beside the reference's ``repro.chaos``.

Parity with the reference: ``FaultSchedule.generate`` gives the same
``to_json()`` text over a spread of arguments; the same hook calls give the
same event strings; ``poison_batch`` the same arrays; ``serving_fault`` the
same slot, and the two engines quarantine the same request. Twins of the
reference's own tests (``tests/test_chaos.py``): schedules, hooks, one-shot
faults, the non-finite guard, the circuit breaker, checkpoint integrity,
the serving quarantine. The twin of the reference's checkpoint write-fault
test passes here (the reference's fails on Python >= 3.11, ROADMAP C8).

The breaker's ruling, the one deliberate difference from the reference:
it demotes a site on an injected ``ChaosKernelFault`` and on nothing else;
a real kernel error propagates and trips nothing.

End to end: the driver under a NaN batch against the reference's driver
from the same checkpoint, and the reference's acceptance drill (NaN
gradient, kernel fault, SIGTERM, corrupted checkpoint) through the
runner's command line, twice, with identical events and loss histories.
"""
import dataclasses
import itertools
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_shim import given, settings, strategies as st

from _torch_port import (as_jax, both_policies, np_tree, randomize_bn,
                         single_thread)

from repro.chaos import inject as jinject
from repro.chaos.schedule import FaultSchedule as JFaultSchedule
from repro.chaos.schedule import FaultSpec as JFaultSpec
from repro.configs.spikingformer import SPIKINGFORMER_PRESETS as JAX_PRESETS
from repro.core import policy as jpolicy
from repro.core import spikingformer as jsf
from repro_torch.analysis.audit import audit_breaker
from repro_torch.chaos import inject as tinject
from repro_torch.chaos.inject import (ChaosKernelFault, ChaosStepFault,
                                      activate, chaos, deactivate)
from repro_torch.chaos.schedule import SCOPES, FaultSchedule, FaultSpec
from repro_torch.configs import SPIKINGFORMER_PRESETS
from repro_torch.convert import from_jax
from repro_torch.core import policy as tpolicy
from repro_torch.core import spikingformer as tsf
from repro_torch.core.policy import (breaker_trips, describe_breaker,
                                     dispatch_kernel, dispatch_site,
                                     reset_breaker)
from repro_torch.train import checkpoint as ckpt

single_thread()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_process():
    """Every test starts and ends with no injector and no trip, in either
    package."""
    for undo in (deactivate, jinject.deactivate, reset_breaker,
                 jpolicy.reset_breaker):
        undo()
    yield
    for undo in (deactivate, jinject.deactivate, reset_breaker,
                 jpolicy.reset_breaker):
        undo()


def _both(seed, faults):
    """The same schedule as the port's and as the reference's value."""
    return (FaultSchedule(seed=seed, faults=tuple(FaultSpec(*f)
                                                  for f in faults)),
            JFaultSchedule(seed=seed, faults=tuple(JFaultSpec(*f)
                                                   for f in faults)))


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

GENERATE_SPREAD = list(itertools.product(
    (0, 1, 9, 4242), (1, 2, 7, 16, 40), (0, 1, 4),
    ((), ("pssa.qkv",), ("pssa.qkv", "head", "smlp.a")), (0, 3),
    (1, 4, 9)))


def test_generate_gives_the_reference_schedule_text():
    """``to_json()`` text equal to the reference's for every combination
    of seed, steps, ``ckpt_every``, kernel sites, slots and fault count."""
    for seed, steps, every, sites, slots, n in GENERATE_SPREAD:
        kw = dict(steps=steps, ckpt_every=every, kernel_sites=sites,
                  slots=slots, n_faults=n)
        got = FaultSchedule.generate(seed, **kw)
        want = JFaultSchedule.generate(seed, **kw)
        assert got.to_json() == want.to_json(), (seed, kw)
        assert FaultSchedule.from_json(want.to_json()) == got
    assert len(GENERATE_SPREAD) == 1080


@given(seed=st.integers(0, 10_000))
@settings(max_examples=10, deadline=None)
def test_generate_is_deterministic_and_covers_enabled_scopes(seed):
    kw = dict(steps=40, ckpt_every=8, kernel_sites=("pssa.qkv", "head"),
              slots=4, n_faults=6)
    a = FaultSchedule.generate(seed, **kw)
    assert a == FaultSchedule.generate(seed, **kw)
    scopes = {f.scope.split(".")[1] for f in a.faults}
    assert scopes == {"step", "grad", "ckpt", "kernel", "serving"}
    assert len(set(a.faults)) == len(a.faults), "duplicate faults survived"
    for f in a.faults:
        if f.scope in ("chaos.step", "chaos.grad", "chaos.serving.slot"):
            assert 1 <= f.step < 40


def test_schedule_json_roundtrip_and_matching(tmp_path):
    sched = FaultSchedule(seed=7, faults=(
        FaultSpec("chaos.grad", 3, "nan"),
        FaultSpec("chaos.ckpt", 4, "corrupt", mode="read"),
        FaultSpec("chaos.kernel.pssa.qkv", 0, "raise"),
    ))
    assert FaultSchedule.from_json(sched.to_json()) == sched
    p = tmp_path / "sched.json"
    sched.to_file(p)
    assert FaultSchedule.from_file(p) == sched
    assert sched.matching("chaos.grad") == (sched.faults[0],)
    assert sched.matching("chaos.step") == ()
    assert tinject.load_schedule(str(p)) == sched
    assert tinject.load_schedule(sched.to_json()) == sched


def test_faultspec_validates_scope_action_mode():
    with pytest.raises(ValueError, match="unknown chaos scope"):
        FaultSpec("chaos.gpu", 0, "raise")
    with pytest.raises(ValueError, match="invalid for scope"):
        FaultSpec("chaos.grad", 0, "raise")
    with pytest.raises(ValueError, match="write|read"):
        FaultSpec("chaos.ckpt", 0, "corrupt", mode="sideways")
    assert SCOPES[0] == "chaos.step"


# ---------------------------------------------------------------------------
# Injector hooks
# ---------------------------------------------------------------------------

def test_hooks_are_noops_without_injector():
    batch = {"images": np.ones(3, np.float32)}
    assert tinject.poison_batch(batch, 0) is batch
    tinject.step_fault(0)
    tinject.kernel_fault("any.site")
    tinject.ckpt_fault("/nonexistent", 0, "write")
    logits = np.ones((2, 4))
    assert tinject.serving_fault(logits, 0) is logits
    assert tinject.activate_from_env({}) is None
    assert tinject.active() is None


def test_activate_from_env_takes_a_file_or_inline_json(tmp_path):
    sched = FaultSchedule(seed=3, faults=(FaultSpec("chaos.grad", 1, "inf"),))
    inj = tinject.activate_from_env({"CHAOS_SCHEDULE": sched.to_json()})
    assert inj is tinject.active() and inj.schedule == sched
    sched.to_file(tmp_path / "s.json")
    inj = tinject.activate_from_env({"CHAOS_SCHEDULE": str(tmp_path /
                                                           "s.json")})
    assert inj.schedule == sched
    with chaos(sched) as scoped:
        assert tinject.active() is scoped
    assert tinject.active() is None


@pytest.mark.parametrize("as_tensor", [False, True])
def test_poison_batch_hits_first_float_leaf_and_records(as_tensor):
    inj = activate(FaultSchedule(faults=(
        FaultSpec("chaos.grad", 2, "nan"),)))
    batch = {"labels": np.arange(4), "images": np.ones((2, 2), np.float32)}
    if as_tensor:
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    same = tinject.poison_batch(batch, 1)
    assert same is batch                     # wrong step: untouched
    out = tinject.poison_batch(batch, 2)
    assert type(out["images"]) is type(batch["images"])
    assert int(np.isnan(np.asarray(out["images"])).sum()) == 1
    assert np.all(np.isfinite(np.asarray(batch["images"]))), \
        "input batch mutated"
    assert out["labels"] is batch["labels"]
    assert inj.events == ["chaos.grad@2:nan leaf=images"]
    # data-dependent fault: re-fires on replay of the same step
    again = tinject.poison_batch(batch, 2)
    assert int(np.isnan(np.asarray(again["images"])).sum()) == 1


def test_poison_batch_gives_the_reference_arrays():
    """Nested dicts and lists, integer leaves first by name, two faults on
    one step, +Inf and NaN: the reference's arrays and events."""
    rng = np.random.default_rng(0)
    batch = {"b": {"tok": np.arange(6, dtype=np.int32).reshape(2, 3),
                   "x": rng.normal(size=(2, 3)).astype(np.float32)},
             "a": [np.ones(3, np.int64), rng.normal(size=4)],
             "z": rng.normal(size=(3,)).astype(np.float32)}
    faults = [("chaos.grad", 1, "inf"), ("chaos.grad", 1, "nan"),
              ("chaos.grad", 4, "nan")]
    tsched, jsched = _both(0, faults)
    tinj, jinj = activate(tsched), jinject.activate(jsched)
    for step in (0, 1, 4):
        got = tinject.poison_batch(batch, step)
        want = jinject.poison_batch(batch, step)
        for path in (("b", "tok"), ("b", "x"), ("a", 0), ("a", 1), ("z",)):
            g, w = got, want
            for k in path:
                g, w = g[k], w[k]
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
            assert np.asarray(g).dtype == np.asarray(w).dtype
    assert tinj.events == jinj.events == [
        "chaos.grad@1:inf leaf=a/1", "chaos.grad@1:nan leaf=a/1",
        "chaos.grad@4:nan leaf=a/1"]
    assert np.all(np.isfinite(batch["a"][1]))


def test_hook_events_are_the_reference_strings():
    """The same calls of every hook but the checkpoint's (C8) on both
    injectors: the same events in the same order, the same exceptions."""
    faults = [("chaos.step", 1, "delay", 0.001), ("chaos.step", 2, "raise"),
              ("chaos.step", 3, "sigterm"),
              ("chaos.kernel.pssa.qkv", 1, "raise"),
              ("chaos.kernel.attn_qk", 0, "raise"),
              ("chaos.grad", 2, "nan"),
              ("chaos.serving.slot", 5, "nan", 6.0)]
    tsched, jsched = _both(4, faults)
    got = []
    prev = signal.signal(signal.SIGTERM, lambda *_: got.append("TERM"))
    try:
        for inject, sched, exc in (
                (tinject, tsched, (ChaosStepFault, ChaosKernelFault)),
                (jinject, jsched, (jinject.ChaosStepFault,
                                   jinject.ChaosKernelFault))):
            inj = inject.activate(sched)
            raised = []
            for step in range(5):
                try:
                    inject.step_fault(step)
                except exc[0]:
                    raised.append(("step", step))
            for site in ("pssa.qkv", "attn_qk", "pssa.qkv", "pssa.qkv",
                         "attn_qk"):
                try:
                    inject.kernel_fault(site)
                except exc[1] as e:
                    raised.append(("kernel", e.site))
            inject.poison_batch({"images": np.zeros(2, np.float32)}, 2)
            out = inject.serving_fault(np.zeros((4, 3)), 5)
            raised.append(("slot", int(np.isnan(out).any(axis=1).argmax())))
            inject.deactivate()
            got.append((inj.events, raised))
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert got[0] == "TERM" and got[2] == "TERM"
    assert got[1] == got[3]
    events, raised = got[1]
    assert events == ["chaos.step@1:delay", "chaos.step@2:raise",
                      "chaos.step@3:sigterm", "chaos.kernel.attn_qk@0:raise",
                      "chaos.kernel.pssa.qkv@1:raise",
                      "chaos.grad@2:nan leaf=images",
                      "chaos.serving.slot@5:nan slot=2"]
    assert raised == [("step", 2), ("kernel", "attn_qk"),
                      ("kernel", "pssa.qkv"), ("slot", 2)]


def test_serving_fault_poisons_the_reference_slot():
    tsched, jsched = _both(0, [("chaos.serving.slot", 3, "nan", 1.0),
                               ("chaos.serving.slot", 3, "nan", 7.0),
                               ("chaos.serving.slot", 4, "nan", 0.0)])
    tinj, jinj = activate(tsched), jinject.activate(jsched)
    logits = np.arange(15, dtype=np.float32).reshape(3, 5)
    for step in (2, 3, 4):
        got = tinject.serving_fault(logits, step)
        np.testing.assert_array_equal(got, jinject.serving_fault(logits,
                                                                 step))
    assert tinj.events == jinj.events == [
        "chaos.serving.slot@3:nan slot=1", "chaos.serving.slot@3:nan slot=1",
        "chaos.serving.slot@4:nan slot=0"]
    assert np.all(np.isfinite(logits))


def test_step_raise_and_sigterm_are_one_shot():
    activate(FaultSchedule(faults=(FaultSpec("chaos.step", 3, "raise"),)))
    with pytest.raises(ChaosStepFault):
        tinject.step_fault(3)
    tinject.step_fault(3)                    # replay after restart: no refire

    got = []
    prev = signal.signal(signal.SIGTERM, lambda *_: got.append(1))
    try:
        activate(FaultSchedule(faults=(
            FaultSpec("chaos.step", 1, "sigterm"),)))
        tinject.step_fault(1)
        tinject.step_fault(1)
        assert got == [1]
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_kernel_fault_counts_dispatches_and_fires_once():
    inj = activate(FaultSchedule(faults=(
        FaultSpec("chaos.kernel.pssa.qkv", 2, "raise"),)))
    tinject.kernel_fault("pssa.qkv")
    tinject.kernel_fault("smlp.a")
    tinject.kernel_fault("pssa.qkv")
    with pytest.raises(ChaosKernelFault) as e:
        tinject.kernel_fault("pssa.qkv")
    assert e.value.site == "pssa.qkv"
    tinject.kernel_fault("pssa.qkv")         # one-shot
    assert inj.events == ["chaos.kernel.pssa.qkv@2:raise"]


def test_reference_ckpt_fault_seed_is_refused_on_this_python(tmp_path):
    """C8's witness: the reference seeds its victim draw with the tuple
    ``(seed, step)``, which Python 3.11 and later refuse; the port's hook
    on the same schedule and directory damages a file."""
    tsched, jsched = _both(5, [("chaos.ckpt", 2, "corrupt", 0.0, "write")])
    d = tmp_path / "step"
    d.mkdir()
    np.save(d / "w.npy", np.arange(64, dtype=np.float32))
    before = (d / "w.npy").read_bytes()
    jinject.activate(jsched)
    if sys.version_info >= (3, 11):
        with pytest.raises(TypeError, match="seed"):
            jinject.ckpt_fault(str(d), 2, "write")
    inj = activate(tsched)
    tinject.ckpt_fault(str(d), 2, "write")
    assert inj.events == ["chaos.ckpt@2:corrupt file=w.npy"]
    after = (d / "w.npy").read_bytes()
    assert sum(a != b for a, b in zip(before, after)) == 1


# ---------------------------------------------------------------------------
# Non-finite guard
# ---------------------------------------------------------------------------

def test_nonfinite_guard_budget_counts_consecutive_only():
    from repro_torch.train.resilience import (NonFiniteBudgetExceeded,
                                              NonFiniteGuard)
    g = NonFiniteGuard(budget=2)
    assert not g.observe(False, 0)
    assert g.observe(True, 1) and g.observe(True, 2)
    assert not g.observe(False, 3)           # streak broken: budget resets
    g.observe(True, 4)
    g.observe(True, 5)
    with pytest.raises(NonFiniteBudgetExceeded):
        g.observe(True, 6)
    assert g.skipped_steps == [1, 2, 4, 5, 6]


def test_guard_skips_step_with_state_bit_identical():
    """A poisoned batch leaves params, optimizer and BN state bit-identical
    and flags ``metrics['nonfinite']``; a clean batch trains normally."""
    from repro_torch.configs import get_spikingformer_config
    from repro_torch.core.spikingformer import init_spikingformer, tree_leaves
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

    cfg = get_spikingformer_config("spikingformer-smoke")
    params, state = init_spikingformer(torch.Generator().manual_seed(0), cfg,
                                       "cpu")
    opt = init_opt_state(params)
    step = make_train_step(cfg, OptimizerConfig(lr=1e-3, total_steps=10), 1)
    imgs = np.random.default_rng(0).normal(
        size=(2, cfg.image_size, cfg.image_size,
              cfg.in_channels)).astype(np.float32)
    labels = torch.zeros(2, dtype=torch.int64)
    activate(FaultSchedule(faults=(FaultSpec("chaos.grad", 0, "nan"),)))
    bad = tinject.poison_batch({"images": imgs}, 0)["images"]
    before = [t.clone() for t in tree_leaves((params, state, opt))]

    p1, s1, o1, m1 = step(params, state, opt, torch.from_numpy(bad), labels)
    assert float(m1["nonfinite"]) == 1.0
    for a, b in zip(before, tree_leaves((p1, s1, o1))):
        assert torch.equal(a, b), "guarded step must leave state unchanged"

    p2, s2, o2, m2 = step(params, state, opt, torch.from_numpy(imgs), labels)
    assert float(m2["nonfinite"]) == 0.0
    assert any(not torch.equal(a, b)
               for a, b in zip(tree_leaves(params), tree_leaves(p2)))


# ---------------------------------------------------------------------------
# Kernel circuit breaker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fault_from", ["schedule", "impl"])
def test_circuit_breaker_demotes_once_and_reports(fault_from):
    """An injected fault, from the hook at dispatch or from a nested site
    inside the impl, trips the site; the eager arm serves this call and
    every later one, and the trip shows in ``breaker_trips``,
    ``describe_breaker`` and ``audit_breaker``."""
    calls = {"impl": 0, "ref": 0}

    def impl():
        calls["impl"] += 1
        if fault_from == "impl":
            raise ChaosKernelFault("nested.site")
        return "impl-result"

    def ref():
        calls["ref"] += 1
        return "ref-result"

    if fault_from == "schedule":
        activate(FaultSchedule(faults=(
            FaultSpec("chaos.kernel.pssa.qkv", 0, "raise"),)))
    out1 = dispatch_site("pssa.qkv", "linear_bn", "cuda", impl,
                         fallback_impl="eager", fallback_invoke=ref)
    out2 = dispatch_site("pssa.qkv", "linear_bn", "cuda", impl,
                         fallback_impl="eager", fallback_invoke=ref)
    assert out1 == out2 == "ref-result"
    assert calls == {"impl": int(fault_from == "impl"), "ref": 2}, \
        "a tripped site must not run the faulted impl again"
    trips = breaker_trips()
    assert set(trips) == {"pssa.qkv"}
    assert trips["pssa.qkv"].fallback == "eager"
    assert trips["pssa.qkv"].impl == "cuda"
    assert "ChaosKernelFault" in trips["pssa.qkv"].error
    assert "pssa.qkv" in describe_breaker()
    findings = audit_breaker()
    assert [f.check for f in findings] == ["audit.breaker"]
    assert findings[0].level == "warning" and findings[0].where == "pssa.qkv"
    assert "tripped -> 'eager'" in findings[0].message
    reset_breaker()
    assert breaker_trips() == {} and describe_breaker() == ""
    assert audit_breaker() == []


def test_breaker_propagates_when_no_fallback_exists():
    activate(FaultSchedule(faults=(
        FaultSpec("chaos.kernel.site.x", 0, "raise"),)))
    # impl == fallback (already the eager arm): nothing to demote to.
    with pytest.raises(ChaosKernelFault):
        dispatch_site("site.x", "op", "eager", lambda: "never",
                      fallback_impl="eager", fallback_invoke=lambda: "r")
    assert breaker_trips() == {}


@pytest.mark.parametrize("error", [RuntimeError, FloatingPointError])
def test_breaker_lets_a_real_kernel_error_through(error):
    """The ruling's difference from the reference, whose breaker demotes on
    any exception: here a real kernel error (a launch, build, CUDA or shape
    error) propagates unchanged, the fallback never runs and no site trips,
    with or without an active schedule, through ``dispatch_site`` and the
    registry's ``dispatch_kernel``."""
    fallback = []

    def broken(*_):
        raise error("kernel failed")

    for schedule in (None, FaultSchedule(faults=(
            FaultSpec("chaos.kernel.other.site", 0, "raise"),))):
        if schedule is not None:
            activate(schedule)
        with pytest.raises(error, match="kernel failed"):
            dispatch_site("pssa.qkv", "linear_bn", "cuda", broken,
                          fallback_impl="eager",
                          fallback_invoke=lambda: fallback.append(1))
        tpolicy.register_kernel("bn", "test-raises")(broken)
        try:
            with pytest.raises(error, match="kernel failed"):
                dispatch_kernel("tokenizer.bn", "bn", "test-raises")
        finally:
            tpolicy.unregister_kernel("bn", "test-raises")
    assert fallback == [] and breaker_trips() == {}


def _smoke_models(seed=1):
    """Reference ``pallas`` and port ``cuda`` configs of
    ``spikingformer-smoke``, the reference's weights (BN randomised) in
    both, and a batch of images."""
    jp_pol, tp_pol = both_policies("pallas")
    jcfg = dataclasses.replace(JAX_PRESETS["spikingformer-smoke"],
                               policy=jp_pol)
    tcfg = dataclasses.replace(SPIKINGFORMER_PRESETS["spikingformer-smoke"],
                               policy=tp_pol)
    p, s = jsf.init_spikingformer(jax.random.PRNGKey(0), jcfg)
    p, s = randomize_bn(np_tree(p), np_tree(s), np.random.default_rng(seed))
    x = np.random.default_rng(seed + 1).random(
        (2, jcfg.image_size, jcfg.image_size,
         jcfg.in_channels)).astype(np.float32)
    return jcfg, tcfg, (as_jax(p), as_jax(s)), from_jax(p, s, device="cpu"), x


def test_chaos_kernel_fault_trips_breaker_in_model_dispatch():
    """``chaos.kernel.pssa.qkv`` in ``spikingformer-smoke@cuda``'s forward:
    the site demotes to the eager pipeline, so the logits equal, bit for
    bit, those of the same weights with ``pssa.qkv: eager``, and agree with
    the reference's faulted forward within 1e-5."""
    jcfg, tcfg, (jp, js), (tp, ts), x = _smoke_models()
    sched, jsched = _both(0, [("chaos.kernel.pssa.qkv", 0, "raise")])
    with chaos(sched) as inj, torch.no_grad():
        got, _ = tsf.spikingformer_apply(tp, ts, torch.from_numpy(x), tcfg,
                                         train=False)
        assert inj.events == ["chaos.kernel.pssa.qkv@0:raise"]
    assert set(breaker_trips()) == {"pssa.qkv"}
    assert "pssa.qkv,linear_bn,cuda,eager,ChaosKernelFault" in \
        tcfg.describe_execution()
    assert torch.isfinite(got).all()
    pinned = dataclasses.replace(
        tcfg, policy=tcfg.policy.with_sites({"pssa.qkv": "eager"}))
    reset_breaker()
    with torch.no_grad():
        want, _ = tsf.spikingformer_apply(tp, ts, torch.from_numpy(x),
                                          pinned, train=False)
    assert torch.equal(got, want)
    with jinject.chaos(jsched) as jinj:
        ref, _ = jsf.spikingformer_apply(jp, js, jnp.asarray(x), jcfg,
                                         train=False)
    assert jinj.events == inj.events
    assert set(jpolicy.breaker_trips()) == {"pssa.qkv"}
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# ---------------------------------------------------------------------------
# Checkpoint integrity
# ---------------------------------------------------------------------------

def _tree(step):
    return {"w": torch.full((4, 3), float(step)),
            "b": torch.arange(6, dtype=torch.float32) + step}


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in ("w", "b"))


def test_restore_falls_back_past_corruption_bit_exactly(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 2, _tree(2))
    ckpt.save_checkpoint(d, 4, _tree(4))
    assert ckpt.verify_checkpoint(d, 4) == []
    victim = os.path.join(d, "step_00000004", "w.npy")
    with open(victim, "r+b") as f:
        f.seek(os.path.getsize(victim) - 3)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    assert ckpt.verify_checkpoint(d, 4) == ["w"]
    with pytest.raises(ckpt.CheckpointCorruptError, match="CRC mismatch"):
        ckpt.restore_checkpoint(d, 4, _tree(0))
    with pytest.warns(RuntimeWarning, match="falling back"):
        step, tree = ckpt.restore_latest_good(d, _tree(0))
    assert step == 2 and _equal(tree, _tree(2))


def test_restore_falls_back_past_truncation_and_sweeps_tmp(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, _tree(1))
    ckpt.save_checkpoint(d, 2, _tree(2))
    victim = os.path.join(d, "step_00000002", "b.npy")
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # dead writer debris
    with pytest.warns(RuntimeWarning):
        step, tree = ckpt.restore_latest_good(d, _tree(0))
    assert step == 1 and _equal(tree, _tree(1))
    assert not os.path.exists(os.path.join(d, "step_00000009.tmp"))
    assert ckpt.latest_step(d) == 2      # corrupt step left for forensics


def test_restore_latest_good_empty_dir_starts_fresh(tmp_path):
    assert ckpt.restore_latest_good(str(tmp_path / "nope"), _tree(0)) == \
        (None, None)


@pytest.mark.parametrize("async_save", [False, True])
def test_chaos_ckpt_write_fault_is_caught_by_verify(tmp_path, async_save):
    """The twin of the reference's test that fails on this Python (C8):
    here it passes, on the synchronous and the asynchronous writer."""
    d = str(tmp_path)
    with chaos(FaultSchedule(seed=5, faults=(
            FaultSpec("chaos.ckpt", 2, "corrupt", mode="write"),))) as inj:
        writer = ckpt.save_checkpoint(d, 2, _tree(2), async_save=async_save)
        if writer is not None:
            writer.join(timeout=30)
            assert not writer.is_alive()
        assert len(inj.events) == 1 and "corrupt" in inj.events[0]
    bad = ckpt.verify_checkpoint(d, 2)
    assert len(bad) == 1, f"one leaf must fail its CRC, got {bad}"


@pytest.mark.parametrize("action", ["corrupt", "truncate"])
def test_chaos_ckpt_read_fault_makes_restore_fall_back(tmp_path, action):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 2, _tree(2))
    ckpt.save_checkpoint(d, 4, _tree(4))
    with chaos(FaultSchedule(seed=1, faults=(
            FaultSpec("chaos.ckpt", 4, action, mode="read"),))) as inj:
        with pytest.warns(RuntimeWarning, match="falling back"):
            step, tree = ckpt.restore_latest_good(d, _tree(0))
        assert inj.events[0].startswith(f"chaos.ckpt@4:{action} file=")
    assert step == 2 and _equal(tree, _tree(2))
    assert len(ckpt.verify_checkpoint(d, 4)) == 1


def test_drive_raises_when_final_writer_hangs():
    from repro_torch.launch.train import _drive

    class HungWriter:
        def join(self, timeout=None):
            pass

        def is_alive(self):
            return True

    with pytest.raises(ckpt.CheckpointWriteTimeout, match="still running"):
        _drive(start=0, steps=1, step_once=lambda s: {"loss": 0.0},
               save=lambda s: HungWriter(),
               log_line=lambda s, m: f"step {s}", log_every=1,
               ckpt_every=1, ckpt_dir="/tmp/ignored",
               final_join_timeout=0.01)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_async_save_remains_atomic_under_mid_write_kill(tmp_path):
    """A writer killed between leaf writes leaves no half-published step:
    the interrupted write stays a ``.tmp`` that restore sweeps."""
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, _tree(1))
    release = threading.Event()
    orig_fsync_write = ckpt._fsync_write
    calls = {"n": 0}

    def stalling(path, write_fn):
        calls["n"] += 1
        if calls["n"] == 2:
            release.wait(timeout=10)
            raise OSError("simulated writer death mid-step")
        orig_fsync_write(path, write_fn)

    ckpt._fsync_write = stalling
    try:
        t = ckpt.save_checkpoint(d, 3, _tree(3), async_save=True)
        release.set()
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        ckpt._fsync_write = orig_fsync_write
    assert ckpt.latest_step(d) == 1, "half-written step must not publish"
    step, tree = ckpt.restore_latest_good(d, _tree(0))
    assert step == 1 and _equal(tree, _tree(1))


# ---------------------------------------------------------------------------
# Serving slot quarantine
# ---------------------------------------------------------------------------

def test_serving_quarantine_matches_the_reference_engine():
    """``chaos.serving.slot`` at step 3, slot 0, in reduced ``qwen3-0.6b``
    served by both engines on the reference's weights: the same request
    is quarantined at the same step with the same event; the engine keeps
    one step signature, every other request finishes with its full budget,
    and every slot is free at the end."""
    from repro.configs.registry import get_config as jget_config
    from repro.configs.registry import reduced as jreduced
    from repro.models.common import split_tree as jsplit_tree
    from repro.models.lm import init_lm as jinit_lm
    from repro.serving.engine import ServingEngine as JServingEngine
    from repro.serving.scheduler import Request as JRequest
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.convert import lm_from_jax
    from repro_torch.serving import Request, ServingEngine

    jcfg = jreduced(jget_config("qwen3-0.6b"))
    jp = jsplit_tree(jinit_lm(jax.random.PRNGKey(0), jcfg))[0]
    engines = {
        "port": (ServingEngine(lm_from_jax(np_tree(jp), device="cpu"),
                               reduced(get_config("qwen3-0.6b")), slots=2,
                               max_seq=32, device="cpu"), Request, tinject),
        "reference": (JServingEngine(jp, jcfg, slots=2, max_seq=32),
                      JRequest, jinject)}
    seen = {}
    for name, (engine, req_cls, inject) in engines.items():
        sched = (FaultSchedule if name == "port" else JFaultSchedule)(
            faults=((FaultSpec if name == "port" else JFaultSpec)(
                "chaos.serving.slot", 3, "nan", value=0.0),))
        reqs = [req_cls(uid=i, prompt=[5 + i, 7], max_new_tokens=6)
                for i in range(4)]
        with inject.chaos(sched) as inj:
            for r in reqs:
                engine.submit(r)
            engine.run_to_completion(max_steps=100)
        assert len(engine.faulted) == 1 and len(engine.finished) == 3
        bad = engine.faulted[0]
        assert bad.status == "faulted" and bad.reason == "numeric_fault"
        for r in engine.finished:
            assert len(r.output) == r.max_new_tokens
        assert engine.sched.free_slots() == [0, 1]
        seen[name] = (inj.events, bad.uid, bad.finish_step, len(bad.output),
                      sorted(r.uid for r in engine.finished))
    assert seen["port"] == seen["reference"]
    assert seen["port"][0] == ["chaos.serving.slot@3:nan slot=0"]
    port = engines["port"][0]
    assert port.step_signature is not None


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------

def test_driver_matches_the_reference_driver_under_a_nan_batch(tmp_path,
                                                                capsys):
    """Both drivers from one checkpoint of the reference's initial state
    (``spikingformer-smoke``, ``jnp`` / ``eager``, batch 2), four steps with
    a NaN batch at step 2: equal losses, the guard skipping step 2 in
    both, the same event, parameters within 1e-5."""
    from repro.launch import train as jtrain
    from repro.launch.mesh import make_test_mesh
    from repro.train import checkpoint as jckpt
    from repro.train.optimizer import OptimizerConfig as JOptimizerConfig
    from repro.train.optimizer import init_opt_specs
    from repro_torch.core.spikingformer import tree_leaves
    from repro_torch.launch import train as ttrain

    steps, batch = 4, 2
    jp_pol, tp_pol = both_policies("jnp")
    jcfg = dataclasses.replace(JAX_PRESETS["spikingformer-smoke"],
                               policy=jp_pol)
    tcfg = dataclasses.replace(SPIKINGFORMER_PRESETS["spikingformer-smoke"],
                               policy=tp_pol)
    mesh = make_test_mesh(1, 1)
    opt_cfg = JOptimizerConfig(lr=2e-3, total_steps=steps, weight_decay=0.01,
                               warmup_steps=5)
    p, s, o, (ps, ss) = jtrain.build_spikingformer_state(jcfg, mesh, opt_cfg,
                                                         seed=0)
    start = str(tmp_path / "start")
    jckpt.save_checkpoint(start, 0, {"params": p, "state": s, "opt": o},
                          {"params": ps, "state": ss,
                           "opt": init_opt_specs(ps)})
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(start, jdir)
    shutil.copytree(start, tdir)
    tsched, jsched = _both(0, [("chaos.grad", 2, "nan")])
    with jinject.chaos(jsched) as jinj:
        jparams, jhist = jtrain.train(jcfg, steps=steps, global_batch=batch,
                                      ckpt_dir=jdir, mesh=mesh,
                                      log_every=100, ckpt_every=100)
    with chaos(tsched) as tinj:
        tparams, thist = ttrain.train(tcfg, steps=steps, global_batch=batch,
                                      ckpt_dir=tdir, log_every=100,
                                      ckpt_every=100, device="cpu")
    assert tinj.events == jinj.events == ["chaos.grad@2:nan leaf=images"]
    # the NaN pixel stops at the first LIF (NaN never fires), so the loss
    # stays finite; the gradient does not, and both guards skip the step
    out = capsys.readouterr().out
    assert out.count("[guard] step 2 non-finite loss/grads") == 2
    assert "[guard] step 3" not in out
    assert len(thist) == len(jhist) == steps
    np.testing.assert_allclose(thist, jhist, rtol=1e-6)
    want = jax.tree_util.tree_leaves(jparams)
    got = tree_leaves(tparams)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


#: NaN grad at step 3, kernel fault at the first pssa.qkv dispatch, SIGTERM
#: at step 5, and the step-6 checkpoint corrupted right after its atomic
#: publish: the restart after the preemption must fall back to step 4 (the
#: reference's ``ACCEPTANCE_SCHEDULE``).
ACCEPTANCE_SCHEDULE = FaultSchedule(seed=9, faults=(
    FaultSpec("chaos.grad", 3, "nan"),
    FaultSpec("chaos.kernel.pssa.qkv", 0, "raise"),
    FaultSpec("chaos.step", 5, "sigterm"),
    FaultSpec("chaos.ckpt", 6, "corrupt", mode="write"),
))


def _acceptance_run(tmp_path, tag):
    """One full chaos run through the runner's command line, in a process
    of its own (the SIGTERM and the process-wide trip stay out of the
    test's process)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"     # as single_thread(): workers share CPUs
    sched = tmp_path / "sched.json"
    ACCEPTANCE_SCHEDULE.to_file(sched)
    report_path = tmp_path / f"{tag}.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.chaos.runner",
         "--arch", "spikingformer-smoke", "--policy", "cuda",
         "--device", "cpu", "--steps", "8", "--ckpt-every", "2",
         "--batch", "2", "--seed", "9", "--schedule", str(sched),
         "--ckpt-dir", str(tmp_path / tag),
         "--report-out", str(report_path)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, \
        f"chaos runner failed:\n{proc.stdout}\n{proc.stderr}"
    return json.loads(report_path.read_text()), proc.stdout + proc.stderr


def test_e2e_mixed_fault_replay_recovers_identically(tmp_path):
    r1, out1 = _acceptance_run(tmp_path, "run1")
    r2, out2 = _acceptance_run(tmp_path, "run2")

    for r, out in ((r1, out1), (r2, out2)):
        assert r["completed"] and r["final_step"] == 8 and r["final_ckpt_ok"]
        assert r["restarts"] == 1            # the preemption at step 5
        assert r["breaker_sites"] == ["pssa.qkv"]
        fired = {e.split("@")[0] for e in r["events"]}
        assert fired == {"chaos.grad", "chaos.kernel.pssa.qkv",
                         "chaos.step", "chaos.ckpt"}
        assert "demoted to 'eager'" in out
        assert "non-finite loss/grads" in out
        assert "[preempt] checkpoint saved" in out
        assert "falling back to the previous retained step" in out
        assert "clean recovery" in out
        timing = json.loads(out.split("[chaos-runner] timing: ")[1]
                            .splitlines()[0])
        assert timing["peak_memory_bytes"] is None and timing["step_ms"]

    assert r1["events"] == r2["events"]
    # the history covers the final (resumed) attempt: steps 4..7
    assert len(r1["history"]) == len(r2["history"]) == 4
    for a, b in zip(r1["history"], r2["history"]):
        assert (math.isnan(a) and math.isnan(b)) or a == b
    # the corrupted step 6 was written again by the restarted run: every
    # retained checkpoint in both directories verifies
    for tag in ("run1", "run2"):
        d = str(tmp_path / tag)
        assert ckpt.retained_steps(d) == [4, 6, 8]
        for step in ckpt.retained_steps(d):
            assert ckpt.verify_checkpoint(d, step) == []


def test_run_chaos_in_process_generates_a_schedule_and_recovers(tmp_path):
    """``run_chaos`` with no schedule draws the runner's default from the
    seed, trains through it and restarts as needed, and leaves no injector
    behind; it holds an already active injector's events instead of its
    own."""
    from repro_torch.chaos.runner import default_schedule, run_chaos

    want = default_schedule(3, steps=8, ckpt_every=2)
    report = run_chaos("spikingformer-smoke", steps=8, ckpt_every=2,
                       global_batch=2, seed=3, ckpt_dir=str(tmp_path / "a"),
                       device="cpu")
    assert report.completed and report.final_ckpt_ok
    assert tinject.active() is None
    assert {e.split("@")[0] for e in report.events} <= \
        {f.scope for f in want.faults}
    with chaos(FaultSchedule(faults=(FaultSpec("chaos.grad", 1, "inf"),))) \
            as inj:
        report = run_chaos("spikingformer-smoke", steps=2, ckpt_every=2,
                           global_batch=2, ckpt_dir=str(tmp_path / "b"),
                           device="cpu")
        assert tinject.active() is inj
    assert report.events == inj.events == ["chaos.grad@1:inf leaf=images"]
    assert report.restarts == 0 and report.completed
    with pytest.raises(ValueError, match="multiple of"):
        run_chaos(steps=5, ckpt_every=2, ckpt_dir=str(tmp_path / "c"),
                  device="cpu")
