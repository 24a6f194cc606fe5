"""The port's continuous-batching server against the JAX package's, on the
CPU: token parity under the reference's teacher-forced greedy oracle, the
engine's behaviour (slot reuse, reset = init, rejection, deadlines,
eviction, quarantine, failure-atomic steps, fixed step shapes) and the
scheduler's property tests, ported from ``tests/test_serving_sched.py``
and ``tests/test_serving_continuous.py``.

Parameters come from the reference's ``init_lm`` (reduced ``qwen3-0.6b``)
through ``lm_from_jax``. The parity oracle is ``tests/_serving_parity.py``:
each generated token must be the argmax of the reference's solo
(batch-of-one, fresh-cache) decode of the same prefix, or tied with it
within its ``tol``.
"""
import random

import jax
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_shim import given, settings, strategies as st

from _serving_parity import assert_greedy_parity
from _torch_port import np_tree, single_thread

from repro.configs.registry import get_config as jget_config
from repro.configs.registry import reduced as jreduced
from repro.core.lif import LIFConfig as JLIFConfig
from repro.models.common import split_tree as jsplit_tree
from repro.models.lm import init_lm as jinit_lm
from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import lm_from_jax
from repro_torch.core.lif import LIFConfig
from repro_torch.core.policy import named_policy
from repro_torch.core.spikingformer import tree_leaves, tree_map
from repro_torch.models.lm import (cache_batch_axes, init_cache,
                                   reset_cache_slots)
from repro_torch.serving import (FIFOScheduler, Request, ServingEngine,
                                 SlotError)

single_thread()
KEY = jax.random.PRNGKey(0)
PROMPTS = [[3, 17, 42], [5, 9], [100, 7, 3], [8], [12, 13, 14, 15]]
BUDGETS = [5, 4, 6, 3, 4]
TERMINAL = {"done", "expired", "evicted", "rejected"}

_MODELS: dict = {}


def _model(spiking: bool = True, policy: str = "eager"):
    """(reference params, reference cfg, port params, port cfg)."""
    key = (spiking, policy)
    if key not in _MODELS:
        jcfg = jreduced(jget_config("qwen3-0.6b"))
        tcfg = reduced(get_config("qwen3-0.6b"))
        if spiking:
            jcfg = jcfg.replace(lif=JLIFConfig())
            tcfg = tcfg.replace(lif=LIFConfig(policy=named_policy(policy)))
        jp = jsplit_tree(jinit_lm(KEY, jcfg))[0]
        _MODELS[key] = (jp, jcfg, lm_from_jax(np_tree(jp), device="cpu"),
                        tcfg)
    return _MODELS[key]


def _engine(slots=2, max_seq=64, spiking=True, policy="eager", **kw):
    _, _, tp, tcfg = _model(spiking, policy)
    return ServingEngine(tp, tcfg, slots=slots, max_seq=max_seq,
                         device="cpu", **kw)


def _parity(req, spiking=True):
    jp, jcfg, _, _ = _model(spiking)
    assert_greedy_parity(jp, jcfg, req)


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spiking,policy", [(False, "eager"), (True, "eager"),
                                            (True, "cuda")])
def test_continuous_matches_reference_solo_decode(spiking, policy):
    """5 requests through 2 slots, three of them admitted into slots a
    request vacated mid-flight: every output is a valid greedy trajectory
    of the reference model served alone."""
    engine = _engine(spiking=spiking, policy=policy)
    for uid, (p, b) in enumerate(zip(PROMPTS, BUDGETS)):
        assert engine.submit(Request(uid=uid, prompt=p, max_new_tokens=b))
    done = engine.run_to_completion()
    assert sorted(r.uid for r in done) == list(range(5))
    for r in done:
        _parity(r, spiking)
    assert engine.step_signature is not None
    assert engine.generated_tokens == sum(BUDGETS)


def test_admit_mid_flight_into_vacated_slot():
    """C is admitted into the slot B just vacated while A is still
    generating; C must decode as if the slot were fresh."""
    engine = _engine()
    a = Request(uid=0, prompt=[7, 3, 9], max_new_tokens=12)
    b = Request(uid=1, prompt=[100, 7], max_new_tokens=2)
    engine.submit(a)
    engine.submit(b)
    while not engine.finished:
        engine.step()
    assert engine.finished[0].uid == 1
    assert a.status == "running"
    c = Request(uid=2, prompt=[5, 9], max_new_tokens=4)
    engine.submit(c)
    engine.run_to_completion()
    assert c.admit_step > b.finish_step - 1
    for r in (a, b, c):
        _parity(r)


# ---------------------------------------------------------------------------
# Engine behaviour
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spiking", [False, True])
def test_reset_cache_slots_matches_init(spiking):
    cfg = _model(spiking)[3]
    init = init_cache(cfg, 3, 16, torch.float32, "cpu")
    dirty = tree_map(lambda a: torch.full_like(a, 7.0), init)
    none = reset_cache_slots(dirty, torch.zeros(3, dtype=torch.bool), cfg)
    for a, b in zip(tree_leaves(none), tree_leaves(dirty)):
        assert torch.equal(a, b)
    full = reset_cache_slots(dirty, torch.ones(3, dtype=torch.bool), cfg)
    for a, b in zip(tree_leaves(full), tree_leaves(init)):
        assert torch.equal(a, b)
    part = reset_cache_slots(dirty, torch.tensor([False, True, False]), cfg)
    axes = tree_leaves(cache_batch_axes(cfg, part))
    for a, ax in zip(tree_leaves(part), axes):
        a = a.movedim(ax, 0)
        assert (a[1] == 0).all() and (a[0] == 7).all() and (a[2] == 7).all()


def test_over_capacity_rejection_is_explicit():
    engine = _engine(slots=1, spiking=False, max_queue=2)
    reqs = [Request(uid=i, prompt=[1, 2], max_new_tokens=2) for i in range(5)]
    assert [engine.submit(r) for r in reqs] == [True, True, False, False,
                                                False]
    assert all(r.status == "rejected" and r.reason == "queue_full"
               for r in reqs[2:])
    done = engine.run_to_completion()
    assert {r.uid for r in done} | {r.uid for r in engine.rejected} \
        == set(range(5))


def test_over_length_rejection_is_explicit():
    engine = _engine(slots=1, max_seq=16, spiking=False)
    bad = Request(uid=0, prompt=[1] * 10, max_new_tokens=10)
    assert not engine.submit(bad)
    assert bad.status == "rejected" and bad.reason == "too_long"
    empty = Request(uid=1, prompt=[], max_new_tokens=1)
    assert not engine.submit(empty) and empty.reason == "too_long"
    assert engine.rejected == [bad, empty]


def test_evict_mid_prefill_resets_slot_state():
    """Evicting a request mid-prefill returns its slot to the init state
    (all zeros, KV and (U, S)) at once, and the next occupant decodes as if
    the slot were fresh."""
    engine = _engine()
    a = Request(uid=0, prompt=list(range(1, 9)), max_new_tokens=4)
    b = Request(uid=1, prompt=[2, 3], max_new_tokens=3)
    engine.submit(a)
    engine.submit(b)
    engine.step()
    engine.step()
    assert a.status == "running" and not a.output
    assert any(leaf.any() for leaf in tree_leaves(engine.slot_state(0)))
    assert engine.evict(0) is a and a.status == "evicted"
    for leaf in tree_leaves(engine.slot_state(0)):
        assert not leaf.any()
    assert any(leaf.any() for leaf in tree_leaves(engine.slot_state(1)))
    c = Request(uid=2, prompt=[5, 9], max_new_tokens=4)
    engine.submit(c)
    engine.run_to_completion()
    for r in (b, c):
        _parity(r)


def test_deadline_expires_with_partial_output():
    engine = _engine(slots=1, spiking=False)
    a = Request(uid=0, prompt=[3, 4], max_new_tokens=30, deadline=6)
    b = Request(uid=1, prompt=[5, 6], max_new_tokens=3)
    engine.submit(a)
    engine.submit(b)
    engine.run_to_completion()
    assert a.status == "expired" and a.reason == "deadline"
    assert 0 < len(a.output) < 30
    assert b.status == "done"
    _parity(b, spiking=False)


def test_non_finite_logits_quarantine_the_slot():
    """A slot whose logits turn non-finite ends ``faulted`` /
    ``numeric_fault`` with its state flushed to init; its neighbour keeps
    decoding untouched, and the next occupant of the slot is served as if
    the slot were fresh."""
    engine = _engine()
    real_step = engine._step
    calls = {"n": 0}

    def poisoned(*args):
        logits, cache = real_step(*args)
        calls["n"] += 1
        if calls["n"] == 4:
            logits = logits.clone()
            logits[0, 5] = float("nan")
        return logits, cache

    engine._step = poisoned
    a = Request(uid=0, prompt=[7, 3], max_new_tokens=8)
    b = Request(uid=1, prompt=[100, 7, 3], max_new_tokens=6)
    engine.submit(a)
    engine.submit(b)
    engine.step()
    engine.submit(c := Request(uid=2, prompt=[5, 9], max_new_tokens=4))
    engine.run_to_completion()
    assert a.status == "faulted" and a.reason == "numeric_fault"
    assert a.finish_step == 4 and len(a.output) == 2
    assert engine.faulted == [a]
    assert b.status == c.status == "done"
    for r in (b, c):
        _parity(r)


def test_fused_step_inputs_keep_their_shapes():
    """The single-trace contract's counterpart: every fused step of a mixed
    workload sees inputs of one shape and dtype, and a step whose inputs
    differ raises instead of running."""
    engine = _engine(slots=3)
    seen = []
    real_step = engine._step

    def record(params, cache, *inputs):
        seen.append([(tuple(t.shape), t.dtype) for t in inputs]
                    + [(tuple(a.shape), a.dtype) for a in tree_leaves(cache)])
        return real_step(params, cache, *inputs)

    engine._step = record
    for uid, (p, b) in enumerate(zip(PROMPTS, BUDGETS)):
        engine.submit(Request(uid=uid, prompt=p, max_new_tokens=b))
    engine.step()
    engine.evict(0)
    engine.run_to_completion()
    assert len(seen) == engine.step_count > 5
    assert all(s == seen[0] for s in seen)
    assert seen[0][:3] == [((3, 1), torch.int32), ((3,), torch.int32),
                           ((3,), torch.bool)]
    engine.cache = {"kv": engine.cache["kv"], "lif": {
        "u": engine.cache["lif"]["u"].double(),
        "s": engine.cache["lif"]["s"]}}
    engine.submit(Request(uid=9, prompt=[1], max_new_tokens=1))
    with pytest.raises(RuntimeError, match="changed shape or dtype"):
        engine.step()


class _LaunchFault(RuntimeError):
    """Stands in for anything the fused step can throw."""


@given(seed=st.integers(0, 1_000))
@settings(max_examples=3, deadline=None)
def test_engine_step_failures_keep_full_accounting(seed):
    """The fused step raises on chosen calls (the engine's step is
    failure-atomic, so the caller retries the identical step) and a slot's
    logits turn non-finite on others (quarantine): still ``done + rejected
    + expired + evicted + faulted == submitted``, no slot is leaked or
    double-booked, and the system drains."""
    rng = random.Random(seed)
    engine = _engine(slots=2, max_seq=32, spiking=False, max_queue=3)
    crash_calls = {rng.randint(2, 15) for _ in range(rng.randint(1, 3))}
    nan_calls = {rng.randint(2, 12): rng.randrange(2)
                 for _ in range(rng.randint(1, 2))}
    real_step, calls = engine._step, {"n": 0}

    def flaky(*args):
        calls["n"] += 1
        if calls["n"] in crash_calls:
            raise _LaunchFault(f"injected launch failure #{calls['n']}")
        logits, cache = real_step(*args)
        if calls["n"] in nan_calls:
            logits = logits.clone()
            logits[nan_calls[calls["n"]]] = float("nan")
        return logits, cache

    engine._step = flaky
    reqs = [Request(uid=i,
                    prompt=[rng.randint(1, 90) for _ in
                            range(rng.randint(1, 5))],
                    max_new_tokens=rng.randint(1, 6),
                    deadline=rng.choice([None, None, rng.randint(2, 25)]))
            for i in range(8)]
    for r in reqs[:5]:
        engine.submit(r)
    evict_uid = rng.choice([None, reqs[0].uid])
    ok_steps = failures = 0
    while engine.sched.has_work() and ok_steps < 300:
        try:
            engine.step()
        except _LaunchFault:
            failures += 1
            continue
        ok_steps += 1
        if ok_steps == 2:
            for r in reqs[5:]:
                engine.submit(r)
            if evict_uid is not None:
                engine.evict(evict_uid)
        live = [r.uid for r in engine.sched.slot_map if r is not None]
        assert len(live) == len(set(live)), "slot double-booked"
    assert ok_steps < 300, "engine failed to drain under injected failures"
    assert failures == len([c for c in crash_calls if c <= calls["n"]])
    terminal = (engine.finished + engine.rejected + engine.expired +
                engine.evicted + engine.faulted)
    assert len(terminal) == len(reqs)
    assert {r.uid for r in terminal} == {r.uid for r in reqs}
    for r in engine.faulted:
        assert r.status == "faulted" and r.reason == "numeric_fault"
    assert engine.step_count == ok_steps
    assert engine.sched.free_slots() == list(range(engine.slots))


@given(seed=st.integers(0, 1_000))
@settings(max_examples=3, deadline=None)
def test_engine_random_workload_full_accounting(seed):
    rng = random.Random(seed)
    engine = _engine(slots=2, max_seq=32, spiking=False, max_queue=3)
    reqs = [Request(uid=i,
                    prompt=[rng.randint(1, 90) for _ in
                            range(rng.randint(1, 5))],
                    max_new_tokens=rng.randint(1, 6),
                    deadline=rng.choice([None, None, rng.randint(2, 25)]))
            for i in range(7)]
    for r in reqs[:4]:
        engine.submit(r)
    for _ in range(3):
        engine.step()
    for r in reqs[4:]:
        engine.submit(r)
    engine.run_to_completion(max_steps=400)
    assert engine.step_count < 400
    terminal = {r.uid for r in engine.finished} \
        | {r.uid for r in engine.expired} | {r.uid for r in engine.rejected}
    assert terminal == {r.uid for r in reqs}
    for r in engine.finished:
        assert len(r.output) == r.max_new_tokens
        assert r.latency_steps is not None and r.latency_steps > 0
    for r in reqs:
        assert r.status in TERMINAL


def test_engine_evict_queued_request():
    engine = _engine(slots=1, spiking=False)
    a = Request(uid=0, prompt=[1, 2], max_new_tokens=3)
    b = Request(uid=1, prompt=[3, 4], max_new_tokens=3)
    engine.submit(a)
    engine.submit(b)
    engine.step()
    assert engine.evict(1) is b and b.status == "evicted"
    assert engine.evict(99) is None
    engine.run_to_completion()
    assert [r.uid for r in engine.finished] == [0]


def test_skewed_workload_slot_steps_near_optimal():
    """One 60-token request and seven 5-token ones: occupied slot-steps
    stay within 1.2x the per-request work, and wall steps track the longest
    request, not the sum (the wave engine's regression)."""
    engine = _engine(slots=8, max_seq=64, spiking=False)
    reqs = [Request(uid=0, prompt=[1, 2], max_new_tokens=60)]
    reqs += [Request(uid=i, prompt=[i, i + 1], max_new_tokens=5)
             for i in range(1, 8)]
    for r in reqs:
        engine.submit(r)
    assert len(engine.run_to_completion(max_steps=1000)) == 8
    per_request = sum(len(r.prompt) + r.max_new_tokens - 1 for r in reqs)
    assert engine.active_slot_steps <= 1.2 * per_request
    assert engine.step_count <= 62
    assert 0 < engine.occupancy < 1


def test_temperature_sampling_is_seeded():
    """temperature > 0 draws each token from softmax(logits / T) with the
    engine's seeded generator: one seed, one output; budgets are kept."""
    outs = []
    for seed in (5, 5, 6):
        engine = _engine(slots=2, spiking=False, temperature=2.0, seed=seed)
        for uid, (p, b) in enumerate(zip(PROMPTS, BUDGETS)):
            engine.submit(Request(uid=uid, prompt=p, max_new_tokens=b))
        outs.append({r.uid: r.output for r in engine.run_to_completion()})
    assert outs[0] == outs[1] != outs[2]
    assert [len(outs[0][u]) for u in range(5)] == BUDGETS


def test_engine_refuses_params_on_another_device():
    _, _, tp, tcfg = _model(False)
    meta = {"embed": {"table": torch.empty(4, 4, device="meta")}}
    with pytest.raises(ValueError, match="params live on"):
        ServingEngine(meta, tcfg, slots=1, max_seq=8, device="cpu")


# ---------------------------------------------------------------------------
# The scheduler (pure Python), ported from tests/test_serving_sched.py
# ---------------------------------------------------------------------------

def _simulate(seed: int, slots: int, n_requests: int,
              max_queue: int | None):
    """Drive the scheduler the way the engine does: one loop iteration ==
    one engine step; each running request consumes one unit of work per
    step."""
    rng = random.Random(seed)
    reqs = [Request(uid=i, prompt=[1] * rng.randint(1, 6),
                    max_new_tokens=rng.randint(1, 5),
                    deadline=rng.choice([None, None, rng.randint(1, 40)]))
            for i in range(n_requests)]
    arrivals: dict[int, list[Request]] = {}
    for r in reqs:
        arrivals.setdefault(rng.randint(0, 10), []).append(r)
    last_arrival = max(arrivals)
    sched = FIFOScheduler(slots, max_queue)
    accepted, rejected, expired, finished = [], [], [], []
    work: dict[int, int] = {}
    admit_order: list[int] = []
    t = 0
    while t <= last_arrival or sched.has_work():
        assert t < 1000, "deadlock: scheduler failed to drain"
        for r in arrivals.get(t, []):
            (accepted if sched.submit(r, t) else rejected).append(r)
        eq, er = sched.expire(t)
        expired.extend(eq)
        expired.extend(r for _, r in er)
        for slot, req in sched.admit(t):
            assert sched.slot_map[slot] is req
            work[req.uid] = len(req.prompt) - 1 + req.max_new_tokens
            admit_order.append(req.uid)
        live = [r.uid for r in sched.slot_map if r is not None]
        assert len(live) == len(set(live)), "slot double-booked"
        for slot in range(slots):
            req = sched.slot_map[slot]
            if req is None:
                continue
            work[req.uid] -= 1
            if work[req.uid] <= 0:
                assert sched.release(slot) is req
                req.status, req.done, req.finish_step = "done", True, t
                finished.append(req)
        t += 1
    return reqs, accepted, rejected, expired, finished, admit_order


@given(seed=st.integers(0, 10_000), slots=st.integers(1, 4),
       n=st.integers(1, 14), cap=st.sampled_from([None, 1, 3]))
@settings(max_examples=40, deadline=None)
def test_random_workloads_drain_without_loss(seed, slots, n, cap):
    reqs, accepted, rejected, expired, finished, admit_order = \
        _simulate(seed, slots, n, cap)
    assert len(accepted) + len(rejected) == len(reqs)
    terminal = {r.uid for r in finished} | {r.uid for r in expired} \
        | {r.uid for r in rejected}
    assert terminal == {r.uid for r in reqs}
    assert len(finished) + len(expired) + len(rejected) == len(reqs)
    for r in reqs:
        assert r.status in TERMINAL, f"uid {r.uid} left in {r.status!r}"
    for r in rejected:
        assert cap is not None and r.reason == "queue_full"
    keyed = sorted(admit_order,
                   key=lambda u: (reqs[u].submit_step, admit_order.index(u)))
    assert all(reqs[u].admit_step >= reqs[u].submit_step
               for u in admit_order)
    assert keyed == admit_order


@given(seed=st.integers(0, 10_000))
@settings(max_examples=20, deadline=None)
def test_fifo_admission_order_within_step(seed):
    rng = random.Random(seed)
    sched = FIFOScheduler(slots=rng.randint(1, 3))
    for i in range(6):
        sched.submit(Request(uid=i, prompt=[1], max_new_tokens=1), 0)
    seen, t = [], 0
    while sched.has_work():
        seen.extend(req.uid for _, req in sched.admit(t))
        for i, r in enumerate(sched.slot_map):
            if r is not None:
                sched.release(i)
        t += 1
    assert seen == [0, 1, 2, 3, 4, 5]


def test_release_free_slot_raises():
    sched = FIFOScheduler(slots=2)
    with pytest.raises(SlotError):
        sched.release(0)
    sched.submit(Request(uid=0, prompt=[1]), 0)
    [(slot, _)] = sched.admit(0)
    sched.release(slot)
    with pytest.raises(SlotError):
        sched.release(slot)


def test_admit_never_overfills():
    sched = FIFOScheduler(slots=2)
    for i in range(5):
        sched.submit(Request(uid=i, prompt=[1]), 0)
    assert [s for s, _ in sched.admit(0)] == [0, 1]
    assert sched.admit(0) == []
    assert len(sched.queue) == 3


def test_queue_capacity_is_exact():
    sched = FIFOScheduler(slots=1, max_queue=2)
    results = [sched.submit(Request(uid=i, prompt=[1]), 0) for i in range(4)]
    assert results == [True, True, False, False]
    sched.admit(0)
    assert sched.submit(Request(uid=9, prompt=[1]), 1)


def test_deadline_expires_queued_and_running():
    sched = FIFOScheduler(slots=1)
    a = Request(uid=0, prompt=[1], max_new_tokens=50, deadline=3)
    b = Request(uid=1, prompt=[1], max_new_tokens=5, deadline=4)
    sched.submit(a, 0)
    sched.submit(b, 0)
    sched.admit(0)
    assert sched.expire(2) == ([], [])
    eq, er = sched.expire(3)
    assert eq == [] and er[0][1] is a and a.status == "expired"
    sched.admit(3)
    eq, er = sched.expire(4)
    assert er[0][1] is b and b.reason == "deadline"
    assert not sched.has_work()
