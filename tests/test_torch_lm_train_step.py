"""The port's LM train step against the JAX package's, both on the CPU:
three ``make_train_step`` steps, two microbatches, the non-finite guard,
``make_eval_step`` and the donated step (bit-equal to the functional one)
at reduced ``qwen3-0.6b`` (4 layers, d 64) without the LIF and with it under
``jnp``/``eager`` and ``pallas`` (interpret mode)/``cuda`` (the kernels'
plain versions).

Parameters come from the reference's ``init_lm`` through
``convert.lm_from_jax``, the AdamW state through
``convert.opt_state_from_jax``, batches from ``SyntheticLM``. Tolerance:
1e-5, scale-aware (``close_scaled``), on every metric and on the
parameters, m and v after the steps: the states stay within 1e-6 of each
other at these gradient norms (about 2), and every layer's branch spikes
agree at these sizes (``test_torch_lm_train.py`` checks that on the first
step's batch). The audio family's step and eval step at reduced
``whisper-large-v3`` (``_torch_port.encdec_params``).
"""
import jax
import numpy as np
import pytest
import torch

from _torch_port import POLICY_PAIRS, as_jax, as_torch, close_scaled, \
    encdec_batch, encdec_cfgs, encdec_params, lm_batch, lm_cfgs, lm_params, \
    np_tree, single_thread, trees_close

from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.convert import opt_state_from_jax
from repro_torch.core.spikingformer import tree_leaves
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt

single_thread()
OPT = dict(lr=3e-4, warmup_steps=5, total_steps=10)
#: None: no LIF; else the reference's policy (its port twin on our side).
POLICIES = [None] + [j for j, _ in POLICY_PAIRS if j != "pallas-full"]


def _states(jcfg, jp, tp):
    jopt_state = jopt.init_opt_state(jp)
    return ((jp, jopt_state),
            (tp, opt_state_from_jax(np_tree(jopt_state), device="cpu")))


def _compare_state(ts, js):
    """Parameters, m and v leaf by leaf, and the step counter."""
    (tp, to), (jp, jo) = ts, js
    trees_close(tp, jp)
    trees_close(to["m"], jo["m"])
    trees_close(to["v"], jo["v"])
    assert int(to["step"]) == int(jo["step"])


@pytest.mark.parametrize("jax_policy", POLICIES)
def test_three_train_steps_match_reference(jax_policy):
    """Three ``make_train_step`` steps from one converted state on the same
    batches: every metric after each step, and the parameters, m and v
    after the third, at 1e-5 scale-aware (the states stay within 1e-6 of
    each other at these gradient norms, about 2)."""
    jcfg, tcfg = lm_cfgs("qwen3-0.6b", jax_policy)
    jp, tp = lm_params(jcfg)
    js, ts = _states(jcfg, jp, tp)
    jstep = jax.jit(jloop.make_train_step(jcfg, jopt.OptimizerConfig(**OPT)))
    tstep = tloop.make_train_step(tcfg, topt.OptimizerConfig(**OPT))
    losses = []
    for i in range(3):
        b = lm_batch(i)
        *js, jm = jstep(*js, as_jax(b))
        *ts, tm = tstep(*ts, as_torch(b))
        assert sorted(tm) == sorted(jm)
        for k in jm:
            close_scaled(tm[k], jm[k])
        assert float(tm["nonfinite"]) == 0.0
        losses.append(float(tm["loss"]))
    _compare_state(ts, js)
    assert len(set(losses)) == 3                 # the steps did something


@pytest.mark.parametrize("jax_policy", [None, "pallas"])
def test_two_microbatches_match_reference(jax_policy):
    """``microbatches=2``: the gradients of the two halves added in order
    and halved, the loss likewise, metrics ``{"loss"}`` plus the
    optimizer's, against the reference's scan accumulation; and the same
    step's gradient within 1e-5 of the whole batch's (the loss is a mean
    over equal halves)."""
    jcfg, tcfg = lm_cfgs("qwen3-0.6b", jax_policy)
    jp, tp = lm_params(jcfg)
    js, ts = _states(jcfg, jp, tp)
    b = lm_batch()
    *js, jm = jax.jit(jloop.make_train_step(
        jcfg, jopt.OptimizerConfig(**OPT), microbatches=2))(*js, as_jax(b))
    *ts2, tm = tloop.make_train_step(
        tcfg, topt.OptimizerConfig(**OPT), microbatches=2)(*ts, as_torch(b))
    assert sorted(tm) == sorted(jm) == ["grad_norm", "loss", "lr",
                                        "nonfinite"]
    for k in jm:
        close_scaled(tm[k], jm[k])
    _compare_state(ts2, js)
    *_, whole = tloop.make_train_step(tcfg, topt.OptimizerConfig(**OPT))(
        *ts, as_torch(b))
    close_scaled(tm["loss"], whole["loss"].numpy())
    close_scaled(tm["grad_norm"], whole["grad_norm"].numpy())


def test_nonfinite_guard_leaves_every_tree_bit_identical():
    """A NaN in one parameter leaf makes the loss and the gradients
    non-finite: the step reports ``nonfinite`` 1 and returns every
    parameter and optimizer leaf bit for bit as it got them."""
    jcfg, tcfg = lm_cfgs("qwen3-0.6b", "jnp")
    _, tp = lm_params(jcfg)
    step = tloop.make_train_step(tcfg, topt.OptimizerConfig(**OPT))
    p1, o1, m1 = step(tp, topt.init_opt_state(tp), as_torch(lm_batch(0)))
    assert float(m1["nonfinite"]) == 0.0 and int(o1["step"]) == 1
    poisoned = dict(p1, ln_f={"scale": p1["ln_f"]["scale"].clone()})
    poisoned["ln_f"]["scale"][3] = float("nan")
    p2, o2, m2 = step(poisoned, o1, as_torch(lm_batch(1)))
    assert float(m2["nonfinite"]) == 1.0
    assert not np.isfinite(float(m2["loss"]))
    for new, old in ((p2, poisoned), (o2["m"], o1["m"]), (o2["v"], o1["v"])):
        for a, b in zip(tree_leaves(new), tree_leaves(old)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(o2["step"]) == 1
    # the step before the poisoned one did move everything
    assert not any(torch.equal(a, b) for a, b in
                   zip(tree_leaves(p1), tree_leaves(tp)))


@pytest.mark.parametrize("jax_policy", [None, "pallas"])
def test_eval_step_matches_reference(jax_policy):
    jcfg, tcfg = lm_cfgs("qwen3-0.6b", jax_policy)
    jp, tp = lm_params(jcfg)
    b = lm_batch(2)
    jm = jloop.make_eval_step(jcfg)(jp, as_jax(b))
    tm = tloop.make_eval_step(tcfg)(tp, as_torch(b))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        close_scaled(tm[k], jm[k])
        assert not tm[k].requires_grad


def test_audio_family_raises():
    """The audio family trains and evaluates through ``encdec_loss``, as in
    the reference: one ``make_train_step`` step (metrics, parameters, m
    and v) and ``make_eval_step`` at reduced ``whisper-large-v3`` against
    the reference's, at 1e-5 scale-aware."""
    jcfg, tcfg = encdec_cfgs()
    jp, tp = encdec_params(jcfg)
    js, ts = _states(jcfg, jp, tp)
    b = encdec_batch()
    *js, jm = jax.jit(jloop.make_train_step(
        jcfg, jopt.OptimizerConfig(**OPT)))(*js, as_jax(b))
    *ts, tm = tloop.make_train_step(tcfg, topt.OptimizerConfig(**OPT))(
        *ts, as_torch(b))
    assert sorted(tm) == sorted(jm) == ["grad_norm", "loss", "lr",
                                        "nonfinite"]
    for k in jm:
        close_scaled(tm[k], jm[k])
    _compare_state(ts, js)
    je = jloop.make_eval_step(jcfg)(jp, as_jax(b))
    te = tloop.make_eval_step(tcfg)(tp, as_torch(b))
    assert sorted(te) == sorted(je) == ["loss"]
    close_scaled(te["loss"], je["loss"])


@pytest.mark.parametrize("poisoned", [False, True])
def test_a_donated_step_writes_the_functional_step_s_bits(poisoned,
                                                         monkeypatch):
    """``donate=True``: the step writes into the trees it was given the
    same bits that the functional step returns, in slices smaller than a
    leaf (``UPDATE_SLICE`` cut to 37 elements, so slices end inside
    leaves); on a non-finite step every leaf and the step counter stay
    bit-identical."""
    monkeypatch.setattr(topt, "UPDATE_SLICE", 37)
    jcfg, tcfg = lm_cfgs("qwen3-0.6b", "jnp")
    tp = lm_params(jcfg)[1]
    opt = topt.OptimizerConfig(**OPT)
    p1, o1, _ = tloop.make_train_step(tcfg, opt)(
        tp, topt.init_opt_state(tp), as_torch(lm_batch(0)))
    if poisoned:
        p1["ln_f"]["scale"][3] = float("nan")
    want_p, want_o, want_m = tloop.make_train_step(tcfg, opt)(
        p1, o1, as_torch(lm_batch(1)))
    before = [a.clone() for a in tree_leaves((p1, o1))]
    got_p, got_o, got_m = tloop.make_train_step(tcfg, opt, donate=True)(
        p1, o1, as_torch(lm_batch(1)))
    assert got_p is p1 and got_o["m"] is o1["m"] and got_o["v"] is o1["v"]
    assert float(got_m["nonfinite"]) == float(poisoned)
    for k in want_m:                         # NaN loss and norm if poisoned
        assert torch.equal(got_m[k], want_m[k]) or bool(
            got_m[k].isnan() and want_m[k].isnan())
    got = [a.view(torch.int32) for a in tree_leaves((got_p, got_o))]
    for a, b in zip(got, tree_leaves((want_p, want_o))):
        assert torch.equal(a, b.view(torch.int32))
    moved = [not torch.equal(a, b.view(torch.int32))
             for a, b in zip(got, before)]
    assert not any(moved) if poisoned else all(moved)


def test_lm_train_step_refuses_an_object_without_a_family():
    with pytest.raises(ValueError, match="ArchConfig"):
        tloop.make_train_step(object(), topt.OptimizerConfig())
