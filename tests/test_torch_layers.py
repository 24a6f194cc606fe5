"""The port's layers against the JAX package's: BN, the four ``linear_bn``
implementations, PSSA (both association orders), SMLP, a block and the
tokenizer in eval mode, and the train arms (outputs, new BN state and
gradients). Parameters are made by the JAX package's ``init_*``, given
non-trivial BN statistics from a numpy seed, and converted with
``repro_torch.convert.from_jax``; inputs come from numpy seeds.

Tolerance 1e-5 (absolute, on O(1) values): the same fp32 products summed in
another order by another BLAS; gradients 1e-5 scale-aware (max|a - b| <=
1e-5 * max(1, max|b|), the reference's convention). Spikes are compared by
mismatch fraction beside it; at these sizes no membrane sits within
rounding of the threshold and the fraction is 0.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (POLICY_PAIRS, as_jax, both_policies,
                         mismatch_fraction, np_tree, randomize_bn,
                         single_thread, to_torch)

from repro.core import spiking_layers as jl
from repro.core import spikingformer as jsf
from repro.core.lif import LIFConfig as JLIFConfig, lif_scan as jlif_scan
from repro_torch.core import spiking_layers as tl
from repro_torch.core import spikingformer as tsf
from repro_torch.core.lif import LIFConfig, lif_scan, lif_scan_with_state
from repro_torch.core.policy import IMPL_FROM_JAX, ExecutionPolicy, \
    named_policy

single_thread()
KEY = jax.random.PRNGKey(0)
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def _grads_close(got, want, atol=1e-5):
    """Scale-aware, leaf by leaf in the reference pytree's order."""
    from repro_torch.core.spikingformer import tree_leaves
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        scale = max(1.0, float(np.max(np.abs(b))))
        np.testing.assert_allclose(a.detach().numpy() / scale, b / scale,
                                   atol=atol, rtol=0)


def _torch_grads(fn, params, *inputs):
    """Gradients of ``fn(params, *inputs)`` (a scalar) with respect to every
    parameter leaf and every input, as (params-shaped tree, inputs)."""
    from repro_torch.core.spikingformer import tree_leaves, tree_unflatten
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    ins = [x.detach().requires_grad_(True) for x in inputs]
    out = fn(tree_unflatten(params, leaves), *ins)
    grads = torch.autograd.grad(out, leaves + ins)
    return tree_unflatten(params, grads[:len(leaves)]), grads[len(leaves):]


def _spikes(rng, shape, rate=0.3):
    return (rng.random(shape) < rate).astype(np.float32)


def _init(init_fn, seed):
    """JAX-initialised (params, state) with non-trivial BN, as numpy trees,
    JAX trees and torch trees."""
    p, s = init_fn()
    p, s = randomize_bn(np_tree(p), np_tree(s), np.random.default_rng(seed))
    return (as_jax(p), as_jax(s)), (to_torch(p), to_torch(s))


# ---------------------------------------------------------------------------
# LIF and BN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jax_policy,port_policy", POLICY_PAIRS)
def test_lif_scan_bitwise(jax_policy, port_policy):
    jp, tp = both_policies(jax_policy)
    x = np.random.default_rng(0).normal(0.3, 1.0, (4, 2, 9, 16)) \
        .astype(np.float32)
    got = lif_scan(_t(x), LIFConfig(alpha=0.4, th_fire=0.9, policy=tp),
                   site="pssa.lif")
    want = jlif_scan(jnp.asarray(x),
                     JLIFConfig(alpha=0.4, th_fire=0.9, policy=jp),
                     site="pssa.lif")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("port_policy", ["eager", "cuda"])
@pytest.mark.parametrize("time_chunk", [1, 2, 3])
def test_lif_time_chunk_equals_single_shot(port_policy, time_chunk):
    pol = named_policy(port_policy)
    x = _t(np.random.default_rng(1).normal(0.3, 1.0, (4, 6, 8))
           .astype(np.float32))
    want = lif_scan(x, LIFConfig(policy=pol))
    got = lif_scan(x, LIFConfig(policy=pol, time_chunk=time_chunk))
    assert torch.equal(got, want)       # 3 does not divide 4: single shot
    s1, (u, s) = lif_scan_with_state(x[:2], torch.zeros(6, 8),
                                     torch.zeros(6, 8), LIFConfig(policy=pol))
    s2, _ = lif_scan_with_state(x[2:], u, s, LIFConfig(policy=pol))
    assert torch.equal(torch.cat([s1, s2]), want)


@pytest.mark.parametrize("port_policy", ["eager", "cuda"])
def test_bn_apply_eval(port_policy):
    rng = np.random.default_rng(2)
    (jp, js), (tp, ts) = _init(lambda: jl.init_bn(24), 2)
    x = rng.normal(1.0, 2.0, (2, 3, 5, 24)).astype(np.float32)
    want, _ = jl.bn_apply(jp, js, jnp.asarray(x), train=False)
    got, new = tl.bn_apply(tp, ts, _t(x), train=False,
                           policy=named_policy(port_policy), site="tokenizer.bn")
    _close(got, want, 1e-6)             # elementwise: a division's rounding
    assert new is ts


def test_bn_apply_train_eager_running_stats():
    rng = np.random.default_rng(3)
    (jp, js), (tp, ts) = _init(lambda: jl.init_bn(16), 3)
    x = rng.normal(0.5, 1.5, (4, 7, 16)).astype(np.float32)
    want, wstate = jl.bn_apply(jp, js, jnp.asarray(x), train=True)
    got, gstate = tl.bn_apply(tp, ts, _t(x), train=True)
    _close(got, want)
    for k in ("mean", "var"):
        _close(gstate[k], wstate[k], 1e-6)
    # the BN kernel pair (plain versions here) against the Pallas pair
    from repro.core.policy import named_policy as jax_named_policy
    want, wstate = jl.bn_apply(jp, js, jnp.asarray(x), train=True,
                               policy=jax_named_policy("pallas"))
    got, gstate = tl.bn_apply(tp, ts, _t(x), train=True,
                              policy=named_policy("cuda"))
    _close(got, want)
    for k in ("mean", "var"):
        _close(gstate[k], wstate[k], 1e-6)
        assert not gstate[k].requires_grad


# ---------------------------------------------------------------------------
# linear_bn: the four implementations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jimpl,timpl", [
    ("jnp", "eager"), ("pallas", "cuda"),
    ("pallas+spike_mm", "cuda+spike_mm"), ("fused_epilogue", "fused_epilogue")])
@pytest.mark.parametrize("d_in,d_out", [(32, 48), (20, 12)])   # 20 % 8 != 0
def test_linear_bn_impls_eval(jimpl, timpl, d_in, d_out):
    from repro.core.policy import ExecutionPolicy as JPolicy
    rng = np.random.default_rng(d_in)
    (jp, js), (tp, ts) = _init(
        lambda: jl.init_linear_bn(KEY, d_in, d_out), d_in)
    x = _spikes(rng, (2, 3, 10, d_in))
    jpol = JPolicy(backend="pallas", overrides={"linear_bn": jimpl})
    tpol = ExecutionPolicy(backend="cuda", overrides={"linear_bn": timpl})
    # without a trailing LIF (fused_epilogue demotes to the pipeline) ...
    want, _ = jl.linear_bn_apply(jp, js, jnp.asarray(x), train=False,
                                 policy=jpol, site="pssa.proj")
    got, _ = tl.linear_bn_apply(tp, ts, _t(x), train=False, policy=tpol,
                                site="pssa.proj")
    _close(got, want)
    # ... and with one (fused_epilogue runs the single-launch neuron layer)
    want, _ = jl.linear_bn_lif_apply(jp, js, jnp.asarray(x), JLIFConfig(policy=jpol),
                                     train=False, policy=jpol, site="smlp.a",
                                     lif_site="smlp.lif")
    got, _ = tl.linear_bn_lif_apply(tp, ts, _t(x), LIFConfig(policy=tpol),
                                    train=False, policy=tpol, site="smlp.a",
                                    lif_site="smlp.lif")
    assert mismatch_fraction(got.numpy(), want) == 0.0
    assert 0.02 < float(got.mean()) < 0.98


@pytest.mark.parametrize("timpl", ["cuda", "cuda+spike_mm", "fused_epilogue"])
def test_train_mode_is_refused_off_the_eager_impl(timpl):
    """Train mode at every implementation of the Conv1DBN -> SN pair off
    ``eager``: spikes, new BN state and the gradients of every parameter
    and of the input against the reference's same implementation
    (fused_epilogue: the neuron-layer train kernel and its replay
    backward). It keeps the name of the refusal test it replaced."""
    from repro.core.policy import ExecutionPolicy as JPolicy
    jimpl = {v: k for k, v in IMPL_FROM_JAX.items()}[timpl]
    rng = np.random.default_rng(12)
    (jp, js), (tp, ts) = _init(lambda: jl.init_linear_bn(KEY, 32, 24), 12)
    x = _spikes(rng, (2, 3, 10, 32))
    g = rng.normal(0, 1, (2, 3, 10, 24)).astype(np.float32)
    jpol = JPolicy(backend="pallas", overrides={"linear_bn": jimpl})
    tpol = ExecutionPolicy(backend="cuda", overrides={"linear_bn": timpl})
    jlif, tlif = JLIFConfig(policy=jpol), LIFConfig(policy=tpol)

    def jrun(p, xx):
        return jl.linear_bn_lif_apply(p, js, xx, jlif, train=True,
                                      policy=jpol, site="smlp.a",
                                      lif_site="smlp.lif")

    def trun(p, xx):
        return tl.linear_bn_lif_apply(p, ts, xx, tlif, train=True,
                                      policy=tpol, site="smlp.a",
                                      lif_site="smlp.lif")

    want, wstate = jrun(jp, jnp.asarray(x))
    got, gstate = trun(tp, _t(x))
    assert mismatch_fraction(got.detach().numpy(), want) == 0.0
    assert 0.02 < float(got.mean()) < 0.98
    for k in ("mean", "var"):
        _close(gstate["bn"][k], wstate["bn"][k], 1e-6)
    wgrads = jax.grad(lambda p, xx: jnp.sum(jrun(p, xx)[0] * g),
                      argnums=(0, 1))(jp, jnp.asarray(x))
    tgrads, (tgx,) = _torch_grads(lambda p, xx: (trun(p, xx)[0]
                                                 * _t(g)).sum(), tp, _t(x))
    _grads_close(tgrads, wgrads[0])
    _grads_close([tgx], [wgrads[1]])


# ---------------------------------------------------------------------------
# PSSA / SMLP / block
# ---------------------------------------------------------------------------

#: (d_model, heads, d_ff, tokens): square like the smoke preset; N != d != dh
#: with N % 8 == 0 (packed attn_av); N % 8 != 0 (attn_av demotes).
BLOCK_SHAPES = [(64, 2, 128, 64), (32, 2, 48, 24), (32, 4, 64, 36)]


def _block_cfgs(d, h, f, jax_policy, qk_first=True):
    jp, tp = both_policies(jax_policy)
    return (jl.BlockConfig(d, h, f, qk_first=qk_first, policy=jp),
            tl.BlockConfig(d, h, f, qk_first=qk_first, policy=tp))


@pytest.mark.parametrize("jax_policy,port_policy", POLICY_PAIRS)
@pytest.mark.parametrize("d,h,f,n", BLOCK_SHAPES)
@pytest.mark.parametrize("qk_first", [True, False])
def test_pssa_apply_eval(d, h, f, n, qk_first, jax_policy, port_policy):
    jcfg, tcfg = _block_cfgs(d, h, f, jax_policy, qk_first)
    (jp, js), (tp, ts) = _init(lambda: jl.init_pssa(KEY, jcfg.pssa), n)
    x = np.random.default_rng(n).normal(0.4, 1.0, (2, 2, n, d)) \
        .astype(np.float32)
    want, _ = jl.pssa_apply(jp, js, jnp.asarray(x), jcfg.pssa, train=False)
    got, _ = tl.pssa_apply(tp, ts, _t(x), tcfg.pssa, train=False)
    _close(got, want)
    assert float(np.abs(np.asarray(want)).mean()) > 0.05   # attention is live


@pytest.mark.parametrize("jax_policy,port_policy", POLICY_PAIRS)
@pytest.mark.parametrize("d,h,f,n", BLOCK_SHAPES)
def test_smlp_and_block_apply_eval(d, h, f, n, jax_policy, port_policy):
    jcfg, tcfg = _block_cfgs(d, h, f, jax_policy)
    (jp, js), (tp, ts) = _init(lambda: jl.init_block(KEY, jcfg), d + n)
    x = np.random.default_rng(d).normal(0.4, 1.0, (2, 2, n, d)) \
        .astype(np.float32)
    want, _ = jl.smlp_apply(jp["smlp"], js["smlp"], jnp.asarray(x), jcfg.smlp,
                            train=False)
    got, _ = tl.smlp_apply(tp["smlp"], ts["smlp"], _t(x), tcfg.smlp,
                           train=False)
    _close(got, want)
    want, _ = jl.block_apply(jp, js, jnp.asarray(x), jcfg, train=False)
    got, new = tl.block_apply(tp, ts, _t(x), tcfg, train=False)
    _close(got, want)
    assert set(new) == {"pssa", "smlp"} and set(new["pssa"]) == set("qkvz")


@pytest.mark.parametrize("jax_policy,port_policy", [
    ("jnp", "eager"), ("pallas-full", "cuda-full")])
@pytest.mark.parametrize("d,h,f,n", BLOCK_SHAPES[:2])
def test_block_train_forward_and_grads(d, h, f, n, jax_policy, port_policy):
    """A whole block in train mode: output, new BN state, and the gradients
    of every parameter and of the input (through both LIFs, the attention
    spike products and every BN) against the reference's."""
    jcfg, tcfg = _block_cfgs(d, h, f, jax_policy)
    (jp, js), (tp, ts) = _init(lambda: jl.init_block(KEY, jcfg), n + 1)
    rng = np.random.default_rng(n + 1)
    x = rng.normal(0.4, 1.0, (2, 2, n, d)).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    want, wstate = jl.block_apply(jp, js, jnp.asarray(x), jcfg, train=True)
    got, gstate = tl.block_apply(tp, ts, _t(x), tcfg, train=True)
    _close(got.detach(), want)
    _grads_close(gstate, wstate, 1e-6)
    wgrads = jax.grad(lambda p, xx: jnp.sum(jl.block_apply(
        p, js, xx, jcfg, train=True)[0] * g), argnums=(0, 1))(
        jp, jnp.asarray(x))
    tgrads, (tgx,) = _torch_grads(lambda p, xx: (tl.block_apply(
        p, ts, xx, tcfg, train=True)[0] * _t(g)).sum(), tp, _t(x))
    _grads_close(tgrads, wgrads[0])
    _grads_close([tgx], [wgrads[1]])


def test_attn_av_packed_runs_or_demotes_by_token_count(caplog):
    """N % 8 decides, per call, as the plan says per model: both arms give
    the einsum's result (integer counts times spikes: exact)."""
    import logging
    rng = np.random.default_rng(4)
    pol = named_policy("cuda-full")
    for n in (24, 36):
        attn = _t(rng.integers(0, 9, (2, 1, 2, n, n)).astype(np.float32))
        v = _t(_spikes(rng, (2, 1, 2, n, 16)))
        with caplog.at_level(logging.INFO, logger="repro_torch.execution"):
            got = tl._attn_av_packed(attn, v, pol, f"attn_av.test{n}")
        assert torch.equal(got, tl._attn_av_eager(attn, v, pol, "attn_av"))
    msgs = [r.getMessage() for r in caplog.records]
    assert any("test36" in m and "36 % 8" in m for m in msgs)
    assert not any("test24" in m for m in msgs)


def test_split_and_merge_heads_match_reference():
    x = np.random.default_rng(5).normal(size=(2, 3, 6, 8)).astype(np.float32)
    got = tl._split_heads(_t(x), 4)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jl._split_heads(jnp.asarray(x), 4)))
    assert torch.equal(tl._merge_heads(got), _t(x))


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jax_policy,port_policy", POLICY_PAIRS)
@pytest.mark.parametrize("preset,extra", [
    ("spikingformer-smoke", {}), ("spikingformer-smoke-dvs", {}),
    ("spikingformer-smoke", dict(image_size=24, patch_grid=6, d_model=32))])
def test_tokenizer_apply_eval(preset, extra, jax_policy, port_policy):
    from repro.configs.spikingformer import SPIKINGFORMER_PRESETS as JP
    from repro_torch.configs import SPIKINGFORMER_PRESETS as TP
    jp_, tp_ = both_policies(jax_policy)
    jcfg = dataclasses.replace(JP[preset], policy=jp_, **extra)
    tcfg = dataclasses.replace(TP[preset], policy=tp_, **extra)
    (jp, js), (tp, ts) = _init(lambda: jsf.init_tokenizer(KEY, jcfg), 6)
    rng = np.random.default_rng(6)
    shape = (jcfg.time_steps, 2, jcfg.image_size, jcfg.image_size,
             jcfg.in_channels)
    x = _spikes(rng, shape, 0.3) if jcfg.spike_input \
        else rng.random(shape).astype(np.float32)
    want, _ = jsf.tokenizer_apply(jp, js, jnp.asarray(x), jcfg, train=False)
    got, new = tsf.tokenizer_apply(tp, ts, _t(x), tcfg, train=False)
    assert got.shape == (jcfg.time_steps, 2, jcfg.num_tokens, jcfg.d_model)
    assert mismatch_fraction(got.numpy(), want) == 0.0
    assert 0.02 < float(got.mean()) < 0.98
    assert len(new) == jcfg.tokenizer_stages


def test_eager_conv_pads_one_sided_like_xla_same():
    """k3/s2 on an even size pads (0, 1): a symmetric padding=1 shifts every
    window by one pixel and this comparison fails."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(1, 2, 8, 8, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x[0]), jnp.asarray(w), window_strides=(2, 2),
        padding="SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    p, s = tl.init_bn(4)
    s = {"mean": torch.zeros(4), "var": torch.ones(4) - 1e-5}   # identity BN
    seen = {}
    real = tsf.lif_scan

    def spy(y, cfg, site):
        seen["y"] = y
        return real(y, cfg, site=site)

    tsf.lif_scan, saved = spy, tsf.lif_scan
    try:
        tsf._conv_stage_eager({"conv": {"w": _t(w)}, "bn": p}, {"bn": s},
                              _t(x), LIFConfig(), False, False,
                              named_policy("eager"), "tokenizer.conv.0")
    finally:
        tsf.lif_scan = saved
    _close(seen["y"][0], want, 1e-5)
