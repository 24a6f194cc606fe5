"""The whole model: ``repro_torch`` against the JAX package on the same
numpy-made images and the same converted parameters, under ``eager`` vs
``jnp`` and ``cuda-full`` (plain versions on the CPU) vs ``pallas-full``
(Pallas in interpret mode): the eval forward, and the BPTT loss with the
gradient of every parameter leaf and the new BN state.

Configs: the two smoke presets (square: d_model = tokens = 64), a config
with tokens != d_model != head dim, and one whose token count is not a
multiple of 8 (``attn_av`` demotes to the einsum, as at the paper preset).
BN running statistics are non-trivial everywhere.

Tolerance: logits within 1e-4 absolute (fp32 sums in another order, through
two tokenizer stages and two blocks), with the spike mismatch fraction after
the tokenizer asserted beside it: a flipped spike would spread through
attention and show in the logits, so it is held at 0. Training: the loss
within 1e-6, every gradient leaf within 1e-5 scale-aware and the new BN
state within 1e-6 (``tests/test_spikingformer.py``'s own tolerances).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (POLICY_PAIRS, as_jax, both_policies,
                         mismatch_fraction, np_tree, randomize_bn,
                         single_thread)

from repro.configs.spikingformer import SPIKINGFORMER_PRESETS as JAX_PRESETS
from repro.core import spikingformer as jsf
from repro_torch.configs import SPIKINGFORMER_PRESETS, get_spikingformer_config
from repro_torch.convert import from_jax
from repro_torch.core import spikingformer as tsf
from repro_torch.core.policy import named_policy
from repro_torch.kernels import launch_counts, reset_launch_counts

single_thread()
KEY = jax.random.PRNGKey(0)

CONFIGS = {
    "smoke": ("spikingformer-smoke", {}),
    "smoke-dvs": ("spikingformer-smoke-dvs", {}),
    # N = 16 tokens, d_model = 32, head dim 8
    "non-square": ("spikingformer-smoke", dict(
        image_size=16, patch_grid=4, d_model=32, n_heads=4, d_ff=48)),
    # N = 36 tokens: 36 % 8 != 0
    "ragged-tokens": ("spikingformer-smoke", dict(
        image_size=24, patch_grid=6, d_model=32, n_heads=2, d_ff=64,
        num_classes=7)),
}


def _configs(name, jax_policy):
    preset, extra = CONFIGS[name]
    jp, tp = both_policies(jax_policy)
    return (dataclasses.replace(JAX_PRESETS[preset], policy=jp, **extra),
            dataclasses.replace(SPIKINGFORMER_PRESETS[preset], policy=tp,
                                **extra))


def _model(jcfg, seed):
    p, s = jsf.init_spikingformer(KEY, jcfg)
    p, s = randomize_bn(np_tree(p), np_tree(s), np.random.default_rng(seed))
    return (p, s), (as_jax(p), as_jax(s)), from_jax(p, s, device="cpu")


def _images(cfg, rng, batch=2, time_axis=False):
    shape = (batch, cfg.image_size, cfg.image_size, cfg.in_channels)
    if cfg.spike_input or time_axis:
        shape = (cfg.time_steps,) + shape
    if cfg.spike_input:
        return (rng.random(shape) < 0.3).astype(np.float32)
    return rng.random(shape).astype(np.float32)


@pytest.mark.parametrize("jax_policy,port_policy", [
    p for p in POLICY_PAIRS if p[0] != "pallas"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_model_logits_match_reference(name, jax_policy, port_policy):
    jcfg, tcfg = _configs(name, jax_policy)
    _, (jp, js), (tp, ts) = _model(jcfg, 1)
    x = _images(jcfg, np.random.default_rng(2))
    want, _ = jsf.spikingformer_apply(jp, js, jnp.asarray(x), jcfg,
                                      train=False)
    taps = []
    with torch.no_grad():
        got, new_state = tsf.spikingformer_apply(tp, ts, torch.from_numpy(x),
                                                 tcfg, train=False, taps=taps)
    assert got.shape == (2, jcfg.num_classes) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert float(np.abs(np.asarray(want)).max()) > 0.1      # not all zero
    # the tokenizer's spikes, beside the logits
    x5 = x if x.ndim == 5 else np.broadcast_to(x, (jcfg.time_steps,) + x.shape)
    tok, _ = jsf.tokenizer_apply(jp["tokenizer"], js["tokenizer"],
                                 jnp.asarray(x5), jcfg, train=False)
    assert mismatch_fraction(taps[0].numpy(), tok) == 0.0
    assert len(taps) == 1 + jcfg.num_layers
    assert 0.02 < float(taps[0].mean()) < 0.98
    # eval leaves the BN state as it was
    assert torch.equal(new_state["blocks"]["smlp"]["a"]["bn"]["mean"],
                       ts["blocks"]["smlp"]["a"]["bn"]["mean"])


def test_model_matches_reference_under_the_middle_policy_and_time_chunk():
    jcfg, tcfg = _configs("smoke", "pallas")
    _, (jp, js), (tp, ts) = _model(jcfg, 3)
    x = _images(jcfg, np.random.default_rng(4), time_axis=True)
    want, _ = jsf.spikingformer_apply(jp, js, jnp.asarray(x), jcfg,
                                      train=False)
    with torch.no_grad():
        got, _ = tsf.spikingformer_apply(tp, ts, torch.from_numpy(x), tcfg,
                                         train=False)
        tiled, _ = tsf.spikingformer_apply(
            tp, ts, torch.from_numpy(x),
            dataclasses.replace(tcfg, time_chunk=1), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert torch.equal(tiled, got)      # tiling is exact in the forward


def test_from_jax_keeps_keys_shapes_and_dtypes():
    jcfg, _ = _configs("non-square", "jnp")
    (p, s), _, (tp, ts) = _model(jcfg, 5)

    def check(ref, got, path=""):
        if isinstance(ref, dict):
            assert isinstance(got, dict) and set(ref) == set(got), path
            for k in ref:
                check(ref[k], got[k], f"{path}.{k}")
        elif isinstance(ref, (list, tuple)):
            assert len(ref) == len(got), path
            for i, (a, b) in enumerate(zip(ref, got)):
                check(a, b, f"{path}[{i}]")
        else:
            assert tuple(got.shape) == ref.shape, path
            assert str(got.dtype) == f"torch.{ref.dtype}", path
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=path)

    check(p, tp)
    check(s, ts)
    # layouts as in the reference: HWIO conv, (C_in, C_out) linear, leading L
    assert tp["tokenizer"][0]["conv"]["w"].shape == (3, 3, 3, 16)
    assert tp["blocks"]["pssa"]["q"]["linear"]["w"].shape == (2, 32, 32)
    assert tp["blocks"]["smlp"]["a"]["linear"]["w"].shape == (2, 32, 48)
    assert tp["head"]["w"].shape == (32, 10)
    # the port's own init has the same tree
    ip, istate = tsf.init_spikingformer(
        torch.Generator().manual_seed(0),
        _configs("non-square", "jnp")[1], device="cpu")
    check(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), p),
          jax.tree_util.tree_map(torch.zeros_like, ip))
    check(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), s),
          jax.tree_util.tree_map(torch.zeros_like, istate))


def test_module_forward_is_the_serving_entry():
    cfg = get_spikingformer_config("spikingformer-smoke@eager")
    model = tsf.SpikingFormer(cfg, seed=3, device="cpu")
    assert not model.training
    x = torch.from_numpy(_images(cfg, np.random.default_rng(6), batch=3))
    logits = model(x)
    assert logits.shape == (3, cfg.num_classes) and not logits.requires_grad
    want, _ = tsf.spikingformer_apply(model.params, model.state, x, cfg,
                                      train=False)
    assert torch.equal(logits, want)
    # a static image batch is the time-replicated one
    x5 = x.unsqueeze(0).expand(cfg.time_steps, *x.shape)
    assert torch.equal(model(x5), logits)
    # the same weights under the other policies, plain versions on the CPU
    reset_launch_counts()
    for name in ("cuda", "cuda-full"):
        other = model.with_policy(named_policy(name))
        assert other.cfg.policy == named_policy(name)
        torch.testing.assert_close(other(x), logits, atol=1e-4, rtol=0)
    assert set(launch_counts().values()) == {0}     # no card, no launch
    names = dict(model.named_parameters())
    assert "p__blocks__pssa__q__linear__w" in names
    assert "s__tokenizer__0__bn__mean" in dict(model.named_buffers())
    assert sum(p.numel() for p in names.values()) == cfg.param_count()
    same_seed = tsf.SpikingFormer(cfg, seed=3, device="cpu")
    assert torch.equal(same_seed(x), logits)


def test_module_serves_converted_reference_weights():
    jcfg, tcfg = _configs("ragged-tokens", "pallas-full")
    _, (jp, js), (tp, ts) = _model(jcfg, 7)
    x = _images(jcfg, np.random.default_rng(8))
    want, _ = jsf.spikingformer_apply(jp, js, jnp.asarray(x), jcfg,
                                      train=False)
    model = tsf.SpikingFormer(tcfg, tp, ts, device="cpu")
    np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(),
                               np.asarray(want), atol=1e-4)


def test_train_mode_runs_under_eager_only():
    """Train mode under every policy: the train forward of the port's own
    initialisation under ``eager`` and ``cuda-full`` gives the same logits
    and the same new BN state, and ``no_grad`` builds no graph. It keeps the
    name of the refusal test it replaced."""
    cfg = get_spikingformer_config("spikingformer-smoke@eager")
    gen = torch.Generator().manual_seed(0)
    params, state = tsf.init_spikingformer(gen, cfg, device="cpu")
    x = torch.rand(2, 32, 32, 3, generator=gen)
    with torch.no_grad():
        logits, new = tsf.spikingformer_apply(params, state, x, cfg,
                                              train=True)
        full = cfg.with_policy(named_policy("cuda-full"))
        logits_f, new_f = tsf.spikingformer_apply(params, state, x, full,
                                                  train=True)
    assert not logits.requires_grad
    assert not torch.equal(new["tokenizer"][0]["bn"]["mean"],
                           state["tokenizer"][0]["bn"]["mean"])
    assert new["blocks"]["pssa"]["q"]["bn"]["var"].shape == (2, 64)
    torch.testing.assert_close(logits_f, logits, atol=1e-4, rtol=0)
    for a, b in zip(tsf.tree_leaves(new_f), tsf.tree_leaves(new)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("jax_policy,port_policy", [
    p for p in POLICY_PAIRS if p[0] != "pallas"])
@pytest.mark.parametrize("time_chunk", [None, 1])
@pytest.mark.parametrize("name", ["smoke", "smoke-dvs"])
def test_loss_grads_and_bn_state_match_reference(name, time_chunk, jax_policy,
                                                 port_policy):
    jcfg, tcfg = _configs(name, jax_policy)
    jcfg = dataclasses.replace(jcfg, time_chunk=time_chunk)
    tcfg = dataclasses.replace(tcfg, time_chunk=time_chunk)
    _, (jp, js), (tp, ts) = _model(jcfg, 11)
    x = _images(jcfg, np.random.default_rng(12))
    labels = np.array([1, 3], np.int32)
    (loss, (wstate, wm)), wgrads = jax.value_and_grad(
        jsf.spikingformer_loss, has_aux=True)(
        jp, js, jnp.asarray(x), jnp.asarray(labels), jcfg)
    grads, state, metrics = tsf.spikingformer_grad_step(
        tp, ts, torch.from_numpy(x), torch.from_numpy(labels), tcfg)
    assert abs(float(metrics["loss"]) - float(loss)) <= 1e-6
    assert float(metrics["accuracy"]) == float(wm["accuracy"])
    wleaves = jax.tree_util.tree_flatten_with_path(wgrads)[0]
    gleaves = tsf.tree_leaves(grads)
    assert len(gleaves) == len(wleaves)
    for (path, b), a in zip(wleaves, gleaves):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(
            a.numpy() / scale, b / scale, atol=1e-5, rtol=0,
            err_msg=jax.tree_util.keystr(path))
    for a, b in zip(tsf.tree_leaves(state), jax.tree.leaves(wstate)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
        assert not a.requires_grad
    # the step left its inputs alone
    assert all(not p.requires_grad for p in tsf.tree_leaves(tp))


def test_remat_recomputes_blocks_with_the_same_gradients():
    """``remat=True`` keeps only each block's input and recomputes the rest
    in the backward: the gradients and the new BN state are the same bits."""
    cfg = get_spikingformer_config("spikingformer-smoke@cuda-full")
    params, state = tsf.init_spikingformer(torch.Generator().manual_seed(4),
                                           cfg, device="cpu")
    x = torch.from_numpy(_images(cfg, np.random.default_rng(13)))
    labels = torch.tensor([0, 2])
    out = [tsf.spikingformer_grad_step(params, state, x, labels,
                                       dataclasses.replace(cfg, remat=r))
           for r in (False, True)]
    for tree in range(2):
        for a, b in zip(tsf.tree_leaves(out[0][tree]),
                        tsf.tree_leaves(out[1][tree])):
            assert torch.equal(a, b)
    assert float(out[0][2]["loss"]) == float(out[1][2]["loss"])
