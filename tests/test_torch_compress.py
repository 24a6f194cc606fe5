"""int8 gradient compression with error feedback
(``repro_torch.train.optimizer``) against ``repro.train.optimizer``: the
reference's ``jax.random.uniform`` noise is handed to the port, so both
round the same numbers. ``compress_int8``'s dequantised gradient and
residual within 1e-7; the error-feedback property (dequantised + residual
= the gradient, the residual at most one quantisation step); one
``adamw_update`` with ``compress_grads`` (parameters, moments, residual,
gradient norm) against the reference's; the state's ``err`` tree and the
skipped step's rollback of it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import as_jax
from repro.train import optimizer as jopt
from repro_torch.core.spikingformer import tree_leaves
from repro_torch.train import optimizer as topt


@pytest.mark.parametrize("seed,scale", [(0, 1e-3), (1, 0.37), (7, 10.0),
                                        (42, 1.0)])
def test_compress_int8_equals_the_reference(seed, scale):
    g = jax.random.normal(jax.random.PRNGKey(seed), (64, 33)) * scale
    err = jax.random.normal(jax.random.PRNGKey(seed + 100), (64, 33)) * \
        scale * 0.01
    key = jax.random.PRNGKey(seed + 1)
    deq, new_err = jopt.compress_int8(g, err, key)
    noise = np.asarray(jax.random.uniform(key, g.shape)) - np.float32(0.5)
    t_deq, t_err = topt.compress_int8(torch.from_numpy(np.array(g)),
                                      torch.from_numpy(np.array(err)),
                                      torch.from_numpy(noise))
    np.testing.assert_allclose(t_deq.numpy(), np.asarray(deq), rtol=0,
                               atol=1e-7 * max(1.0, scale))
    np.testing.assert_allclose(t_err.numpy(), np.asarray(new_err), rtol=0,
                               atol=1e-7 * max(1.0, scale))


@pytest.mark.parametrize("seed,scale", [(3, 1e-3), (11, 0.5), (23, 10.0)])
def test_error_feedback_keeps_the_gradient(seed, scale):
    """dequantised + residual == the gradient, and the residual stays
    within one quantisation step (the reference's property)."""
    rng = np.random.default_rng(seed)
    g = torch.from_numpy((rng.normal(size=64) * scale).astype(np.float32))
    gen = topt.noise_generator(5, "cpu")
    deq, err = topt.compress_int8(g, torch.zeros(64), generator=gen)
    np.testing.assert_allclose((deq + err).numpy(), g.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert float(err.abs().max()) <= float(g.abs().max()) / 127 + 1e-6
    # the noise is the generator's: the same step draws the same bits
    again = topt.compress_int8(g, torch.zeros(64),
                               generator=topt.noise_generator(5, "cpu"))[0]
    assert torch.equal(again, deq)


def _ref_noise(step: int, grads):
    """The reference's noise for each leaf at ``step``, in leaf order."""
    leaves = jax.tree.leaves(grads)
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(17),
                                               step), len(leaves))
    return [torch.from_numpy(np.asarray(jax.random.uniform(k, x.shape))
                             - np.float32(0.5))
            for k, x in zip(keys, leaves)]


def test_adamw_update_with_compression_equals_the_reference(monkeypatch):
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(16, 8)).astype(np.float32),
              "b": rng.normal(size=8).astype(np.float32),
              "e": {"x": rng.normal(size=(4, 8, 3)).astype(np.float32)}}
    grads = {"w": rng.normal(size=(16, 8)).astype(np.float32),
             "b": rng.normal(size=8).astype(np.float32),
             "e": {"x": rng.normal(size=(4, 8, 3)).astype(np.float32) * 3}}
    cfg_j = jopt.OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                                 compress_grads=True)
    cfg_t = topt.OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                                 compress_grads=True)
    jstate = jopt.init_opt_state(as_jax(params), compress=True)
    jstate["err"] = jax.tree.map(lambda p: jnp.full(p.shape, 1e-3),
                                 jstate["err"])
    jp, js, jm = jopt.adamw_update(as_jax(params), as_jax(grads), jstate,
                                   cfg_j)
    tp, tg = (jax.tree.map(torch.from_numpy, t) for t in (params, grads))
    tstate = topt.init_opt_state(tp, compress=True)
    for e in tree_leaves(tstate["err"]):
        e.fill_(1e-3)
    assert set(tstate) == {"m", "v", "step", "err"}
    noise = iter(_ref_noise(1, as_jax(grads)))
    monkeypatch.setattr(topt, "draw_noise",
                        lambda gen, shape, device: next(noise))
    np_, ns, nm = topt.adamw_update(tp, tg, tstate, cfg_t)
    assert abs(float(nm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5 * \
        float(jm["grad_norm"])
    for name in ("m", "v", "err"):
        for a, b in zip(tree_leaves(ns[name]), jax.tree.leaves(js[name])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
    for a, b in zip(tree_leaves(np_), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


def test_the_donated_update_compresses_and_rolls_back_alike():
    """``adamw_update_`` writes the residual into ``err``: the same bits as
    ``adamw_update``; with ``keep`` False every leaf, ``err`` included,
    stays as it was."""
    rng = np.random.default_rng(1)
    p = {"w": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))}
    g = {"w": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))}
    cfg = topt.OptimizerConfig(warmup_steps=0, compress_grads=True)
    s0 = topt.init_opt_state(p, compress=True)
    want_p, want_s, _ = topt.adamw_update(p, g, s0, cfg)
    p2 = {"w": p["w"].clone()}
    s2 = topt.init_opt_state(p2, compress=True)
    got_p, got_s, _ = topt.adamw_update_(p2, g, s2, cfg)
    assert torch.equal(got_p["w"], want_p["w"])
    assert torch.equal(got_s["err"]["w"], want_s["err"]["w"])
    assert got_s["err"]["w"].abs().sum() > 0
    p3 = {"w": p["w"].clone()}
    s3 = topt.init_opt_state(p3, compress=True)
    topt.adamw_update_(p3, g, s3, cfg, keep=torch.tensor(False))
    assert torch.equal(p3["w"], p["w"]) and not s3["err"]["w"].any()
    assert "err" not in topt.init_opt_state(p)
