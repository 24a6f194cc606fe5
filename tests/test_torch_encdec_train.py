"""Training the encoder-decoder (audio) family in the port against the JAX
package, both on the CPU, at reduced ``whisper-large-v3`` (2 + 2 layers,
d 64, 4 heads of 16, 32 frames): ``encdec_loss`` and every gradient leaf
with and without ``remat``, three ``make_train_step`` steps,
``make_eval_step``, and the training driver (``main`` at ``--reduced``, and
the batch each step gets, beside the reference driver's for the audio,
VLM and dense families).

Parameters: the reference's ``init_encdec`` through ``convert.lm_from_jax``,
with every attention's query and key projections scaled by
``_torch_port.QK_SCALE`` (1e-5 scale-aware on every leaf), or as the
reference draws them (its sharp attention: each leaf within
``GRAD_REL_L2_AT_INIT`` relative L2). Batches: ``SyntheticLM`` plus N(0, 1)
frame embeddings (``_torch_port.encdec_batch``).
"""
import jax
import numpy as np
import pytest
import torch

from _torch_port import (GRAD_REL_L2_AT_INIT, as_jax, as_torch,
                         close_scaled, encdec_batch, encdec_cfgs,
                         encdec_params, np_tree, single_thread, trees_close)

from repro.configs import registry as jreg
from repro.launch import train as jtrain
from repro.models import encdec as jencdec
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs import registry as treg
from repro_torch.convert import opt_state_from_jax
from repro_torch.core.spikingformer import tree_leaves, value_and_grad
from repro_torch.launch import train as ttrain
from repro_torch.models import encdec as tencdec
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt

single_thread()
OPT = dict(lr=3e-4, warmup_steps=5, total_steps=10)


def _grads(jcfg, tcfg, params, batch):
    jp, tp = params
    (jl, jm), jg = jax.value_and_grad(jencdec.encdec_loss, has_aux=True)(
        jp, as_jax(batch), jcfg)
    (tl, tm), tg = value_and_grad(tencdec.encdec_loss, tp, as_torch(batch),
                                  tcfg)
    close_scaled(tl, jl)
    assert sorted(tm) == sorted(jm) == ["loss"]
    close_scaled(tm["loss"], jm["loss"])
    assert not tm["loss"].requires_grad
    return tg, jg


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("at_init", [False, True])
def test_loss_and_every_gradient_leaf_match_reference(remat, at_init):
    jcfg, tcfg = encdec_cfgs()
    jcfg, tcfg = jcfg.replace(remat=remat), tcfg.replace(remat=remat)
    params = encdec_params(jcfg, qk_scale=1.0 if at_init else 0.25)
    b = encdec_batch()
    b["loss_mask"] = (np.arange(16)[None] < np.array([[16], [9], [4], [12]])
                      ).astype(np.float32)
    tg, jg = _grads(jcfg, tcfg, params, b)
    if not at_init:
        trees_close(tg, jg)
        return
    for a, w in zip(tree_leaves(tg), jax.tree.leaves(jg)):
        w = np.asarray(w)
        assert np.linalg.norm(a.numpy() - w) <= \
            GRAD_REL_L2_AT_INIT * np.linalg.norm(w)


def test_remat_recomputes_the_same_gradients_bit_for_bit():
    """Each layer recomputed in the backward (``lscan`` under
    ``cfg.remat``) gives the gradients of the plain backward, bit for
    bit."""
    _, tcfg = encdec_cfgs()
    tp = encdec_params(encdec_cfgs()[0])[1]
    b = as_torch(encdec_batch())
    (l0, _), g0 = value_and_grad(tencdec.encdec_loss, tp, b,
                                 tcfg.replace(remat=False))
    (l1, _), g1 = value_and_grad(tencdec.encdec_loss, tp, b,
                                 tcfg.replace(remat=True))
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, c) for a, c in zip(tree_leaves(g0),
                                                 tree_leaves(g1)))


def test_three_train_steps_match_reference():
    """Three ``make_train_step`` steps from one converted state on the same
    batches: every metric after each step; parameters, m and v after the
    third, at 1e-5 scale-aware."""
    jcfg, tcfg = encdec_cfgs()
    jp, tp = encdec_params(jcfg)
    jo = jopt.init_opt_state(jp)
    js, ts = (jp, jo), (tp, opt_state_from_jax(np_tree(jo), device="cpu"))
    jstep = jax.jit(jloop.make_train_step(jcfg, jopt.OptimizerConfig(**OPT)))
    tstep = tloop.make_train_step(tcfg, topt.OptimizerConfig(**OPT))
    losses = []
    for i in range(3):
        b = encdec_batch(i)
        *js, jm = jstep(*js, as_jax(b))
        *ts, tm = tstep(*ts, as_torch(b))
        assert sorted(tm) == sorted(jm)
        for k in jm:
            close_scaled(tm[k], jm[k])
        assert float(tm["nonfinite"]) == 0.0
        losses.append(float(tm["loss"]))
    (tp, to), (jp, jo) = ts, js
    trees_close(tp, jp)
    trees_close(to["m"], jo["m"])
    trees_close(to["v"], jo["v"])
    assert int(to["step"]) == int(jo["step"]) == 3
    assert len(set(losses)) == 3


def test_eval_step_matches_reference_with_a_loss_mask():
    jcfg, tcfg = encdec_cfgs()
    jp, tp = encdec_params(jcfg)
    b = encdec_batch(4)
    b["loss_mask"] = (np.arange(16)[None] % 3 != 0).repeat(4, 0) \
        .astype(np.float32)
    jm = jloop.make_eval_step(jcfg)(jp, as_jax(b))
    tm = tloop.make_eval_step(tcfg)(tp, as_torch(b))
    assert sorted(tm) == sorted(jm) == ["loss"]
    close_scaled(tm["loss"], jm["loss"])
    assert not tm["loss"].requires_grad


def test_main_trains_reduced_whisper_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train --arch whisper-large-v3
    --reduced --steps 5 --device cpu``: the reference's batch of 8 x 128
    tokens over 8 x 32 zero frames, every step finite and logged."""
    ttrain.main(["--arch", "whisper-large-v3", "--reduced", "--steps", "5",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))   # steps 0 and 4
    assert "final loss" in out and "[guard]" not in out


def _recorded_batch(module, monkeypatch, cfg, **kw):
    """The keys, shapes and dtypes of the batch that ``module.train``
    hands its first step, through a stand-in step factory."""
    seen = {}

    def factory(*args, **kwargs):
        def step(params, opt_state, batch):
            seen.update({k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                         for k, v in batch.items()})
            return params, opt_state, {"loss": np.float32(0.0),
                                       "grad_norm": np.float32(0.0),
                                       "lr": np.float32(0.0)}
        return step
    monkeypatch.setattr(module, "make_train_step", factory)
    module.train(cfg, steps=1, global_batch=2, seq_len=8, **kw)
    return seen


@pytest.mark.parametrize("name", ["whisper-large-v3", "pixtral-12b",
                                  "qwen3-0.6b"])
def test_the_driver_s_batch_is_the_reference_driver_s(name, monkeypatch):
    """At ``--reduced``: the audio family's zero ``frames`` (B,
    encoder_seq, d_model), the VLM stub's zero ``patch_embeds`` and
    all-False ``patch_mask``, neither for a dense LM; keys, shapes and
    dtypes as the reference driver builds them."""
    want = _recorded_batch(jtrain, monkeypatch,
                           jreg.reduced(jreg.get_config(name)))
    got = _recorded_batch(ttrain, monkeypatch,
                          treg.reduced(treg.get_config(name)), device="cpu")
    assert got == want
    assert ("frames" in got) == (name == "whisper-large-v3")
    assert ("patch_mask" in got) == (name == "pixtral-12b")
    batch = ttrain.lm_step_batch(
        treg.reduced(treg.get_config(name)),
        {"tokens": np.ones((2, 8), np.int32),
         "labels": np.ones((2, 8), np.int32)}, "cpu")
    for k in ("frames", "patch_embeds", "patch_mask"):
        assert k not in batch or not batch[k].any()

