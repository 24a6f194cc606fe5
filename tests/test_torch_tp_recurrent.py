"""The recurrent families on the model axis, on the CPU: gloo ranks
spawned once for the module (``_torch_tp_worker.py``: a world of 4
holding the (1, 4) and (2, 2) meshes, a world of 2 the (1, 2) mesh), the
reference run here on one device. The recurrent leaves are drawn in
numpy (``_torch_port.randomize_recurrent``) and the hybrid's shared
attention scaled by ``QK_SCALE``.

* Reduced ``rwkv6-7b`` + LIF (4 heads of 16) at (1, 2) and (1, 4): the
  loss and every gradient leaf within 1e-5 scale-aware of
  ``jax.value_and_grad(lm_loss)`` and of the port's one device, each
  leaf's gradient norm within 1e-4 of one device's; ``decay_bias``,
  ``mu``, ``ln_x`` and the channel mix's ``w_r`` by name (each summed
  exactly once, or not at all for the replicated gate). Twelve decode
  steps at (1, 4) with the state ``s`` on dk (4 of 16 a rank) and the
  carries on D: logits and the cache gathered whole within 1e-5 of the
  mesh-less decode.
* Reduced ``zamba2-2.7b`` + LIF (8 Mamba2 heads; ``w_in``'s 296 columns,
  74 a rank, and the conv's 160 channels, 40 a rank, cut off the heads)
  at (1, 4): loss and gradients as above; twelve decode steps with
  ``h`` on its head_dim columns and the conv state on its channels; two
  AdamW steps at (2, 2) against one device (1e-5); a (1, 4) checkpoint
  restored at (1, 2) with the same loss and leaves. Where 4 ranks divide
  the heads but not their widths, the state lies on the heads (RWKV with
  heads of 2; Mamba2 with heads of 2 and d_state 6) or on d_state
  (Mamba2 with heads of 2): twelve decode steps on each too.
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest

import _torch_tp_worker as W
from _torch_port import (as_torch, lm_batch, lm_cfgs, np_tree,
                         recurrent_params, single_thread)
from repro.models.lm import lm_loss as jax_lm_loss
from repro_torch.convert import lm_from_jax
from repro_torch.core.spikingformer import (tree_leaves, tree_paths,
                                            value_and_grad)
from repro_torch.models.lm import lm_loss
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from test_torch_tp_mla import held

DECODE_STEPS = 12
OPT = OptimizerConfig(lr=3e-4, warmup_steps=0, total_steps=10)
ARCHS = {"rwkv": "rwkv6-7b", "hyb": "zamba2-2.7b"}


def _case(key, seed=0):
    jcfg, tcfg = lm_cfgs(ARCHS[key.split("_")[0]], "jnp")
    # heads the axis's 4 ranks divide but not their widths: RWKV's state
    # on its heads (dk 2), Mamba2's h on d_state (head_dim 2) or on its
    # heads (head_dim 2, d_state 6)
    change = {"rwkv_h": {"rwkv": {"head_dim": 2}},
              "hyb_ds": {"ssm": {"head_dim": 2}},
              "hyb_h": {"ssm": {"head_dim": 2, "d_state": 6}}}.get(key, {})
    for field, kw in change.items():
        jcfg, tcfg = (c.replace(**{field: dataclasses.replace(
            getattr(c, field), **kw)}) for c in (jcfg, tcfg))
    jp = np_tree(recurrent_params(jcfg, seed)[0])
    return jcfg, {"cfg": tcfg, "params": jp,
                  "batch": lm_batch(0, batch=2, seq=16,
                                    vocab=tcfg.vocab_size),
                  "batches": [lm_batch(i, batch=4, seq=16,
                                       vocab=tcfg.vocab_size)
                              for i in range(2)],
                  "opt_cfg": OPT}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_recurrent"))
    jcfgs, inp = {}, {"opt_cfg": OPT}
    for key in (*ARCHS, "rwkv_h", "hyb_ds", "hyb_h"):
        jcfgs[key], inp[key] = _case(key)
        inp[f"{key}_d"] = {**inp[key], "max_seq": 16,
                           "tokens": W.decode_tokens(
                               DECODE_STEPS, inp[key]["cfg"].vocab_size)}
    path = os.path.join(out, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    W.spawn(4, out, [("loss_rwkv", (1, 4)), ("loss_hyb", (1, 4)),
                     ("decode_rwkv_d", (1, 4)), ("decode_hyb_d", (1, 4)),
                     ("decode_rwkv_h_d", (1, 4)), ("decode_hyb_ds_d", (1, 4)),
                     ("decode_hyb_h_d", (1, 4)),
                     ("adamw_hyb", (2, 2)), ("ckpt_write_hyb", (1, 4))],
            path)
    W.spawn(2, out, [("loss_rwkv", (1, 2)), ("ckpt_restore_hyb", (1, 2))],
            path)
    return out, inp, jcfgs


def _one_device(case):
    single_thread()
    params = lm_from_jax(case["params"], device="cpu")
    (loss, metrics), grads = value_and_grad(lm_loss, params,
                                            as_torch(case["batch"]),
                                            case["cfg"])
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        {p: g.numpy() for p, g in zip(tree_paths(grads), tree_leaves(grads))}


@pytest.mark.parametrize("key,shape", [("rwkv", (1, 2)), ("rwkv", (1, 4)),
                                       ("hyb", (1, 4))])
def test_recurrent_lm_on_the_model_axis_matches_reference_and_one_device(
        runs, key, shape):
    out, inp, jcfgs = runs
    held(W.result(out, f"loss_{key}", shape), inp[key], jcfgs[key],
         jax_lm_loss, _one_device)


@pytest.mark.parametrize("leaf", ["blocks.time.decay_bias",
                                  "blocks.time.mu", "blocks.chan.mu",
                                  "blocks.time.ln_x.scale",
                                  "blocks.time.ln_x.bias",
                                  "blocks.chan.w_r"])
def test_rwkv_replicated_leaves_are_summed_once(runs, leaf):
    """The leaves a rank uses on its columns (``decay_bias``, ``ln_x``),
    the ones whose work enters the region as its activations (``mu``) and
    the replicated gate (``w_r``): each gradient one device's, at both
    model axes, never M times it."""
    out, inp, _ = runs
    want = _one_device(inp["rwkv"])[2][leaf]
    assert np.linalg.norm(want) > 0
    for shape in ((1, 2), (1, 4)):
        got = W.result(out, "loss_rwkv", shape)["grads"][leaf]
        ratio = np.linalg.norm(got) / np.linalg.norm(want)
        assert abs(ratio - 1.0) < 1e-4, (shape, ratio)
        np.testing.assert_allclose(got, want, atol=1e-5 * max(
            1.0, float(np.abs(want).max())), rtol=0)


@pytest.mark.parametrize("key,local", [
    ("rwkv_d", {"time.s": (4, 2, 4, 4, 16), "time.x_prev": (4, 2, 1, 16),
                "chan": (4, 2, 1, 16), "lif.u": (4, 2, 64)}),
    ("hyb_d", {"mamba.h": (2, 2, 2, 8, 16, 4), "mamba.conv": (2, 2, 2, 3, 40),
               "mamba.lif.u": (2, 2, 2, 64), "shared.k": (2, 2, 16, 1, 16)}),
    ("rwkv_h_d", {"time.s": (4, 2, 8, 2, 2), "time.x_prev": (4, 2, 1, 16)}),
    ("hyb_ds_d", {"mamba.h": (2, 2, 2, 64, 4, 2),
                  "mamba.conv": (2, 2, 2, 3, 40)}),
    ("hyb_h_d", {"mamba.h": (2, 2, 2, 16, 6, 2),
                 "mamba.conv": (2, 2, 2, 3, 35)})])
def test_recurrent_decode_at_1x4_matches_one_device(runs, key, local):
    out, inp, _ = runs
    res = W.result(out, f"decode_{key}", (1, 4))
    for p, shape in local.items():
        assert res["local"][p] == shape, p
    single_thread()
    logits, cache = W.mesh_less_decode(inp[key])
    assert len(res["logits"]) == DECODE_STEPS
    for got, want in zip(res["logits"], logits):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for p, v in zip(tree_paths(cache), tree_leaves(cache)):
        np.testing.assert_allclose(res["cache"][p], v.numpy(), atol=1e-5,
                                   rtol=0, err_msg=p)


def test_hybrid_two_adamw_steps_at_2x2_match_one_device(runs):
    out, inp, _ = runs
    res = W.result(out, "adamw_hyb", (2, 2))
    single_thread()
    case = inp["hyb"]
    params = lm_from_jax(case["params"], device="cpu")
    opt = init_opt_state(params)
    step = make_train_step(case["cfg"], OPT, donate=True)
    losses = []
    for b in case["batches"]:
        params, opt, m = step(params, opt, as_torch(b))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(res["losses"], losses, rtol=0, atol=1e-5)
    for p, v in zip(tree_paths(params), tree_leaves(params)):
        np.testing.assert_allclose(res["params"][p], v.numpy(), atol=1e-5,
                                   rtol=0, err_msg=p)


def test_hybrid_checkpoint_from_1x4_restores_at_1x2(runs):
    out, _, _ = runs
    wrote = W.result(out, "ckpt_write_hyb", (1, 4))
    got = W.result(out, "ckpt_restore_hyb", (1, 2))
    assert (wrote["model"], got["model"]) == (4, 2)
    np.testing.assert_allclose(got["loss"], wrote["loss"], rtol=0,
                               atol=1e-5)
    assert set(got["params"]) == set(wrote["params"])
    for p, v in wrote["params"].items():
        np.testing.assert_array_equal(got["params"][p], v, err_msg=p)
