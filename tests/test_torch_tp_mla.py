"""Multi-head latent attention on the model axis, on the CPU: gloo ranks
spawned once for the module (``_torch_tp_worker.py``: a world of 4
holding the (1, 4) mesh, a world of 2 the (1, 2) mesh), the reference
run here on one device.

* Reduced ``deepseek-v2-236b`` + LIF (4 MLA heads, 8 experts) at (1, 2)
  and (1, 4) under the "heads" scheme, and with 6 MLA heads at (1, 4)
  under "seq" (S = 8) and "none" (S = 7): the loss and every gradient
  leaf (``w_dq`` gathered whole from its q_lora columns, the replicated
  ``w_dkv`` / ``q_norm`` / ``kv_norm`` summed) within 1e-5 scale-aware
  of ``jax.value_and_grad(lm_loss)`` and of the port's one device, each
  leaf's gradient norm within 1e-4 of one device's (a factor of M shows),
  the query and key projections scaled by ``QK_SCALE`` and the MoE's aux
  loss weighted out (on a model axis it is the mean of the ranks' own,
  the reference's mesh semantics, held by ``test_torch_tp_moe.py``).
* Twelve decode steps at (1, 4) with the latent cache on its positions
  (16: 4 a rank, flash-decode) and on its features (18 positions: 4 of
  16 latent and 2 of 8 rope columns a rank): every step's logits and the
  cache gathered whole within 1e-5 of the mesh-less decode, the rank's
  cache its part only; and with 6 MLA heads, which 4 ranks do not divide
  (the per-head leaves stored on their last dims), on positions, without
  the LIF (a membrane within an ulp of the threshold flips there: the
  spike tolerance policy).
"""
import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_tp_worker as W
from _torch_port import (as_jax, as_torch, close_scaled, lm_batch, lm_cfgs,
                         np_tree, qk_scaled_params, single_thread)
from repro.models.lm import lm_loss as jax_lm_loss
from repro_torch.convert import lm_from_jax
from repro_torch.core.spikingformer import (tree_leaves, tree_paths,
                                            value_and_grad)
from repro_torch.models.lm import lm_loss

ARCH = "deepseek-v2-236b"
DECODE_STEPS = 12
#: key -> (MLA heads, S, scheme at M = 4)
CASES = {"mla": (4, 8, "heads"), "mla_seq": (6, 8, "seq"),
         "mla_none": (6, 7, "none")}


def _cfgs(heads: int):
    jcfg, tcfg = lm_cfgs(ARCH, "jnp")
    if heads != jcfg.mla.n_heads:
        jcfg = jcfg.replace(n_heads=heads, mla=dataclasses.replace(
            jcfg.mla, n_heads=heads))
        tcfg = tcfg.replace(n_heads=heads, mla=dataclasses.replace(
            tcfg.mla, n_heads=heads))
    return jcfg, tcfg


def _case(key):
    heads, s, _ = CASES[key]
    jcfg, tcfg = _cfgs(heads)
    jp = np_tree(qk_scaled_params(jcfg)[0])
    return jcfg, {"cfg": tcfg, "params": jp,
                  "batch": lm_batch(0, batch=2, seq=s,
                                    vocab=tcfg.vocab_size)}


def _decode_case(max_seq, heads=4):
    jcfg, tcfg = _cfgs(heads)
    if heads != 4:
        # the layer alone: at step 3 a membrane within an ulp of the
        # threshold flips on the mesh's other sum order (ROADMAP's
        # tolerance policy for spikes), which the 4-head cases hold
        tcfg = tcfg.replace(lif=None)
    return {"cfg": tcfg, "params": np_tree(qk_scaled_params(jcfg)[0]),
            "max_seq": max_seq,
            "tokens": W.decode_tokens(DECODE_STEPS, tcfg.vocab_size)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_mla"))
    jcfgs, inp = {}, {}
    for key in CASES:
        jcfgs[key], inp[key] = _case(key)
    inp["mla_d16"], inp["mla_d18"] = _decode_case(16), _decode_case(18)
    inp["mla_d16_h6"] = _decode_case(16, heads=6)
    path = os.path.join(out, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    W.spawn(4, out, [("loss_mla", (1, 4)), ("loss_mla_seq", (1, 4)),
                     ("loss_mla_none", (1, 4)), ("decode_mla_d16", (1, 4)),
                     ("decode_mla_d18", (1, 4)),
                     ("decode_mla_d16_h6", (1, 4))], path)
    W.spawn(2, out, [("loss_mla", (1, 2))], path)
    return out, inp, jcfgs


def _one_device(case):
    single_thread()
    params = lm_from_jax(case["params"], device="cpu")
    (loss, metrics), grads = value_and_grad(
        lambda p, b, c: lm_loss(p, b, c, aux_weight=0.0), params,
        as_torch(case["batch"]), case["cfg"])
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        {p: g.numpy() for p, g in zip(tree_paths(grads), tree_leaves(grads))}


def held(res, case, jcfg, loss_fn, one_device):
    """The mesh's loss and every gradient leaf against the reference's
    ``jax.value_and_grad(loss_fn)`` and the port's one device, within
    1e-5 scale-aware; each leaf's gradient norm within 1e-4 of one
    device's."""
    from test_torch_dist import _grads_by_path
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        as_jax(case["params"]), batch, jcfg)
    close_scaled(res["loss"], float(loss))
    want = _grads_by_path(grads)
    assert set(res["grads"]) == set(want)
    for k, g in want.items():
        close_scaled(res["grads"][k], g)
    loss1, metrics1, grads1 = one_device(case)
    close_scaled(res["loss"], loss1)
    for p, g in grads1.items():
        close_scaled(res["grads"][p], g)
        n = np.linalg.norm(g)
        if n > 0:
            assert abs(np.linalg.norm(res["grads"][p]) / n - 1) < 1e-4, p
    return metrics1


def _mla_loss(p, b, c):
    return jax_lm_loss(p, b, c, aux_weight=0.0)


@pytest.mark.parametrize("key,shape", [("mla", (1, 2)), ("mla", (1, 4)),
                                       ("mla_seq", (1, 4)),
                                       ("mla_none", (1, 4))])
def test_mla_lm_on_the_model_axis_matches_reference_and_one_device(
        runs, key, shape):
    out, inp, jcfgs = runs
    res = W.result(out, f"loss_{key}", shape)
    metrics = held(res, inp[key], jcfgs[key], _mla_loss, _one_device)
    assert res["metrics"]["aux_loss"] > 0.0
    if CASES[key][2] == "none":
        # every rank routes every token: the aux is one device's
        close_scaled(res["metrics"]["aux_loss"], metrics["aux_loss"])


@pytest.mark.parametrize("key,local_c,local_kr", [
    ("mla_d16", (4, 2, 4, 16), (4, 2, 4, 8)),
    ("mla_d18", (4, 2, 18, 4), (4, 2, 18, 2)),
    ("mla_d16_h6", (4, 2, 4, 16), (4, 2, 4, 8))])
def test_mla_decode_at_1x4_matches_one_device(runs, key, local_c, local_kr):
    out, inp, _ = runs
    res = W.result(out, f"decode_{key}", (1, 4))
    kv = "kv." if inp[key]["cfg"].lif is not None else ""
    assert res["local"][f"{kv}c"] == local_c
    assert res["local"][f"{kv}kr"] == local_kr
    single_thread()
    logits, cache = W.mesh_less_decode(inp[key])
    assert len(res["logits"]) == DECODE_STEPS
    for got, want in zip(res["logits"], logits):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for p, v in zip(tree_paths(cache), tree_leaves(cache)):
        np.testing.assert_allclose(res["cache"][p], v.numpy(), atol=1e-5,
                                   rtol=0, err_msg=p)
