"""The encoder-decoder on the model axis, on the CPU: gloo ranks spawned
once for the module (``_torch_tp_worker.py``, a world of 4 holding the
(1, 4) mesh), the reference run here on one device. Reduced
``whisper-large-v3`` (2 + 2 layers, d 64, heads of 16), its query and key
projections scaled by ``QK_SCALE`` (C7).

* ``encdec_loss`` and every gradient leaf at (1, 4) with 4 heads (every
  attention under "heads"), with 6 heads at 8 decoder tokens over 32
  frames ("seq" in the encoder, the decoder and the cross-attention) and
  at 7 over 30 ("none"), and with a vocabulary of 514, which 4 ranks do
  not divide (the table stored and computed on D): within 1e-5
  scale-aware of ``jax.value_and_grad(encdec_loss)`` and of the port's
  one device, each leaf's gradient norm within 1e-4 of one device's (the
  GELU MLP's ``b_out``, added once after the sum, and the table by name;
  the MLPs' biases drawn in numpy, so that a bias added before the sum
  shows).
* ``init_encdec_cache`` then eight ``encdec_decode_step``s at (1, 4) with
  the cross memory on its kv heads (4 heads), its encoder positions (6
  heads, 32 frames: flash-decode over the memory) and its head_dim
  columns (6 heads, 30 frames): logits and the cache gathered whole
  within 1e-5 of the mesh-less path, each rank holding its part.
"""
import os
import pickle

import numpy as np
import pytest

import _torch_tp_worker as W
from _torch_port import (as_torch, encdec_batch, encdec_cfgs,
                         encdec_params, lm_batch, np_tree, single_thread)
from repro.models import encdec as jencdec
from repro_torch.convert import lm_from_jax
from repro_torch.core.spikingformer import (tree_leaves, tree_paths,
                                            value_and_grad)
from repro_torch.models import encdec as tencdec
from test_torch_tp_mla import held

DECODE_STEPS = 8
#: key -> (heads, decoder tokens, frames, vocabulary)
CASES = {"wh4": (4, 8, 32, 512), "wh6": (6, 8, 32, 512),
         "wh6n": (6, 7, 30, 512), "wh514": (4, 8, 32, 514)}
#: key -> (heads, frames); the cross memory's layout at M = 4
DECODES = {"whd4": (4, 32), "whd6_32": (6, 32), "whd6_30": (6, 30)}


def _params(jcfg):
    """``encdec_params`` with the GELU MLPs' biases (zeros at init) drawn
    N(0, 0.1) in numpy, so that a bias added before the row-parallel sum
    shows in the forward."""
    jp = np_tree(encdec_params(jcfg)[0])
    rng = np.random.default_rng(11)
    for blocks in ("enc_blocks", "dec_blocks"):
        for k in ("b_in", "b_out"):
            v = jp[blocks]["mlp"][k]
            jp[blocks]["mlp"][k] = rng.normal(0.0, 0.1, v.shape).astype(
                v.dtype)
    return jp


def _cfgs(heads, frames, vocab=512):
    jcfg, tcfg = encdec_cfgs()
    kw = dict(n_heads=heads, n_kv_heads=heads, encoder_seq=frames,
              vocab_size=vocab)
    return jcfg.replace(**kw), tcfg.replace(**kw)


def _case(key):
    heads, s, frames, vocab = CASES[key]
    jcfg, tcfg = _cfgs(heads, frames, vocab)
    batch = encdec_batch(0, batch=2, seq=s, frames=frames)
    batch.update({k: v for k, v in lm_batch(0, batch=2, seq=s,
                                            vocab=vocab).items()})
    return jcfg, {"cfg": tcfg, "params": _params(jcfg), "batch": batch}


def _decode_case(key):
    heads, frames = DECODES[key]
    jcfg, tcfg = _cfgs(heads, frames)
    frames_np = np.random.default_rng(3).normal(
        0.0, 1.0, (2, frames, tcfg.d_model)).astype(np.float32)
    return {"cfg": tcfg, "params": _params(jcfg), "max_seq": 16, "frames": frames_np,
            "tokens": W.decode_tokens(DECODE_STEPS, tcfg.vocab_size)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_encdec"))
    jcfgs, inp = {}, {}
    for key in CASES:
        jcfgs[key], inp[key] = _case(key)
    for key in DECODES:
        inp[key] = _decode_case(key)
    path = os.path.join(out, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    W.spawn(4, out, [(f"loss_{k}", (1, 4)) for k in CASES]
            + [(f"encdec_decode_{k}", (1, 4)) for k in DECODES], path)
    return out, inp, jcfgs


def _one_device(case):
    single_thread()
    params = lm_from_jax(case["params"], device="cpu")
    (loss, metrics), grads = value_and_grad(
        tencdec.encdec_loss, params, as_torch(case["batch"]), case["cfg"])
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        {p: g.numpy() for p, g in zip(tree_paths(grads), tree_leaves(grads))}


@pytest.mark.parametrize("key", list(CASES))
def test_encdec_on_the_model_axis_matches_reference_and_one_device(runs,
                                                                   key):
    out, inp, jcfgs = runs
    held(W.result(out, f"loss_{key}", (1, 4)), inp[key], jcfgs[key],
         jencdec.encdec_loss, _one_device)


@pytest.mark.parametrize("leaf", ["enc_blocks.mlp.b_out",
                                  "dec_blocks.mlp.b_out", "embed.table"])
def test_replicated_bias_and_split_table_are_summed_once(runs, leaf):
    """``b_out`` is added once after the row-parallel sum (before it, its
    gradient would be M times one device's); the table split on D (a
    vocabulary of 514 over 4 ranks) gets each rank's columns once."""
    out, inp, _ = runs
    for key in ("wh4", "wh514"):
        want = _one_device(inp[key])[2][leaf]
        got = W.result(out, f"loss_{key}", (1, 4))["grads"][leaf]
        ratio = np.linalg.norm(got) / np.linalg.norm(want)
        assert abs(ratio - 1.0) < 1e-4, (key, ratio)


@pytest.mark.parametrize("key,cross", [
    ("whd4", (2, 2, 32, 1, 16)), ("whd6_32", (2, 2, 8, 6, 16)),
    ("whd6_30", (2, 2, 30, 6, 4))])
def test_encdec_decode_at_1x4_matches_one_device(runs, key, cross):
    out, inp, _ = runs
    res = W.result(out, f"encdec_decode_{key}", (1, 4))
    assert res["local"]["cross.mk"] == cross
    assert res["local"]["cross.mv"] == cross
    case = inp[key]
    single_thread()
    import torch
    cfg = case["cfg"]
    params = lm_from_jax(case["params"], device="cpu")
    with torch.no_grad():
        cache = tencdec.init_encdec_cache(
            params, torch.from_numpy(case["frames"]), cfg, 2,
            case["max_seq"], torch.float32)
        logits = []
        for i, tok in enumerate(case["tokens"]):
            lg, cache = tencdec.encdec_decode_step(
                params, cache, torch.from_numpy(tok),
                torch.full((2,), i, dtype=torch.int32), cfg)
            logits.append(lg.numpy())
    assert len(res["logits"]) == DECODE_STEPS
    for got, want in zip(res["logits"], logits):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for p, v in zip(tree_paths(cache), tree_leaves(cache)):
        np.testing.assert_allclose(res["cache"][p], v.numpy(), atol=1e-5,
                                   rtol=0, err_msg=p)
