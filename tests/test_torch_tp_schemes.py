"""The model axis's second half for the dense and vlm LMs on the CPU: gloo
ranks spawned once for the module (``_torch_tp_worker.py``: a world of 4
holding the (1, 4) mesh, a world of 2 the (1, 2) mesh), the reference run
here on one device.

* The attention layer under the reference's schemes where 4 ranks do not
  divide the heads: "seq" (6 heads, kv 6 and kv 3, S = 8; with QKV bias,
  qk-norm and a sliding window) and "none" (S = 7), through
  ``attention`` and through ``flash_attention`` with ``kv_chunk`` < S:
  the output, the gradient of every leaf (stored under the plan, gathered
  whole) and of x within 1e-5 scale-aware of the reference's one-device
  layer. "none" computes the whole layer on every rank: a summed gradient
  would be 4 times too large, which the bound catches.
* The LM + LIF at (1, 4) under "seq" (6 heads, kv 6 and kv 3, S = 8) and
  "none" (S = 7) through ``lm_grads`` and ``DataParallel``: the loss
  within 1e-4 and every gradient leaf within 5e-3 of
  ``jax.value_and_grad(lm_loss)`` (the reference's own mesh bounds, as in
  ``test_torch_tp.py``), and within 1e-5 scale-aware of the port's one
  device.
* Decode of reduced ``qwen3-0.6b`` + LIF (2 kv heads) at (1, 4): the
  flash-decode ("seq") mode on a cache of 16 positions, 4 a rank, 12
  steps, and on a sliding window of 8 (a ring buffer of 2 a rank that the
  12 steps wrap); the head_dim mode on a cache of 18 (4 of 16 columns a
  rank, qk-norm and RoPE on the whole head before the cut): every step's
  logits and the cache gathered whole within 1e-5 of the mesh-less
  decode.
* Two train steps of reduced ``qwen3-0.6b`` + LIF on a (pod 2, data 2,
  model 1) mesh, whose plan splits leaves over "data" alone, against one
  device (1e-5).
* ``pixtral-12b`` reduced + LIF at (1, 2), with the patch merge, under
  the "heads" scheme: loss and gradients as the LM's above, but each leaf
  within 1e-4 relative L2 of one device.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_tp_worker as W
from _torch_port import (as_jax, as_torch, close_scaled, lm_batch, lm_cfgs,
                         lm_params, np_tree, single_thread)
from repro.models import attention as jattn
from repro.models.common import split_tree as j_split_tree
from repro.models.lm import lm_loss as jax_lm_loss
from repro_torch.convert import lm_from_jax
from repro_torch.core.spikingformer import (tree_leaves, tree_paths,
                                            value_and_grad)
from repro_torch.models import attention as tattn
from repro_torch.models.lm import lm_loss
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

DECODE_STEPS = 12
OPT = OptimizerConfig(lr=3e-4, warmup_steps=0, total_steps=10)
#: name -> (heads, kv heads, S, kv_chunk or None, extra AttnConfig fields)
ATTN_CASES = {
    "seq_kv6": (6, 6, 8, None, {}),
    "seq_kv3_bias_window": (6, 3, 8, None, {"qkv_bias": True,
                                            "sliding_window": 3}),
    "none_kv3": (6, 3, 7, None, {}),
    "flash_seq_kv3": (6, 3, 8, 4, {}),
    "flash_none_kv3": (6, 3, 6, 3, {"sliding_window": 4}),
    "heads_kv2": (4, 2, 8, None, {}),
}
SCHEME = {"seq_kv6": "seq", "seq_kv3_bias_window": "seq",
          "none_kv3": "none", "flash_seq_kv3": "seq",
          "flash_none_kv3": "none", "heads_kv2": "heads"}
#: LM cases: key -> (heads, kv heads, S)
LM_CASES = {"seq6": (6, 6, 8), "seq3": (6, 3, 8), "none3": (6, 3, 7)}


def _attn_case(name, seed):
    h, hk, s, chunk, extra = ATTN_CASES[name]
    kw = dict(d_model=64, n_heads=h, n_kv_heads=hk, d_head=16, qk_norm=True,
              **extra)
    jcfg, tcfg = jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)
    params = np_tree(j_split_tree(jattn.init_attention(
        jax.random.PRNGKey(seed), jcfg))[0])
    rng = np.random.default_rng(seed)
    if "bq" in params:      # zero at init: give the bias gradient a value
        for k in ("bq", "bk", "bv"):
            params[k] = rng.normal(0, 0.1, params[k].shape).astype(np.float32)
    x = rng.normal(0, 1, (2, s, 64)).astype(np.float32)
    cot = rng.normal(0, 1, (2, s, 64)).astype(np.float32)
    return jcfg, {"cfg": tcfg, "params": params, "x": x, "cot": cot,
                  "kv_chunk": chunk}


def _lm_case(key):
    h, hk, s = LM_CASES[key]
    jcfg, tcfg = lm_cfgs("qwen3-0.6b", "jnp")
    jcfg = jcfg.replace(n_heads=h, n_kv_heads=hk)
    tcfg = tcfg.replace(n_heads=h, n_kv_heads=hk)
    jparams, _ = lm_params(jcfg)
    return jcfg, {"cfg": tcfg, "params": np_tree(jparams),
                  "batch": lm_batch(0, batch=2, seq=s,
                                    vocab=tcfg.vocab_size)}


def _vlm_case():
    jcfg, tcfg = lm_cfgs("pixtral-12b", "jnp")
    jparams, _ = lm_params(jcfg)
    rng = np.random.default_rng(5)
    batch = dict(lm_batch(0, batch=2, seq=8, vocab=tcfg.vocab_size))
    batch["patch_embeds"] = rng.normal(0, 1, (2, 8, tcfg.d_model)).astype(
        np.float32)
    batch["patch_mask"] = rng.random((2, 8)) < 0.5
    return jcfg, {"cfg": tcfg, "params": np_tree(jparams), "batch": batch}


def _decode_case(max_seq, window=None):
    jcfg, tcfg = lm_cfgs("qwen3-0.6b", "jnp")
    if window is not None:
        tcfg = tcfg.replace(sliding_window=window)
    jparams, _ = lm_params(jcfg)
    return {"cfg": tcfg, "params": np_tree(jparams), "max_seq": max_seq,
            "tokens": W.decode_tokens(DECODE_STEPS, tcfg.vocab_size)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_schemes"))
    jcfgs = {}
    inp = {"attn": {}}
    for i, name in enumerate(ATTN_CASES):
        jcfgs[name], inp["attn"][name] = _attn_case(name, i)
    for key in LM_CASES:
        jcfgs[key], inp[key] = _lm_case(key)
    jcfgs["vlm"], inp["vlm"] = _vlm_case()
    inp["dseq"] = _decode_case(16)
    inp["dwin"] = _decode_case(16, window=8)
    inp["dhd"] = _decode_case(18)
    _, tcfg = lm_cfgs("qwen3-0.6b", "jnp")
    inp["pod"] = {"cfg": tcfg, "params": inp["dseq"]["params"],
                  "batches": [lm_batch(i, batch=4, seq=16,
                                       vocab=tcfg.vocab_size)
                              for i in range(2)]}
    inp["opt_cfg"] = OPT
    path = os.path.join(out, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    W.spawn(4, out, [("attn_layer", (1, 4)), ("lm_seq6", (1, 4)),
                     ("lm_seq3", (1, 4)), ("lm_none3", (1, 4)),
                     ("decode_seq", (1, 4)), ("decode_window", (1, 4)),
                     ("decode_head_dim", (1, 4)), ("pod_adamw", (4, 1))],
            path)
    W.spawn(2, out, [("lm_vlm", (1, 2))], path)
    return out, inp, jcfgs


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_attention_scheme_matches_the_reference_layer(runs, name):
    out, inp, jcfgs = runs
    res = W.result(out, "attn_layer", (1, 4))[name]
    case = inp["attn"][name]
    assert res["scheme"] == SCHEME[name]
    jp = as_jax(case["params"])
    x = jnp.asarray(case["x"])

    def f(p, x):
        if case["kv_chunk"]:
            y = jattn.flash_attention(p, x, jcfgs[name],
                                      kv_chunk=case["kv_chunk"])
        else:
            y = jattn.attention(p, x, jcfgs[name])
        return (y * case["cot"]).sum(), y
    (_, y), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jp, x)
    close_scaled(res["y"], y)
    close_scaled(res["dx"], gx)
    assert set(res["grads"]) == set(gp)
    for k, g in gp.items():
        got = res["grads"][k]
        if isinstance(g, dict):     # q_norm / k_norm
            got, g = got["scale"], g["scale"]
        close_scaled(got, g)
        # a gradient summed over the four ranks that each computed all of
        # it would be 4x: the norms' ratio is 1
        ratio = np.linalg.norm(got) / max(np.linalg.norm(np.asarray(g)),
                                          1e-30)
        assert abs(ratio - 1.0) < 1e-4, (k, ratio)


def _one_device(key, inp):
    single_thread()
    case = inp[key]
    params = lm_from_jax(case["params"], device="cpu")
    (loss, _), grads = value_and_grad(lm_loss, params,
                                      as_torch(case["batch"]), case["cfg"])
    return float(loss), {p: g.numpy() for p, g in zip(tree_paths(grads),
                                                      tree_leaves(grads))}


def _held(res, key, inp, jcfg, rel_l2=None):
    """The reference's mesh bounds against ``jax.value_and_grad``, and
    against the port's one device the loss within 1e-5 and each gradient
    leaf within 1e-5 scale-aware, or (``rel_l2``) within that relative L2
    error."""
    batch = {k: jnp.asarray(v) for k, v in inp[key]["batch"].items()}
    (loss, _), grads = jax.value_and_grad(jax_lm_loss, has_aux=True)(
        as_jax(inp[key]["params"]), batch, jcfg)
    assert abs(res["loss"] - float(loss)) < 1e-4
    from test_torch_dist import _grads_by_path
    want = _grads_by_path(grads)
    assert set(res["grads"]) == set(want)
    err = max(float(np.max(np.abs(res["grads"][k] - want[k])))
              for k in want)
    assert err < 5e-3, err
    loss1, grads1 = _one_device(key, inp)
    assert abs(res["loss"] - loss1) < 1e-5
    for p, g in grads1.items():
        if rel_l2 is None:
            close_scaled(res["grads"][p], g)
        else:
            err = np.linalg.norm(res["grads"][p] - g) / np.linalg.norm(g)
            assert err <= rel_l2, (p, err)


@pytest.mark.parametrize("key", list(LM_CASES))
def test_lm_step_under_seq_and_none_matches_reference_and_one_device(
        runs, key):
    out, inp, jcfgs = runs
    _held(W.result(out, f"lm_{key}", (1, 4)), key, inp, jcfgs[key])


def test_vlm_step_at_1x2_matches_reference_and_one_device(runs):
    """The "heads" scheme (4 heads over 2): against one device each leaf
    within 1e-4 relative L2 (the rank's heads' and hidden features'
    partial sums add in another order; 2.2e-5 measured, the loss equal)."""
    out, inp, jcfgs = runs
    assert inp["vlm"]["batch"]["patch_mask"].any()
    _held(W.result(out, "lm_vlm", (1, 2)), "vlm", inp, jcfgs["vlm"],
          rel_l2=1e-4)


@pytest.mark.parametrize("job,key,mode,local", [
    ("decode_seq", "dseq", "seq", (2, 4, 2, 16)),
    ("decode_window", "dwin", "seq", (2, 2, 2, 16)),
    ("decode_head_dim", "dhd", "head_dim", (2, 18, 2, 4))])
def test_decode_mode_at_1x4_matches_one_device(runs, job, key, mode, local):
    out, inp, _ = runs
    res = W.result(out, job, (1, 4))
    assert res["mode"] == mode
    assert res["local_k"][1:] == local
    single_thread()
    logits, cache = W.mesh_less_decode(inp[key])
    assert len(res["logits"]) == DECODE_STEPS
    for got, want in zip(res["logits"], logits):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for p, v in zip(tree_paths(cache), tree_leaves(cache)):
        np.testing.assert_allclose(res["cache"][p], v.numpy(), atol=1e-5,
                                   rtol=0, err_msg=p)


def test_decode_modes_follow_the_reference_rule():
    """The cache's layout (``cache_structs`` at the mesh's model axis)
    gives the mode the reference's rule names: heads where the kv heads
    divide, else flash-decode where the positions do, else head_dim."""
    from repro_torch.launch.specs import cache_structs
    _, cfg = lm_cfgs("qwen3-0.6b", None)
    for m, max_seq, want in ((2, 16, 3), (4, 16, 2), (4, 18, 4)):
        specs = cache_structs(cfg, 2, max_seq, ("data",), model=m)[1]
        assert specs["k"][want] == "model", (m, max_seq, specs["k"])


def test_two_train_steps_on_a_pod_mesh_match_one_device(runs):
    """(pod 2, data 2, model 1): the plan splits the large leaves over
    "data" alone and replicates them over "pod", as the reference's does;
    each is gathered over its data group and its gradient reduce-scattered
    there and summed over the pod group. Two train steps of the LM + LIF:
    losses and every parameter within 1e-5 of one device (AdamW's
    normalised update as ``test_torch_tp.py`` holds it)."""
    out, inp, _ = runs
    res = W.result(out, "pod_adamw", (4, 1))
    assert res["data_only"]
    single_thread()
    case = inp["pod"]
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
