"""Tensor parallelism over the mesh's "model" axis on the CPU: gloo, ranks
spawned once for the module (``_torch_tp_worker.py``: a world of 4 holding
the (2, 2), (1, 4) and (4, 1) meshes, a world of 2 the (1, 2) mesh, a world
of 1 the (1, 1) mesh), the reference run here on one device.

* The Spikingformer step, ``spikingformer-smoke`` (2 heads) at (1, 2) and
  ``spikingformer-tiny`` (4 heads) at (1, 4) and (2, 2), on the exact
  1/64-step block weights: under ``eager`` against the reference's ``jnp``
  step (loss within 1e-5, every gradient leaf within 1e-5 relative, the BN
  state within 1e-6, no spike differing in any block), under
  ``cuda-full``'s plain versions against the port's mesh-less step with
  the same bounds; the eval forward's logits at (1, 2) against the
  mesh-less forward.
* Reduced ``qwen3-0.6b`` + LIF at (1, 2) (the kv heads divide), (1, 4)
  (two query heads a kv head, cut from ``wk``/``wv`` gathered over the
  group) and (2, 2): loss within 1e-4 and every gradient leaf within 5e-3
  of ``jax.value_and_grad(lm_loss)``, the reference's own mesh bounds.
  Eight decode steps at (1, 2): logits within 1e-5 of the mesh-less port,
  each rank holding its kv heads, the cache gathered whole within 1e-5 of
  the mesh-less cache.
* Two AdamW updates at (2, 2) on the same gradients against one device
  (parameters within 1e-6); two whole train steps there against one device
  (losses, parameters and the first moment within 1e-5), the leaves
  replicated over "model" bit for bit equal across the model ranks; a
  checkpoint written at (2, 2) restored at (1, 4), (4, 1) and with no
  mesh, values equal.
* At (1, 1) the train steps are the mesh-less steps bit for bit and the
  region ops launch no collective.
* Eight decode steps at (1, 4), where the 2 kv heads do not divide:
  flash-decode over a cache of 4 positions a rank, logits and the cache
  gathered whole within 1e-5 of the mesh-less port.
* Every family passes the model-axis check; only true layout errors
  raise (``ValueError`` naming the dimension and the axis), and
  ``moe_apply`` with ``model_shards`` 2 runs at (1, 2), its output within
  1e-5 of one device's.
"""
import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_worker as W
from _torch_port import (as_jax, lm_batch, lm_cfgs, lm_params,
                         mismatch_fraction, np_tree, randomize_bn,
                         single_thread)
from test_torch_dist import _exact_weights, _grads_by_path, _rel_err
from repro.configs.spikingformer import SPIKINGFORMER_PRESETS as JAX_PRESETS
from repro.core import spikingformer as jsf
from repro.core.policy import named_policy as jax_named_policy
from repro.models.lm import lm_loss as jax_lm_loss
from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import from_jax, lm_from_jax
from repro_torch.core.spikingformer import (spikingformer_apply,
                                            spikingformer_grad_step,
                                            tree_leaves, tree_paths)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import check_model_axis, make_train_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

KEY = jax.random.PRNGKey(0)
OPT = OptimizerConfig(lr=3e-4, warmup_steps=0, total_steps=10)
PRESETS = ("spikingformer-smoke", "spikingformer-tiny")
DECODE_STEPS = 8
#: (preset, mesh) of the vision step's cases.
VISION = [("smoke", (1, 2)), ("tiny", (1, 4)), ("tiny", (2, 2))]


def _vision_inputs(preset: str, seed: int):
    jcfg = dataclasses.replace(JAX_PRESETS[preset],
                               policy=jax_named_policy("jnp"))
    p, s = jsf.init_spikingformer(jax.random.PRNGKey(seed), jcfg)
    p, s = randomize_bn(np_tree(p), np_tree(s),
                        np.random.default_rng(seed + 3))
    rng = np.random.default_rng(seed + 4)
    images = rng.random((4, jcfg.image_size, jcfg.image_size,
                         jcfg.in_channels)).astype(np.float32)
    _exact_weights(p["blocks"], rng)
    return jcfg, {"params": p, "state": s, "images": images,
                  "labels": np.array([1, 3, 0, 2], np.int32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp"))
    jcfg, tcfg = lm_cfgs("qwen3-0.6b", "jnp")
    jparams, _ = lm_params(jcfg)
    inp = {"lm_cfg": tcfg, "lm_params": np_tree(jparams),
           "lm_batch": lm_batch(0, batch=4, seq=16, vocab=tcfg.vocab_size),
           "lm_batches": [lm_batch(i, batch=4, seq=16,
                                   vocab=tcfg.vocab_size) for i in range(2)],
           "decode_tokens": W.decode_tokens(DECODE_STEPS, tcfg.vocab_size),
           "opt_cfg": OPT}
    inp["adamw_grads"] = _adamw_grads(inp)
    inp["moe_shards"] = _moe_shards_inputs()
    for i, preset in enumerate(PRESETS):
        inp[preset] = _vision_inputs(preset, i)[1]
    path = os.path.join(out, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    W.spawn(4, out, [("ckpt_write", (2, 2)),
                     ("vision_tiny_eager", (2, 2)),
                     ("vision_tiny_eager", (1, 4)),
                     ("vision_tiny_cuda_full", (2, 2)),
                     ("vision_tiny_cuda_full", (1, 4)),
                     ("lm_grads", (1, 4)), ("lm_grads", (2, 2)),
                     ("adamw", (2, 2)), ("decode", (1, 4)),
                     ("ckpt_restore", (1, 4)), ("ckpt_restore", (4, 1))],
            path)
    W.spawn(2, out, [("vision_smoke_eager", (1, 2)),
                     ("vision_smoke_cuda_full", (1, 2)),
                     ("vision_eval", (1, 2)), ("lm_grads", (1, 2)),
                     ("decode", (1, 2)), ("refuse_fused_row", (1, 2)),
                     ("moe_shards", (1, 2))],
            path)
    W.spawn(1, out, [("one_by_one", (1, 1))], path)
    return out, inp


def _moe_shards_inputs() -> dict:
    """Reduced ``mixtral-8x7b``'s MoE layer (the reference's ``init_moe``
    at one shard) and a (1, 4, 64) input."""
    from repro.models.common import split_tree
    from repro.models.moe import init_moe
    jcfg, tcfg = lm_cfgs("mixtral-8x7b", None)
    params = np_tree(split_tree(init_moe(jax.random.PRNGKey(6),
                                         jcfg.moe))[0])
    x = np.random.default_rng(6).normal(0, 1, (1, 4, 64)).astype(np.float32)
    return {"cfg": tcfg, "params": params, "x": x}


def _adamw_grads(inp) -> list[dict]:
    """Two whole gradient trees for the reduced LM, by path, from a seed:
    normal, a tenth of the elements near zero."""
    rng = np.random.default_rng(11)
    params = lm_from_jax(inp["lm_params"], device="cpu")
    return [{p: (rng.normal(0, 1e-2, x.shape) * np.where(
        rng.random(x.shape) < 0.1, 1e-4, 1.0)).astype(np.float32)
        for p, x in zip(tree_paths(params), tree_leaves(params))}
        for _ in range(2)]


def _preset(short: str) -> str:
    return f"spikingformer-{short}"


def _block_mismatch(res, inp, preset, policy) -> list[float]:
    """Rank 0's tokenizer output and block outputs (its rows) against the
    port's mesh-less forward on the whole batch: per tap the fraction of
    elements that differ."""
    params, state = from_jax(inp[preset]["params"], inp[preset]["state"],
                             device="cpu")
    taps = []
    with torch.no_grad():
        spikingformer_apply(params, state,
                            torch.from_numpy(inp[preset]["images"]),
                            W.vision_cfg(preset, policy), train=True,
                            taps=taps)
    rows = res["taps"][0].shape[1]
    return [mismatch_fraction(a, b[:, :rows].numpy())
            for a, b in zip(res["taps"], taps)]


@pytest.mark.parametrize("short,shape", VISION)
def test_vision_step_on_the_model_axis_matches_the_reference(runs, short,
                                                             shape):
    out, inp = runs
    preset = _preset(short)
    res = W.result(out, f"vision_{short}_eager", shape)
    assert max(_block_mismatch(res, inp, preset, "eager")) == 0.0
    jcfg, _ = _vision_inputs(preset, PRESETS.index(preset))
    (loss, (state, m)), grads = jax.value_and_grad(
        jsf.spikingformer_loss, has_aux=True)(
        as_jax(inp[preset]["params"]), as_jax(inp[preset]["state"]),
        jnp.asarray(inp[preset]["images"]), jnp.asarray(inp[preset]["labels"]),
        jcfg)
    assert abs(res["loss"] - float(loss)) < 1e-5
    assert res["accuracy"] == float(m["accuracy"])
    assert _rel_err(res["grads"], _grads_by_path(grads)) < 1e-5
    for k, v in _grads_by_path(state).items():
        np.testing.assert_allclose(res["state"][k], v, atol=1e-6, rtol=0)


@pytest.mark.parametrize("short,shape", VISION)
def test_vision_kernel_path_on_the_model_axis_matches_one_device(
        runs, short, shape):
    """``cuda-full``'s plain versions on each rank's slices (the neuron
    layer on its columns, the BN after the row-parallel sum on the whole
    D) against the port's mesh-less step."""
    single_thread()
    out, inp = runs
    preset = _preset(short)
    res = W.result(out, f"vision_{short}_cuda_full", shape)
    assert max(_block_mismatch(res, inp, preset, "cuda-full")) == 0.0
    params, state = from_jax(inp[preset]["params"], inp[preset]["state"],
                             device="cpu")
    grads, new_state, m = spikingformer_grad_step(
        params, state, torch.from_numpy(inp[preset]["images"]),
        torch.from_numpy(inp[preset]["labels"]),
        W.vision_cfg(preset, "cuda-full"))
    assert abs(res["loss"] - float(m["loss"])) < 1e-5
    assert _rel_err(res["grads"], {p: g.numpy() for p, g in zip(
        tree_paths(grads), tree_leaves(grads))}) < 1e-5
    for p, v in zip(tree_paths(new_state), tree_leaves(new_state)):
        np.testing.assert_allclose(res["state"][p], v.numpy(), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("policy", ["eager", "cuda-full"])
def test_vision_eval_forward_at_1x2_matches_one_device(runs, policy):
    out, inp = runs
    preset = "spikingformer-smoke"
    got = W.result(out, "vision_eval", (1, 2))[policy]
    params, state = from_jax(inp[preset]["params"], inp[preset]["state"],
                             device="cpu")
    with torch.no_grad():
        want, _ = spikingformer_apply(
            params, state, torch.from_numpy(inp[preset]["images"]),
            W.vision_cfg(preset, policy), train=False)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
def test_lm_step_on_the_model_axis_matches_the_reference(runs, shape):
    out, inp = runs
    res = W.result(out, "lm_grads", shape)
    jcfg, _ = lm_cfgs("qwen3-0.6b", "jnp")
    batch = {k: jnp.asarray(v) for k, v in inp["lm_batch"].items()}
    (loss, _), grads = jax.value_and_grad(jax_lm_loss, has_aux=True)(
        as_jax(inp["lm_params"]), batch, jcfg)
    assert res["n_model"] > 0
    assert abs(res["loss"] - float(loss)) < 1e-4
    want = _grads_by_path(grads)
    assert set(res["grads"]) == set(want)
    err = max(float(np.max(np.abs(res["grads"][k] - want[k])))
              for k in want)
    assert err < 5e-3, err


def test_decode_at_1x2_matches_one_device(runs):
    out, inp = runs
    res = W.result(out, "decode", (1, 2))
    logits, cache = W.mesh_less_decode(W.decode_case(inp))
    assert len(res["logits"]) == DECODE_STEPS
    for got, want in zip(res["logits"], logits):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    hk = inp["lm_cfg"].n_kv_heads
    assert res["mode"] == "heads" and res["local_k"][3] == hk // 2
    for p, v in zip(tree_paths(cache), tree_leaves(cache)):
        np.testing.assert_allclose(res["cache"][p], v.numpy(), atol=1e-5,
                                   rtol=0, err_msg=p)


def test_two_adamw_steps_at_2x2_equal_one_device(runs):
    """Two AdamW updates on the same gradients, sharded over (2, 2) and on
    one device: parameters within 1e-6 (the global norm adds the squares
    of the model-sharded leaves over the model group, a replicated leaf's
    once)."""
    from repro_torch.train.optimizer import adamw_update
    out, inp = runs
    res = W.result(out, "adamw", (2, 2))
    params = lm_from_jax(inp["lm_params"], device="cpu")
    opt = init_opt_state(params)
    for g in inp["adamw_grads"]:
        params, opt, _ = adamw_update(params, W._tree_like(params, g), opt,
                                      OPT)
    for p, v in zip(tree_paths(params), tree_leaves(params)):
        np.testing.assert_allclose(res["update_params"][p], v.numpy(),
                                   atol=1e-6, rtol=0, err_msg=p)


def test_two_train_steps_at_2x2_match_one_device(runs):
    """Two whole train steps of the LM + LIF at (2, 2) against the port on
    one device: losses within 1e-5, parameters and the first moment within
    1e-5 (the row-parallel sums add in another order, and AdamW's
    normalised update turns a last-bit difference of a gradient near zero
    into up to 2e-6 of a parameter), and every leaf replicated over
    "model" bit for bit equal across the model ranks."""
    out, inp = runs
    res = W.result(out, "adamw", (2, 2))
    assert res["replicated_differ"] == []
    single_thread()
    cfg = inp["lm_cfg"]
    params = lm_from_jax(inp["lm_params"], device="cpu")
    opt = init_opt_state(params)
    step = make_train_step(cfg, OPT, donate=True)
    losses = []
    for b in inp["lm_batches"]:
        params, opt, m = step(params, opt, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(res["losses"], losses, rtol=0, atol=1e-5)
    for tree, key in ((params, "params"), (opt["m"], "m")):
        for p, v in zip(tree_paths(tree), tree_leaves(tree)):
            np.testing.assert_allclose(res[key][p], v.numpy(), atol=1e-5,
                                       rtol=0, err_msg=p)


def _written_full():
    from repro_torch.launch.train import build_spikingformer_state
    params, state, opt, _ = build_spikingformer_state(
        W.vision_cfg("spikingformer-tiny", "eager"), None, OptimizerConfig(),
        device="cpu")
    tree = {"params": params, "state": state, "opt": opt}
    return tree, {p: x.numpy() for p, x in ckpt._flatten_with_paths(tree)}


@pytest.mark.parametrize("shape", [(1, 4), (4, 1), None])
def test_checkpoint_from_2x2_restores_elsewhere(runs, shape):
    out, _ = runs
    like, want = _written_full()
    if shape is None:
        got = {k: v.numpy() for k, v in ckpt._flatten_with_paths(
            ckpt.restore_checkpoint(os.path.join(out, "tp_elastic"), 5,
                                    like))}
    else:
        got = W.result(out, "ckpt_restore", shape)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("what", ["vision_equal", "lm_equal",
                                  "collectives", "region_ops_identity"])
def test_a_model_axis_of_one_is_the_mesh_less_path(runs, what):
    out, _ = runs
    res = W.result(out, "one_by_one", (1, 1))
    assert res[what] == ({} if what == "collectives" else True)


@pytest.mark.parametrize("case", [
    "deepseek-v2-236b", "rwkv6-7b", "zamba2-2.7b", "whisper-large-v3",
    "mixtral-8x7b", "pixtral-12b", "moe_apply"])
def test_a11c2_families_and_moe_shards_raise(case, request):
    """Every family passes the check on a model axis of 2 (MLA and the
    rwkv, hybrid and audio families since the rest of the model axis was
    ported; the moe and vlm families, the dense LM and the
    Spikingformer); what remains refused is a true layout error, a
    ``ValueError`` naming the dimension and the axis: on an axis of 3,
    RWKV's and Mamba2's heads, whisper's GELU width and the experts.
    ``moe_apply`` with ``model_shards`` 2 runs at (1, 2): the expert
    all-to-all, y within 1e-5 of one device's (capacity factor 8:
    nothing drops), the aux loss finite."""
    mesh = mesh_mod.AbstractMesh(("data", "model"), (1, 2))
    if case == "moe_apply":
        from repro_torch.models import moe
        out, inp = request.getfixturevalue("runs")
        res = W.result(out, "moe_shards", (1, 2))
        lay = inp["moe_shards"]
        with torch.no_grad():
            y, _ = moe.moe_apply({k: torch.from_numpy(v.copy()) for k, v
                                  in lay["params"].items()},
                                 torch.from_numpy(lay["x"]), lay["cfg"].moe)
        np.testing.assert_allclose(res["y"], y.numpy(), atol=1e-5, rtol=0)
        assert np.isfinite(res["aux"])
        return
    cfg = reduced(get_config(case))
    check_model_axis(cfg, mesh)
    check_model_axis(reduced(get_config("qwen3-0.6b")), mesh)
    check_model_axis(W.vision_cfg("spikingformer-smoke", "eager"), mesh)
    three = mesh_mod.AbstractMesh(("data", "model"), (1, 3))
    want = {"deepseek-v2-236b": "dim 'd_ff'", "rwkv6-7b": "dim 'heads'",
            "zamba2-2.7b": "dim 'heads'", "whisper-large-v3": "dim 'd_ff'",
            "mixtral-8x7b": "experts", "pixtral-12b": "dim 'd_ff'"}[case]
    with pytest.raises(ValueError, match=want) as e:
        check_model_axis(cfg, three)
    assert "3" in str(e.value)


def test_a_fused_neuron_layer_at_a_row_parallel_site_raises(runs):
    """It would normalise each rank's partial sum."""
    out, _ = runs
    res = W.result(out, "refuse_fused_row", (1, 2))
    assert res["raised"] is not None and "row-parallel" in res["raised"]


def test_seq_sharded_decode_raises_naming_a11c2(runs):
    """The seq-sharded decode cache (2 kv heads over 4) is ported: the
    flash-decode merge over the ranks' positions gives the mesh-less
    logits within 1e-5 at each of the eight steps, each rank holding 4 of
    the 16 positions of both kv heads, the cache gathered whole within
    1e-5 of the mesh-less cache."""
    out, inp = runs
    res = W.result(out, "decode", (1, 4))
    logits, cache = W.mesh_less_decode(W.decode_case(inp))
    assert len(res["logits"]) == DECODE_STEPS
    for got, want in zip(res["logits"], logits):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert res["mode"] == "seq"
    assert res["local_k"][2:4] == (16 // 4, inp["lm_cfg"].n_kv_heads)
    for p, v in zip(tree_paths(cache), tree_leaves(cache)):
        np.testing.assert_allclose(res["cache"][p], v.numpy(), atol=1e-5,
                                   rtol=0, err_msg=p)


class _Placed(mesh_mod.AbstractMesh):
    """A rank's coordinates and device, without a process group."""

    def __init__(self, sizes, coords):
        super().__init__(("data", "model"), sizes)
        object.__setattr__(self, "coords", coords)
        object.__setattr__(self, "device", torch.device("cpu"))


def test_place_batch_gives_a_model_group_the_same_rows():
    """Rows are cut by the batch coordinates only: the ranks of one model
    group hold the same rows, the data ranks consecutive halves."""
    from repro_torch.train.data import place_batch
    batch = {"tokens": np.arange(8 * 3, dtype=np.int32).reshape(8, 3)}
    rows = {(d, m): place_batch(batch, _Placed((2, 2), {"data": d,
                                                        "model": m}))
            ["tokens"] for d in range(2) for m in range(2)}
    for d in range(2):
        want = torch.from_numpy(batch["tokens"][4 * d:4 * d + 4])
        assert torch.equal(rows[(d, 0)], want)
        assert torch.equal(rows[(d, 1)], want)


def test_elastic_plan_keeps_the_model_axis():
    from repro_torch.train.resilience import ElasticPlan
    plan = ElasticPlan.after_failure((2, 4), ("data", "model"), 4)
    assert plan.new_shape == (1, 4) and plan.batch_scale == 0.5
    plan = ElasticPlan.after_failure((2, 2, 4), ("pod", "data", "model"), 8)
    assert dict(zip(plan.axis_names, plan.new_shape))["model"] == 4
    with pytest.raises(RuntimeError, match="model parallelism"):
        ElasticPlan.after_failure((2, 4), ("data", "model"), 2)
