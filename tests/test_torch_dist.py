"""Data parallelism over ranks on the CPU: gloo, ranks spawned once for the
module (``_torch_dist_worker.py``), the reference run here on the global
batch on one device.

* The LM step at reduced ``qwen3-0.6b``, data = 2: loss within 1e-4 and
  every gradient leaf within 5e-3 of ``jax.value_and_grad(lm_loss)`` on
  the whole batch (the reference's own bounds for its mesh,
  ``tests/test_distributed.py``).
* The ``spikingformer-smoke`` vision step at data = 2 under ``eager``
  against the reference's ``jnp`` step: loss within 1e-5, every gradient
  leaf within 1e-5 relative (``tests/test_sharding.py``'s bounds), the BN
  state of the global batch within 1e-6; under ``cuda-full`` (the
  kernels' plain versions, which sum the statistics over the group) against
  the port's own mesh-less step within the same bounds.
* ``build_spikingformer_state`` shards parameters and moments alike, and
  no block leaf shards its L axis; ``train_vision`` for 3 steps with a
  checkpoint, and a resume; two AdamW steps of the LM at data = 2 against
  the port at a world of 1, parameters within 1e-6; a checkpoint written at
  data = 4 restored at data = 2 and at a world of 1, with and without the
  writer's specs, and by the mesh-less driver, values equal.
* The BN statistics' plain versions: the halves' sums added against the
  whole (no processes).
"""
import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from _torch_port import (as_jax, lm_batch, lm_cfgs, lm_params,
                         mismatch_fraction, np_tree, randomize_bn,
                         single_thread)
from repro.configs.spikingformer import SPIKINGFORMER_PRESETS as JAX_PRESETS
from repro.core import spikingformer as jsf
from repro.core.policy import named_policy as jax_named_policy
from repro.models.lm import lm_loss as jax_lm_loss
from repro_torch.convert import from_jax, lm_from_jax
from repro_torch.core.spikingformer import (spikingformer_grad_step,
                                            tree_leaves, tree_paths)
from repro_torch.kernels import fused_bn, neuron_layer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

KEY = jax.random.PRNGKey(0)
#: The driver's LM learning rate, without the warm-up. AdamW's first steps
#: move each element by about lr (m / sqrt(v) is near +-1), and an element
#: whose gradient is near 0 can land anywhere in [-lr, lr] when the two
#: runs' gradients differ in the last bits.
OPT = OptimizerConfig(lr=3e-4, warmup_steps=0, total_steps=10)


def _exact_weights(tree, rng):
    """Every weight matrix ("w") in place as multiples of 1/64 in [-1/4,
    1/4]: the products of {0,1} spikes with them, and the BN statistics'
    sums of those, are exact in fp32 whatever the order of addition, so
    the two halves' statistics are the whole batch's bit for bit and no
    spike flips between the runs. On the reference's Gaussian weights one
    ulp of a block's BN statistics, summed in another order, flips spikes
    in the next block (seen at data = 2: loss 2.2e-3 off)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "w":
                tree[k] = (rng.integers(-16, 17, v.shape) / 64).astype(
                    v.dtype)
            else:
                _exact_weights(v, rng)
    elif isinstance(tree, list):
        for v in tree:
            _exact_weights(v, rng)
    return tree


def _vision_inputs():
    jcfg = dataclasses.replace(JAX_PRESETS["spikingformer-smoke"],
                               policy=jax_named_policy("jnp"))
    p, s = jsf.init_spikingformer(KEY, jcfg)
    p, s = randomize_bn(np_tree(p), np_tree(s), np.random.default_rng(3))
    rng = np.random.default_rng(4)
    images = rng.random((4, jcfg.image_size, jcfg.image_size,
                         jcfg.in_channels)).astype(np.float32)
    _exact_weights(p["blocks"], rng)
    labels = np.array([1, 3, 0, 2], np.int32)
    return jcfg, p, s, images, labels


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawns the ranks (world 4, then 2, then 1) and returns the output
    directory and the inputs."""
    out = str(tmp_path_factory.mktemp("dist"))
    jcfg, tcfg = lm_cfgs("qwen3-0.6b", None)
    jparams, _ = lm_params(jcfg)
    _, sp, ss, images, labels = _vision_inputs()
    inp = {"lm_params": np_tree(jparams),
           "lm_batch": lm_batch(0, batch=4, seq=16, vocab=tcfg.vocab_size),
           "lm_batches": [lm_batch(i, batch=4, seq=16,
                                   vocab=tcfg.vocab_size) for i in range(2)],
           "opt_cfg": OPT, "sf_params": sp, "sf_state": ss,
           "images": images, "labels": labels}
    path = os.path.join(out, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    W.spawn(4, out, ["ckpt_write"], path)
    W.spawn(2, out, ["lm_grads", "vision_eager", "vision_cuda_full",
                     "build_state", "train_vision", "adamw_steps",
                     "ckpt_restore"], path)
    W.spawn(1, out, ["ckpt_restore"], path)
    return out, inp


def _grads_by_path(tree):
    """A JAX gradient tree by the port's dotted paths."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v) for path, v in flat}


def test_lm_step_at_data_2_matches_the_reference(runs):
    out, inp = runs
    res = W.result(out, "lm_grads", 2)
    jcfg, _ = lm_cfgs("qwen3-0.6b", None)
    batch = {k: jnp.asarray(v) for k, v in inp["lm_batch"].items()}
    (loss, _), grads = jax.value_and_grad(jax_lm_loss, has_aux=True)(
        as_jax(inp["lm_params"]), batch, jcfg)
    assert res["rows"] == 2 and res["n_sharded"] > 0
    assert abs(res["loss"] - float(loss)) < 1e-4
    want = _grads_by_path(grads)
    assert set(res["grads"]) == set(want)
    err = max(float(np.max(np.abs(res["grads"][k] - want[k])))
              for k in want)
    assert err < 5e-3, err


def _vision_reference(inp):
    jcfg, *_ = _vision_inputs()
    (loss, (state, m)), grads = jax.value_and_grad(
        jsf.spikingformer_loss, has_aux=True)(
        as_jax(inp["sf_params"]), as_jax(inp["sf_state"]),
        jnp.asarray(inp["images"]), jnp.asarray(inp["labels"]), jcfg)
    return float(loss), float(m["accuracy"]), _grads_by_path(grads), \
        _grads_by_path(state)


def _rel_err(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    return max(float(np.max(np.abs(got[k] - want[k])))
               / max(1.0, float(np.max(np.abs(want[k])))) for k in want)


def _spike_mismatch(res, inp, policy):
    """Rank 0's tokenizer output and block outputs (its rows) against the
    port's forward on the whole batch: the fraction of elements that
    differ."""
    from repro_torch.core.spikingformer import spikingformer_apply
    params, state = from_jax(inp["sf_params"], inp["sf_state"],
                             device="cpu")
    taps = []
    with torch.no_grad():
        spikingformer_apply(params, state, torch.from_numpy(inp["images"]),
                            W.vision_cfg(policy), train=True, taps=taps)
    rows = res["taps"][0].shape[1]
    return max(mismatch_fraction(a, b[:, :rows].numpy())
               for a, b in zip(res["taps"], taps))


def test_vision_step_at_data_2_matches_the_reference(runs):
    out, inp = runs
    res = W.result(out, "vision_eager", 2)
    mismatch = _spike_mismatch(res, inp, "eager")
    print(f"spike mismatch at data = 2 (eager): {mismatch}")
    assert mismatch == 0.0
    loss, acc, grads, state = _vision_reference(inp)
    assert abs(res["loss"] - loss) < 1e-5
    assert res["accuracy"] == acc
    assert _rel_err(res["grads"], grads) < 1e-5
    for k, v in state.items():
        np.testing.assert_allclose(res["state"][k], v, atol=1e-6, rtol=0)


def test_vision_kernel_path_at_data_2_matches_one_device(runs):
    """``cuda-full`` on the CPU: the neuron-layer and BN wrappers' plain
    versions with the group, against the port's mesh-less step on the whole
    batch; the spikes of every block are compared too, and held at 0
    mismatch."""
    single_thread()
    out, inp = runs
    res = W.result(out, "vision_cuda_full", 2)
    mismatch = _spike_mismatch(res, inp, "cuda-full")
    print(f"spike mismatch at data = 2 (cuda-full): {mismatch}")
    assert mismatch == 0.0
    cfg = W.vision_cfg("cuda-full")
    params, state = from_jax(inp["sf_params"], inp["sf_state"],
                             device="cpu")
    grads, new_state, m = spikingformer_grad_step(
        params, state, torch.from_numpy(inp["images"]),
        torch.from_numpy(inp["labels"]), cfg)
    assert abs(res["loss"] - float(m["loss"])) < 1e-5
    want = {p: g.numpy() for p, g in zip(tree_paths(grads),
                                         tree_leaves(grads))}
    assert _rel_err(res["grads"], want) < 1e-5
    for p, v in zip(tree_paths(new_state), tree_leaves(new_state)):
        np.testing.assert_allclose(res["state"][p], v.numpy(), atol=1e-6,
                                   rtol=0)


def test_build_state_shards_params_and_moments_alike(runs):
    out, _ = runs
    res = W.result(out, "build_state", 2)
    assert res["slices_equal"]
    assert res["shapes"] == res["m_shapes"] == res["v_shapes"]
    n_data = 0
    for path, spec, shape, full in zip(res["paths"], res["specs"],
                                       res["shapes"], res["full_shapes"]):
        if spec is not None and "data" in spec:
            n_data += 1
            k = spec.index("data")
            assert shape[k] * 2 == full[k]
            if path.startswith("blocks."):
                assert k != 0, (path, spec)     # never the L scan axis
        else:
            assert shape == full
    assert n_data >= 5


def test_train_vision_checkpoints_and_resumes_on_the_mesh(runs):
    out, _ = runs
    res = W.result(out, "train_vision", 2)
    assert len(res["hist"]) == 3 and all(np.isfinite(res["hist"]))
    assert res["latest"] == 2
    assert len(res["hist2"]) == 2          # steps 2..3 only
    assert res["hist2"][0] == res["hist"][2]   # the resumed step 2


def test_two_adamw_steps_at_data_2_equal_one_device(runs):
    out, inp = runs
    res = W.result(out, "adamw_steps", 2)
    cfg = W.lm_cfg()
    single_thread()
    params = lm_from_jax(inp["lm_params"], device="cpu")
    opt = init_opt_state(params)
    step = make_train_step(cfg, inp["opt_cfg"], donate=True)
    losses = []
    for b in inp["lm_batches"]:
        params, opt, m = step(params, opt, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(res["losses"], losses, rtol=0, atol=1e-5)
    for tree, key in ((params, "params"), (opt["m"], "m")):
        for p, v in zip(tree_paths(tree), tree_leaves(tree)):
            np.testing.assert_allclose(res[key][p], v.numpy(), atol=1e-6,
                                       rtol=0, err_msg=p)


def _written_full():
    """The data = 4 writer's tree, whole: a mesh-less build from the seed."""
    from repro_torch.launch.train import build_spikingformer_state
    params, state, opt, _ = build_spikingformer_state(
        W.vision_cfg("eager"), None, OptimizerConfig(), device="cpu")
    tree = {"params": params, "state": state, "opt": opt}
    return tree, {p: x.numpy() for p, x in
                  ckpt._flatten_with_paths(tree)}


@pytest.mark.parametrize("world", [2, 1])
@pytest.mark.parametrize("how", ["with_specs", "from_index"])
def test_checkpoint_from_data_4_restores_elsewhere(runs, world, how):
    out, _ = runs
    got = W.result(out, "ckpt_restore", world)[how]
    _, want = _written_full()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_checkpoint_from_data_4_restores_without_a_mesh(runs):
    out, _ = runs
    like, want = _written_full()
    restored = ckpt.restore_checkpoint(os.path.join(out, "elastic"), 7, like)
    for k, v in ckpt._flatten_with_paths(restored):
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def _halves(monkeypatch):
    """Stands in for the all-reduce of two ranks in one process: each odd
    call (the first half's rank) keeps its buffer, each even call (the
    second half's) has it added. The plain versions take ``group`` as an
    opaque handle."""
    bufs = []

    def all_reduce(buf, group=None):
        bufs.append(buf.clone())
        if len(bufs) % 2 == 0:
            buf += bufs[-2]
    monkeypatch.setattr(fused_bn.dist, "all_reduce", all_reduce)
    return object()


def test_plain_statistics_of_halves_equal_the_whole(monkeypatch):
    """The plain versions with a group, each half of the rows a rank, the
    halves' sums added: mu and sqrt_d (``bn_fwd``), dx (``bn_bwd``, eq. 23
    over the global sums) and mu, var and the spikes (the neuron layer)
    against the whole batch's, mu and var within 1e-6."""
    group = _halves(monkeypatch)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(1.0, 2.0, (512, 24)).astype(np.float32))
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, 24).astype(np.float32))
    beta = torch.from_numpy(rng.normal(0, 1, 24).astype(np.float32))
    _, mu, sd = fused_bn.bn_fwd_plain(x, gamma, beta)
    fused_bn.bn_fwd_plain(x[:256], gamma, beta, group=group)
    _, mu_h, sd_h = fused_bn.bn_fwd_plain(x[256:], gamma, beta, group=group)
    torch.testing.assert_close(mu_h, mu, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sd_h, sd, rtol=1e-6, atol=0)

    g = torch.from_numpy(rng.normal(0, 1, (512, 24)).astype(np.float32))
    dx, dgamma, _ = fused_bn.bn_bwd_plain(g, x, gamma, mu, sd)
    _, dg_lo, _ = fused_bn.bn_bwd_plain(g[:256], x[:256], gamma, mu, sd,
                                        group)
    dx_hi, dg_hi, _ = fused_bn.bn_bwd_plain(g[256:], x[256:], gamma, mu, sd,
                                            group)
    torch.testing.assert_close(dx_hi, dx[256:], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dg_lo + dg_hi, dgamma, rtol=1e-5, atol=1e-5)

    t, m, c = 2, 64, 16
    xs = torch.from_numpy((rng.random((t, m, c)) < 0.3).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.5, (c, 24)).astype(np.float32))
    s, nmu, nvar = neuron_layer.neuron_layer_train_plain(xs, w, gamma, beta)
    neuron_layer.neuron_layer_train_plain(xs[:, :32], w, gamma, beta,
                                          group=group)
    s_h, nmu_h, nvar_h = neuron_layer.neuron_layer_train_plain(
        xs[:, 32:], w, gamma, beta, group=group)
    torch.testing.assert_close(nmu_h, nmu, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(nvar_h, nvar, rtol=1e-6, atol=1e-6)
    assert mismatch_fraction(s_h.numpy(), s[:, 32:].numpy()) == 0.0


def test_plain_statistics_with_a_group_of_one_are_the_local_ones(
        monkeypatch):
    """A world of 1 (the all-reduce returns the buffer): the plain versions
    with a group give the group-less statistics and outputs bit for bit
    (the local sums in double, divided and rounded once)."""
    monkeypatch.setattr(fused_bn.dist, "all_reduce",
                        lambda buf, group=None: buf)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0.3, 1.7, (333, 40)).astype(np.float32))
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, 40).astype(np.float32))
    beta = torch.from_numpy(rng.normal(0, 1, 40).astype(np.float32))
    a = fused_bn.bn_fwd_plain(x, gamma, beta)
    b = fused_bn.bn_fwd_plain(x, gamma, beta, group=object())
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    g = torch.from_numpy(rng.normal(0, 1, (333, 40)).astype(np.float32))
    for u, v in zip(fused_bn.bn_bwd_plain(g, x, gamma, a[1], a[2]),
                    fused_bn.bn_bwd_plain(g, x, gamma, a[1], a[2],
                                          object())):
        assert torch.equal(u, v)
    xs = torch.from_numpy((rng.random((4, 50, 16)) < 0.3).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.5, (16, 40)).astype(np.float32))
    for u, v in zip(
            neuron_layer.neuron_layer_train_plain(xs, w, gamma, beta),
            neuron_layer.neuron_layer_train_plain(xs, w, gamma, beta,
                                                  group=object())):
        assert torch.equal(u, v)
