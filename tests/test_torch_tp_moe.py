"""The MoE's expert parallelism on the CPU: reduced ``mixtral-8x7b`` + LIF
(4 layers, d 64, 8 experts top-2, capacity factor 8) on gloo ranks
spawned once for the module (``_torch_tp_worker.py``: a world of 4 holding
the (1, 4) and (2, 2) meshes, a world of 2 the (1, 2) mesh), the experts
relaid from the reference's one-shard layout to the mesh's
(``reshape_moe_layout``). The reference runs here on one device, and on
its own mesh of 4 forced CPU devices in a subprocess (the JAX flag must
not reach this process), as ``tests/test_distributed.py`` runs it.

* E >= M at (1, 2) and (1, 4) (4 and 2 whole experts a rank) and E < M,
  2 experts at (1, 4) (2 ranks share an expert's F columns): with the aux
  loss weighted out, the loss and every gradient leaf within 1e-5
  scale-aware of the port's one device (no token drops at capacity
  factor 8); with it, the cross entropy, the aux loss, the total and every
  leaf within 1e-5
  scale-aware of ``jax.value_and_grad(lm_loss)`` on the reference's mesh
  of the same shape (the aux loss is the mean of the ranks', each of its
  own S/M rows, so it is the mesh's, not one device's).
* The layer at the published capacity factor 1.25 at (1, 4), where each
  rank's capacity drops other tokens than one device's: y and aux within
  1e-5 scale-aware of the reference's ``moe_apply`` on its (1, 4) mesh.
* 12 decode steps at (1, 4) (the replicated routing, every rank its
  experts, and the flash-decode cache of the 2 kv heads): logits within
  1e-5 of the mesh-less decode.
* Two AdamW steps through ``make_train_step(mesh=)`` at (2, 2) (ZeRO-3
  over "data", the all-to-all over "model"): losses within 1e-5 and every
  parameter within 1e-5 of the reference's two steps on its (2, 2) mesh.
* A checkpoint written at (1, 4) restores at (1, 2) through
  ``restore_checkpoint(moe_experts=)``: the leaves as written, the same
  cross entropy.
* ``moe.relayout`` (torch, on the device) against the checkpoints' numpy
  relay, E >= M and E < M both ways.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_tp_worker as W
from _torch_port import (QK_SCALE, as_torch, close_scaled, lm_batch,
                         lm_cfgs, lm_params, np_tree, single_thread)
from repro_torch.convert import lm_from_jax
from repro_torch.core.spikingformer import (tree_leaves, tree_paths,
                                            value_and_grad)
from repro_torch.models.lm import lm_loss
from repro_torch.train.optimizer import OptimizerConfig

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "mixtral-8x7b"
DECODE_STEPS = 12
OPT = OptimizerConfig(lr=3e-4, warmup_steps=0, total_steps=10)
#: (key, mesh) of the loss cases.
LOSS_CASES = [("mix", (1, 2)), ("mix", (1, 4)), ("mix2", (1, 4))]

#: The reference on its own meshes: ``value_and_grad(lm_loss)`` of each
#: loss case, ``moe_apply`` at capacity 1.25 and two train steps at
#: (2, 2), on 4 forced CPU devices.
REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_test_mesh, use_mesh
from repro.models.lm import lm_loss
from repro.models.moe import MoEConfig, moe_apply
from repro.train.loop import make_train_step
from repro.train.optimizer import init_opt_state
inp = pickle.load(open(sys.argv[1], "rb"))
np_ = lambda t: jax.tree.map(np.asarray, t)
out = {"loss": {}}
for (key, shape), case in inp["loss"].items():
    cfg = case["cfg"].with_model_shards(shape[1])
    with use_mesh(make_test_mesh(*shape)):
        (loss, m), g = jax.jit(lambda p, b: jax.value_and_grad(
            lm_loss, has_aux=True)(p, b, cfg))(case["params"], case["batch"])
    out["loss"][(key, shape)] = {"loss": float(loss), "ce": float(
        m["loss"]), "aux": float(m["aux_loss"]), "grads": np_(g)}
lay = inp["layer"]
cfg = MoEConfig(**{**lay["cfg"], "model_shards": 4})
with use_mesh(make_test_mesh(1, 4)):
    y, aux = jax.jit(lambda p, x: moe_apply(p, x, cfg))(lay["params"],
                                                         lay["x"])
out["layer"] = {"y": np.asarray(y), "aux": float(aux)}
st = inp["adamw"]
cfg = st["cfg"].with_model_shards(2)
params = jax.tree.map(jnp.asarray, st["params"])
opt = init_opt_state(params)
with use_mesh(make_test_mesh(2, 2)):
    step = jax.jit(make_train_step(cfg, st["opt_cfg"]))
    losses = []
    for b in st["batches"]:
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
out["adamw"] = {"losses": losses, "params": np_(params)}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _relay_nested(params: dict, old_m: int, new_m: int, e: int) -> dict:
    """The reference's tree (numpy) with its expert leaves relaid."""
    flat = W.relay_experts({f"ffn/{k}": v for k, v in
                            params["blocks"]["ffn"].items()}, old_m, new_m, e)
    ffn = {**params["blocks"]["ffn"],
           **{k.split("/")[1]: v for k, v in flat.items()}}
    return {**params, "blocks": {**params["blocks"], "ffn": ffn}}


def _flat(tree, prefix=""):
    """A nested dict of numpy leaves by ``.``-joined path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _case(experts: int | None = None):
    """(reference config, port config, reference parameters (numpy, the
    query and key projections scaled by QK_SCALE), a batch of 2 x 16)."""
    import dataclasses
    jcfg, tcfg = lm_cfgs(ARCH, "jnp")
    if experts is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                    num_experts=experts))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                                    num_experts=experts))
    jp = np_tree(lm_params(jcfg)[0])
    for k in ("wq", "wk"):
        jp["blocks"]["attn"][k] = jp["blocks"]["attn"][k] * np.float32(
            QK_SCALE)
    return jcfg, tcfg, jp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_moe"))
    jcfgs, inp, ref_in = {}, {"opt_cfg": OPT}, {"loss": {}}
    for key, experts in (("mix", None), ("mix2", 2)):
        jcfg, tcfg, jp = _case(experts)
        jcfgs[key] = jcfg
        inp[key] = {"cfg": tcfg, "params": jp,
                    "batch": lm_batch(0, batch=2, seq=16,
                                      vocab=tcfg.vocab_size)}
    for key, shape in LOSS_CASES:
        e = jcfgs[key].moe.num_experts
        ref_in["loss"][(key, shape)] = {
            "cfg": jcfgs[key], "batch": inp[key]["batch"],
            "params": _relay_nested(inp[key]["params"], 1, shape[1], e)}
    inp["mix"]["batches"] = [lm_batch(i, batch=4, seq=16,
                                      vocab=inp["mix"]["cfg"].vocab_size)
                             for i in range(2)]
    ref_in["adamw"] = {"cfg": jcfgs["mix"], "batches": inp["mix"]["batches"],
                       "params": _relay_nested(inp["mix"]["params"], 1, 2, 8),
                       "opt_cfg": _jax_opt()}
    rng = np.random.default_rng(3)
    lcfg = dict(d_model=64, num_experts=8, top_k=2, d_ff_expert=64,
                capacity_factor=1.25)
    from repro.models.moe import MoEConfig as JMoE, init_moe
    from repro.models.common import split_tree
    import jax
    lp = np_tree(split_tree(init_moe(jax.random.PRNGKey(4), JMoE(**lcfg)))[0])
    lp["router"] = lp["router"] * np.float32(10.0)   # skewed: drops
    inp["moe_layer"] = {"cfg": lcfg, "params": lp,
                        "x": rng.normal(0, 1, (2, 32, 64)).astype(np.float32)}
    ref_in["layer"] = {"cfg": lcfg, "x": inp["moe_layer"]["x"], "params": {
        k: (W.relay_experts({f"ffn/{k}": v[None]}, 1, 4, 8)[f"ffn/{k}"][0]
            if v.ndim == 4 else v) for k, v in lp.items()}}
    inp["mixd"] = {"cfg": inp["mix"]["cfg"], "params": inp["mix"]["params"],
                   "max_seq": 16,
                   "tokens": W.decode_tokens(DECODE_STEPS,
                                             inp["mix"]["cfg"].vocab_size)}
    path = os.path.join(out, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    ref_path = os.path.join(out, "reference_in.pkl")
    with open(ref_path, "wb") as f:
        pickle.dump(ref_in, f)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, ref_path,
         os.path.join(out, "reference.pkl")],
        env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"},
        cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        W.spawn(4, out, [("moe_loss", (1, 4)), ("moe_loss_no_aux", (1, 4)),
                         ("moe2_loss", (1, 4)),
                         ("moe2_loss_no_aux", (1, 4)),
                         ("moe_layer", (1, 4)), ("moe_decode", (1, 4)),
                         ("moe_adamw", (2, 2)), ("moe_ckpt_write", (1, 4))],
                path)
        W.spawn(2, out, [("moe_loss", (1, 2)), ("moe_loss_no_aux", (1, 2)),
                         ("moe_ckpt_restore", (1, 2))], path)
    finally:
        _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    with open(os.path.join(out, "reference.pkl"), "rb") as f:
        reference = pickle.load(f)
    return out, inp, jcfgs, reference


def _jax_opt():
    from repro.train.optimizer import OptimizerConfig as JOpt
    return JOpt(lr=OPT.lr, warmup_steps=OPT.warmup_steps,
                total_steps=OPT.total_steps)


def _one_device(case, aux_weight=0.0):
    single_thread()
    params = lm_from_jax(case["params"], device="cpu")
    (loss, m), grads = value_and_grad(
        lambda p, b, c: lm_loss(p, b, c, aux_weight=aux_weight), params,
        as_torch(case["batch"]), case["cfg"])
    return float(loss), {p: g.numpy() for p, g in zip(tree_paths(grads),
                                                      tree_leaves(grads))}


@pytest.mark.parametrize("key,shape", LOSS_CASES)
def test_moe_lm_without_aux_matches_one_device(runs, key, shape):
    out, inp, _, _ = runs
    res = W.result(out, f"{key.replace('mix', 'moe')}_loss_no_aux", shape)
    loss, grads = _one_device(inp[key])
    assert abs(res["loss"] - loss) < 1e-5
    assert set(res["grads"]) == set(grads)
    for p, g in grads.items():
        close_scaled(res["grads"][p], g)


@pytest.mark.parametrize("key,shape", LOSS_CASES)
def test_moe_lm_matches_the_reference_mesh(runs, key, shape):
    out, inp, jcfgs, reference = runs
    res = W.result(out, f"{key.replace('mix', 'moe')}_loss", shape)
    ref = reference["loss"][(key, shape)]
    close_scaled(res["loss"], ref["ce"])
    close_scaled(res["metrics"]["aux_loss"], ref["aux"])
    close_scaled(res["loss"] + 0.01 * res["metrics"]["aux_loss"],
                 ref["loss"])
    want = _flat(_relay_nested(ref["grads"], shape[1], 1,
                               jcfgs[key].moe.num_experts))
    assert set(res["grads"]) == set(want)
    for p, g in want.items():
        close_scaled(res["grads"][p], g)


def test_moe_layer_with_drops_matches_the_reference_mesh(runs):
    out, inp, _, reference = runs
    res = W.result(out, "moe_layer", (1, 4))
    close_scaled(res["y"], reference["layer"]["y"])
    close_scaled(res["aux"], reference["layer"]["aux"])
    # at 1.25 a rank's capacity (8 slots an expert for its 16 tokens x 2,
    # routed unevenly) drops other pairs than one device's (20 slots for
    # 64 x 2): the layer differs from the one-device layer's
    from repro_torch.models.moe import MoEConfig, moe_apply
    lay = inp["moe_layer"]
    with torch.no_grad():
        y1, _ = moe_apply({k: torch.from_numpy(v.copy()) for k, v in
                           lay["params"].items()},
                          torch.from_numpy(lay["x"]), MoEConfig(**lay["cfg"]))
    assert not np.allclose(res["y"], y1.numpy(), atol=1e-5)


def test_moe_decode_at_1x4_matches_one_device(runs):
    out, inp, _, _ = runs
    res = W.result(out, "moe_decode", (1, 4))
    assert res["mode"] == "seq"
    single_thread()
    logits, _ = W.mesh_less_decode(inp["mixd"])
    assert len(res["logits"]) == DECODE_STEPS
    for got, want in zip(res["logits"], logits):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_two_adamw_steps_at_2x2_match_the_reference_mesh(runs):
    out, _, _, reference = runs
    res = W.result(out, "moe_adamw", (2, 2))
    ref = reference["adamw"]
    np.testing.assert_allclose(res["losses"], ref["losses"], atol=1e-5,
                               rtol=0)
    want = _flat(_relay_nested(ref["params"], 2, 1, 8))
    assert set(res["params"]) == set(want)
    for p, v in want.items():
        np.testing.assert_allclose(res["params"][p], v, atol=1e-5, rtol=0,
                                   err_msg=p)


def test_moe_checkpoint_from_1x4_restores_at_1x2(runs):
    """The leaves come back as written (relaid to one shard, equal bit for
    bit), and the cross entropy is the same (the aux loss, a mean over
    the ranks' rows, is each mesh's own)."""
    out, inp, _, _ = runs
    wrote = W.result(out, "moe_ckpt_write", (1, 4))
    got = W.result(out, "moe_ckpt_restore", (1, 2))
    assert (wrote["model"], got["model"]) == (4, 2)
    assert abs(got["loss"] - wrote["loss"]) < 1e-5
    want = _flat(inp["mix"]["params"])
    assert set(got["params"]) == set(want)
    for p, v in want.items():
        np.testing.assert_array_equal(got["params"][p], v, err_msg=p)


@pytest.mark.parametrize("e,old,new", [(8, 1, 4), (8, 4, 2), (2, 1, 4),
                                       (2, 4, 1), (2, 2, 4)])
def test_relayout_on_the_device_is_the_checkpoint_relay(e, old, new):
    """``moe.relayout`` (torch, any leading dims) gives
    ``reshape_moe_layout``'s layout for ``w_gate`` / ``w_up``, and for
    ``w_down`` (F on its second last axis) the same relay along F; it
    round-trips."""
    from repro_torch.models.moe import relayout
    from repro_torch.train.checkpoint import reshape_moe_layout
    rng = np.random.default_rng(e * 100 + old * 10 + new)
    el, fl = max(1, e // old), 8 // max(1, old // e)
    w = rng.normal(0, 1, (3, old, el, 5, fl)).astype(np.float32)
    got = relayout(torch.from_numpy(w), new, e).numpy()
    want = np.stack([reshape_moe_layout(a, old, new, e) for a in w])
    np.testing.assert_array_equal(got, want)
    down = np.ascontiguousarray(np.swapaxes(w, -1, -2))
    got = relayout(torch.from_numpy(down), new, e, f_dim=-2).numpy()
    np.testing.assert_array_equal(got, np.swapaxes(want, -1, -2))
    back = relayout(relayout(torch.from_numpy(w), new, e), old, e).numpy()
    np.testing.assert_array_equal(back, w)
