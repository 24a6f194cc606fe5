"""The jobs of ``tests/test_torch_tp.py``, run on gloo ranks on the CPU
(no JAX) by ``_torch_dist_worker``'s harness: ``spawn`` takes ``(job,
(data, model))`` pairs, each run on a mesh of that shape over the world
(one world may hold several meshes of its size); ``result`` reads rank
0's pickle of a job on a shape."""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

import _torch_dist_worker as _dist
from _torch_dist_worker import FSDP_MIN
from repro_torch.configs import get_spikingformer_config
from repro_torch.convert import from_jax, lm_from_jax
from repro_torch.core.policy import named_policy
from repro_torch.core.spikingformer import tree_leaves, tree_paths
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.specs import (cache_structs, lm_specs, param_structs,
                                      spikingformer_structs)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import place_batch
from repro_torch.train.loop import (DataParallel, lm_grads, make_train_step,
                                    vision_grads)
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state


def vision_cfg(preset: str, policy: str):
    return get_spikingformer_config(preset, policy=named_policy(policy))


shard = _dist._shard


def whole(tree, specs, mesh):
    """Every leaf of a tree of slices gathered whole, as numpy, by path."""
    return {p: mesh_mod.gather_full(x, s, mesh).numpy().copy()
            for p, x, s in zip(tree_paths(tree), tree_leaves(tree),
                               mesh_mod.spec_list(specs, tree))}


def job_vision(mesh, inp, preset, policy):
    """One BPTT step of ``preset`` on the mesh: loss, accuracy, every
    gradient leaf and the new BN state whole, and rank 0's taps (the
    tokenizer's spikes and each block's output, its rows)."""
    cfg = vision_cfg(preset, policy)
    params, state = from_jax(inp[preset]["params"], inp[preset]["state"],
                             device="cpu")
    p_specs, s_specs = spikingformer_structs(cfg, mesh, FSDP_MIN)[1]
    dp = DataParallel(cfg, mesh, p_specs)
    b = place_batch({"images": inp[preset]["images"],
                     "labels": inp[preset]["labels"]}, mesh)
    p_loc, s_loc = shard(params, p_specs, mesh), shard(state, s_specs, mesh)
    grads, new_state, metrics = vision_grads(cfg, p_loc, s_loc, b["images"],
                                             b["labels"], dp)
    from repro_torch.core.spikingformer import spikingformer_apply
    taps = []
    with mesh_mod.use_mesh(mesh), torch.no_grad():
        spikingformer_apply(dp.gather(p_loc), s_loc, b["images"], cfg,
                            train=True, taps=taps)
    return {"loss": float(metrics["loss"]),
            "accuracy": float(metrics["accuracy"]),
            "taps": [t.numpy().copy() for t in taps],
            "grads": whole(grads, p_specs, mesh),
            "state": whole(new_state, s_specs, mesh)}


def job_vision_eval(mesh, inp, preset):
    """The eval forward's logits on the mesh (rows of the whole batch on a
    data axis of 1), under ``eager`` and ``cuda-full``."""
    out = {}
    for policy in ("eager", "cuda-full"):
        cfg = vision_cfg(preset, policy)
        params, state = from_jax(inp[preset]["params"],
                                 inp[preset]["state"], device="cpu")
        p_specs, s_specs = spikingformer_structs(cfg, mesh, FSDP_MIN)[1]
        from repro_torch.core.spikingformer import spikingformer_apply
        with mesh_mod.use_mesh(mesh), torch.no_grad():
            logits, _ = spikingformer_apply(
                mesh_mod.map_specs(lambda s, x: mesh_mod.gather_leaf(
                    x, s, mesh), p_specs, shard(params, p_specs, mesh)),
                shard(state, s_specs, mesh),
                torch.from_numpy(inp[preset]["images"]), cfg, train=False)
        out[policy] = logits.numpy().copy()
    return out


def job_lm_grads(mesh, inp):
    cfg = inp["lm_cfg"]
    params = lm_from_jax(inp["lm_params"], device="cpu")
    specs = lm_specs(cfg, mesh, FSDP_MIN)[1]
    dp = DataParallel(cfg, mesh, specs)
    batch = place_batch(inp["lm_batch"], mesh)
    loss, _, grads = lm_grads(cfg, shard(params, specs, mesh), batch, dp=dp)
    n_model = sum(mesh_mod.model_dim(s, mesh) is not None
                  for s in dp.spec_list(params))
    return {"loss": float(loss), "grads": whole(grads, specs, mesh),
            "n_model": n_model}


def serving_specs(cfg, mesh):
    p_struct, p_specs = param_structs(cfg)
    return mesh_mod.sanitize_specs(p_specs, p_struct, mesh)


def job_decode(mesh, inp):
    """``inp["decode_steps"]`` decode steps of two slots from a zero cache
    holding the rank's kv heads: every step's logits, and the cache
    gathered whole at the end."""
    from repro_torch.models.lm import init_cache, lm_decode_step
    cfg = inp["lm_cfg"]
    params = shard(lm_from_jax(inp["lm_params"], device="cpu"),
                   serving_specs(cfg, mesh), mesh)
    cache = init_cache(cfg, 2, 16, torch.float32, "cpu")
    m = mesh.shape["model"]
    c_specs = mesh_mod.sanitize_specs(
        cache_structs(cfg, 2, 16, ("data",), model=m,
                      lif_replicated=True)[1], cache, mesh)
    cache = shard(cache, c_specs, mesh)
    heads = [x.shape[3] for x in tree_leaves(cache) if x.ndim == 5]
    logits = []
    with mesh_mod.use_mesh(mesh), torch.no_grad():
        for i, tok in enumerate(inp["decode_tokens"]):
            out, cache = lm_decode_step(
                params, cache, torch.from_numpy(tok),
                torch.full((2,), i, dtype=torch.int32), cfg)
            logits.append(out.numpy().copy())
    return {"logits": logits, "cache": whole(cache, c_specs, mesh),
            "local_heads": heads}


def _replicated_equal(tree, specs, mesh) -> list[str]:
    """Paths of the leaves replicated over "model" whose values differ
    between the ranks of this rank's model group (bit for bit)."""
    bad = []
    group = mesh.model_group
    for p, x, s in zip(tree_paths(tree), tree_leaves(tree),
                       mesh_mod.spec_list(specs, tree)):
        if mesh_mod.model_dim(s, mesh) is not None:
            continue
        parts = [torch.empty_like(x) for _ in range(mesh.shape["model"])]
        dist.all_gather(parts, x.contiguous(), group=group)
        if not all(torch.equal(parts[0], q) for q in parts):
            bad.append(p)
    return bad


def job_adamw(mesh, inp):
    """Two donated train steps of the LM on the mesh (the parameters and
    the first moment whole, the losses, the replicated leaves that differ
    across the model ranks), and two AdamW updates alone on the shards of
    the same whole gradients (``inp["adamw_grads"]``, by path)."""
    from repro_torch.train.optimizer import adamw_update
    cfg = inp["lm_cfg"]
    params = lm_from_jax(inp["lm_params"], device="cpu")
    specs = lm_specs(cfg, mesh, FSDP_MIN)[1]
    shards = shard(params, specs, mesh)
    opt = init_opt_state(shards)
    step = make_train_step(cfg, inp["opt_cfg"], mesh=mesh, specs=specs,
                           donate=True)
    losses = []
    for batch in inp["lm_batches"]:
        shards, opt, m = step(shards, opt, place_batch(batch, mesh))
        losses.append(float(m["loss"]))
    out = {"params": whole(shards, specs, mesh),
           "m": whole(opt["m"], specs, mesh), "losses": losses,
           "replicated_differ": _replicated_equal(shards, specs, mesh)
           + _replicated_equal(opt["v"], specs, mesh)}
    shards = shard(lm_from_jax(inp["lm_params"], device="cpu"), specs, mesh)
    opt = init_opt_state(shards)
    spec_list = mesh_mod.spec_list(specs, shards)
    for g in inp["adamw_grads"]:
        grads = shard(_tree_like(shards, g), specs, mesh)
        shards, opt, _ = adamw_update(shards, grads, opt, inp["opt_cfg"],
                                      mesh, spec_list)
    out["update_params"] = whole(shards, specs, mesh)
    return out


def _tree_like(tree, by_path: dict):
    """``tree``'s structure with the whole numpy leaves of ``by_path``."""
    from repro_torch.core.spikingformer import tree_unflatten
    return tree_unflatten(tree, [torch.from_numpy(by_path[p])
                                 for p in tree_paths(tree)])


def _vision_tree(mesh):
    from repro_torch.launch.train import build_spikingformer_state
    from repro_torch.train.optimizer import init_opt_specs
    params, state, opt, (p_specs, s_specs) = build_spikingformer_state(
        vision_cfg("spikingformer-tiny", "eager"), mesh, OptimizerConfig(),
        fsdp_min_elems=FSDP_MIN, device="cpu")
    return ({"params": params, "state": state, "opt": opt},
            {"params": p_specs, "state": s_specs,
             "opt": init_opt_specs(p_specs)})


def job_ckpt_write(mesh, inp, out):
    tree, specs = _vision_tree(mesh)
    ckpt.save_checkpoint(os.path.join(out, "tp_elastic"), 5, tree, specs,
                         mesh=mesh)
    return {"world": mesh.size}


def job_ckpt_restore(mesh, inp, out):
    """Restores the (2, 2) checkpoint under this mesh's plan; the leaves,
    gathered whole."""
    like, specs = _vision_tree(mesh)
    got = ckpt.restore_checkpoint(os.path.join(out, "tp_elastic"), 5, like,
                                  mesh, specs)
    spec_map = ckpt._spec_map(specs)
    return {path: mesh_mod.gather_full(
        leaf, ckpt._as_spec(spec_map.get(path)), mesh).numpy().copy()
        for path, leaf in ckpt._flatten_with_paths(got)}


def job_one_by_one(mesh, inp):
    """At (1, 1): the vision and LM train steps on the mesh against the
    mesh-less steps (bit for bit), and the collectives a forward and a
    backward through the region ops launch there (none)."""
    from repro_torch.core.spikingformer import value_and_grad
    from repro_torch.launch.dryrun import StepCounter
    from repro_torch.launch.train import build_spikingformer_state
    from repro_torch.models.lm import lm_loss
    out = {}
    cfg = vision_cfg("spikingformer-smoke", "cuda-full")
    opt_cfg = OptimizerConfig(lr=2e-3, warmup_steps=0, total_steps=10)
    images = torch.from_numpy(inp["spikingformer-smoke"]["images"])
    labels = torch.from_numpy(inp["spikingformer-smoke"]["labels"])
    runs = []
    for m in (mesh, None):
        p, s, o, (p_specs, _) = build_spikingformer_state(
            cfg, m, opt_cfg, fsdp_min_elems=FSDP_MIN, device="cpu")
        step = make_train_step(cfg, opt_cfg, mesh=m,
                               specs=p_specs if m is not None else None)
        runs.append(tree_leaves(step(p, s, o, images, labels)))
    out["vision_equal"] = all(torch.equal(a, b) for a, b in zip(*runs))
    lcfg = inp["lm_cfg"]
    batch = {k: torch.from_numpy(v) for k, v in inp["lm_batch"].items()}
    runs = []
    for m in (mesh, None):
        params = lm_from_jax(inp["lm_params"], device="cpu")
        step = make_train_step(lcfg, inp["opt_cfg"], mesh=m, donate=True)
        runs.append(tree_leaves(step(params, init_opt_state(params),
                                     batch)))
    out["lm_equal"] = all(torch.equal(a, b) for a, b in zip(*runs))
    # the LM has no BatchNorm, whose statistics are summed over the batch
    # group (of one rank here): any collective would be the model axis's
    params = lm_from_jax(inp["lm_params"], device="cpu")
    counter = StepCounter()
    with mesh_mod.use_mesh(mesh), counter:
        value_and_grad(lm_loss, params, batch, lcfg)
    out["collectives"] = counter.collectives
    x = torch.ones(3)
    with mesh_mod.use_mesh(mesh):
        out["region_ops_identity"] = mesh_mod.model_group() is None and \
            mesh_mod.copy_to_model(x) is x and \
            mesh_mod.reduce_from_model(x) is x
    return out


def job_refuse_seq(mesh, inp):
    """Decode of the reduced LM (2 kv heads) on a model axis of 4: the
    reference's seq-sharded cache scheme, which must raise."""
    from repro_torch.models.lm import init_cache, lm_decode_step
    cfg = inp["lm_cfg"]
    params = shard(lm_from_jax(inp["lm_params"], device="cpu"),
                   serving_specs(cfg, mesh), mesh)
    cache = init_cache(cfg, 2, 16, torch.float32, "cpu")
    try:
        with mesh_mod.use_mesh(mesh), torch.no_grad():
            lm_decode_step(params, cache, torch.zeros((2, 1), dtype=torch.int32),
                           torch.zeros((2,), dtype=torch.int32), cfg)
    except NotImplementedError as e:
        return {"raised": str(e)}
    return {"raised": None}


def job_refuse_fused_row(mesh, inp, out):
    """A policy override pinning the fused neuron layer at the
    row-parallel ``pssa.proj`` on a model axis: must raise."""
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.core.spiking_layers import init_linear_bn, \
        linear_bn_apply
    params, state = init_linear_bn(torch.Generator().manual_seed(0), 8, 16)
    pol = ExecutionPolicy(overrides=(("pssa.proj", "fused_epilogue"),))
    x = torch.zeros((2, 1, 4, 8))
    try:
        with mesh_mod.use_mesh(mesh):
            linear_bn_apply(params, state, x, train=True, policy=pol,
                            site="pssa.proj")
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


JOBS = {
    "refuse_fused_row": job_refuse_fused_row,
    "vision_smoke_eager": lambda mesh, inp, out: job_vision(
        mesh, inp, "spikingformer-smoke", "eager"),
    "vision_smoke_cuda_full": lambda mesh, inp, out: job_vision(
        mesh, inp, "spikingformer-smoke", "cuda-full"),
    "vision_tiny_eager": lambda mesh, inp, out: job_vision(
        mesh, inp, "spikingformer-tiny", "eager"),
    "vision_tiny_cuda_full": lambda mesh, inp, out: job_vision(
        mesh, inp, "spikingformer-tiny", "cuda-full"),
    "vision_eval": lambda mesh, inp, out: job_vision_eval(
        mesh, inp, "spikingformer-smoke"),
    "lm_grads": lambda mesh, inp, out: job_lm_grads(mesh, inp),
    "decode": lambda mesh, inp, out: job_decode(mesh, inp),
    "adamw": lambda mesh, inp, out: job_adamw(mesh, inp),
    "ckpt_write": job_ckpt_write,
    "ckpt_restore": job_ckpt_restore,
    "one_by_one": lambda mesh, inp, out: job_one_by_one(mesh, inp),
    "refuse_seq": lambda mesh, inp, out: job_refuse_seq(mesh, inp),
}


def spawn(world: int, out: str, jobs: list, inputs: str,
          timeout: float = 240.0) -> None:
    """``_torch_dist_worker.spawn`` of this module's jobs."""
    _dist.spawn(world, out, jobs, inputs, timeout, table=__name__)


result = _dist.result


def decode_tokens(steps: int, vocab: int) -> list:
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, (2, 1)).astype(np.int32)
            for _ in range(steps)]
