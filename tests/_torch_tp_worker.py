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
from repro_torch.core.spikingformer import tree_leaves, tree_map, tree_paths
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


def decode_case(inp) -> dict:
    """``inp``'s reduced LM as a decode case of :func:`job_decode_key`:
    ``inp["decode_tokens"]`` from a cache of 16 positions."""
    return {"cfg": inp["lm_cfg"], "params": inp["lm_params"], "max_seq": 16,
            "tokens": inp["decode_tokens"]}


def mesh_less_decode(case) -> tuple[list, dict]:
    """A decode case's steps on one device: every step's logits (numpy)
    and the final cache."""
    from repro_torch.models.lm import init_cache, lm_decode_step
    cfg = case["cfg"]
    params = lm_from_jax(case["params"], device="cpu")
    cache = init_cache(cfg, 2, case["max_seq"], torch.float32, "cpu")
    logits = []
    with torch.no_grad():
        for i, tok in enumerate(case["tokens"]):
            out, cache = lm_decode_step(
                params, cache, torch.from_numpy(tok),
                torch.full((2,), i, dtype=torch.int32), cfg)
            logits.append(out.numpy())
    return logits, cache


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


def job_moe_shards(mesh, inp):
    """``moe_apply`` of reduced ``mixtral-8x7b``'s layer (capacity factor
    8) with ``model_shards`` bound to the mesh's model axis, its experts
    relaid from one shard: y and aux."""
    from repro_torch.models.moe import moe_apply
    case = inp["moe_shards"]
    cfg = case["cfg"].with_model_shards(mesh.shape["model"]).moe
    flat = relay_experts({f"ffn/{k}": v[None] for k, v in
                          case["params"].items() if v.ndim == 4}, 1,
                         cfg.model_shards, cfg.num_experts)
    spec = mesh_mod.P("model", None, None, None)
    loc = {k: torch.from_numpy(v) for k, v in case["params"].items()}
    loc.update({k.split("/")[1]: mesh_mod.local_shard(
        torch.from_numpy(v[0]), spec, mesh) for k, v in flat.items()})
    with mesh_mod.use_mesh(mesh), torch.no_grad():
        y, aux = moe_apply(loc, torch.from_numpy(case["x"]), cfg)
    return {"y": y.numpy().copy(), "aux": float(aux)}


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


# ---------------------------------------------------------------------------
# The second half of the model axis: the attention's "seq" and "none"
# schemes, the decode's flash-decode and head_dim modes, the VLM, the MoE
# ---------------------------------------------------------------------------

def relay_experts(tree: dict, old_m: int, new_m: int, num_experts: int
                  ) -> dict:
    """A whole LM tree, by path (numpy; ``.`` or ``/`` between the keys),
    with its stacked expert leaves relaid from ``old_m`` to ``new_m``
    model shards (``models.moe.relayout``: ``w_down`` along F)."""
    from repro_torch.models.moe import relayout
    out = {}
    for p, x in tree.items():
        x = np.asarray(x)
        if p.replace(".", "/").endswith(
                ("ffn/w_gate", "ffn/w_up", "ffn/w_down")) and x.ndim == 5:
            assert x.shape[1] == old_m
            x = relayout(torch.from_numpy(np.array(x)), new_m, num_experts,
                         -2 if p.endswith("w_down") else -1).numpy().copy()
        out[p] = x
    return out


def _by_path(tree) -> dict:
    return {p: x.numpy() if isinstance(x, torch.Tensor) else x
            for p, x in zip(tree_paths(tree), tree_leaves(tree))}


def mesh_params(inp, key: str, mesh):
    """(cfg bound to the mesh's model axis, the LM's parameters whole on
    the CPU, relaid to it): ``inp[key]``'s config and the reference's
    parameters converted (an MoE's written at one model shard)."""
    from repro_torch.launch.specs import bind_model_axis
    cfg = bind_model_axis(inp[key]["cfg"], mesh)
    params = lm_from_jax(inp[key]["params"], device="cpu")
    if cfg.moe is not None and cfg.moe.model_shards > 1:
        flat = relay_experts(_by_path(params), 1, cfg.moe.model_shards,
                             cfg.moe.num_experts)
        params = _tree_like(params, flat)
    return cfg, params


def job_attn_layer(mesh, inp):
    """Each case of ``inp["attn"]``: the attention layer (``attention``,
    or ``flash_attention`` at ``kv_chunk``) on the mesh, its leaves stored
    under the plan's specs: the output, the gradients of ``(y * cot).sum()``
    for every leaf (gathered whole) and for x, and the scheme taken."""
    from repro_torch.launch.specs import META
    from repro_torch.models import attention as A
    from repro_torch.models.common import split_tree
    out = {}
    for name, case in inp["attn"].items():
        cfg = case["cfg"]
        whole_p = tree_map(torch.from_numpy, case["params"])
        specs = mesh_mod.sanitize_specs(split_tree(A.init_attention(
            None, cfg, device=META))[1], whole_p, mesh)
        loc = mesh_mod.map_specs(lambda s, v: mesh_mod.local_shard(
            v, s, mesh).requires_grad_(), specs, whole_p)
        x = torch.from_numpy(case["x"]).requires_grad_()
        with mesh_mod.use_mesh(mesh):
            scheme = A.attn_scheme(cfg, x.shape[1])
            if case.get("kv_chunk"):
                y = A.flash_attention(loc, x, cfg, kv_chunk=case["kv_chunk"])
            else:
                y = A.attention(loc, x, cfg)
            (y * torch.from_numpy(case["cot"])).sum().backward()
        out[name] = {"y": y.detach().numpy().copy(), "scheme": scheme,
                     "dx": x.grad.numpy().copy(),
                     "grads": mesh_mod.map_specs(
                         lambda s, v: mesh_mod.gather_full(
                             v.grad, s, mesh).numpy().copy(), specs, loc)}
    return out


def job_lm_loss(mesh, inp, key: str, aux_weight: float | None = None):
    """``lm_loss`` of ``inp[key]``'s LM and batch on the mesh, the leaves
    stored under the training plan, through the train step's
    ``lm_grads`` and ``DataParallel``: the loss, its metrics and every
    gradient leaf gathered whole (an MoE's relaid back to one model
    shard). ``aux_weight`` (a (1, M) mesh only) overrides the MoE aux
    loss's weight, calling ``lm_loss`` itself."""
    import functools
    from repro_torch.core.spikingformer import value_and_grad
    from repro_torch.models.lm import lm_loss
    cfg, params = mesh_params(inp, key, mesh)
    specs = lm_specs(cfg, mesh, FSDP_MIN)[1]
    loc = shard(params, specs, mesh)
    batch = place_batch(inp[key]["batch"], mesh)
    if aux_weight is None:      # the train step's: through DataParallel
        loss, metrics, grads = lm_grads(cfg, loc, batch,
                                        dp=DataParallel(cfg, mesh, specs))
    else:
        with mesh_mod.use_mesh(mesh):
            (loss, metrics), grads = value_and_grad(
                functools.partial(lm_loss, aux_weight=aux_weight), loc,
                batch, cfg)
    g = whole(grads, specs, mesh)
    if cfg.moe is not None and cfg.moe.model_shards > 1:
        g = relay_experts(g, cfg.moe.model_shards, 1, cfg.moe.num_experts)
    return {"loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": g}


def job_decode_key(mesh, inp, key: str):
    """``inp[key]["steps"]`` decode steps of two slots of ``inp[key]``'s
    LM from a zero cache of ``max_seq`` positions laid out as
    ``cache_structs`` lays it out for the mesh's model axis (the rank's kv
    heads, positions or columns): every step's logits, the local cache's
    shape and the cache gathered whole."""
    from repro_torch.launch.specs import bind_model_axis
    from repro_torch.models.attention import decode_mode
    from repro_torch.models.lm import init_cache, lm_decode_step
    case = inp[key]
    cfg, params = mesh_params(inp, key, mesh)
    params = shard(params, serving_specs(cfg, mesh), mesh)
    cache = init_cache(cfg, 2, case["max_seq"], torch.float32, "cpu")
    c_specs = mesh_mod.sanitize_specs(
        cache_structs(bind_model_axis(cfg, mesh), 2, case["max_seq"],
                      ("data",), model=mesh.shape["model"],
                      lif_replicated=True)[1], cache, mesh)
    cache = shard(cache, c_specs, mesh)
    k0 = cache["kv"]["k"] if cfg.lif is not None else cache["k"]
    logits = []
    with mesh_mod.use_mesh(mesh), torch.no_grad():
        mode = decode_mode(cfg.attn, k0[0])
        for i, tok in enumerate(case["tokens"]):
            out, cache = lm_decode_step(
                params, cache, torch.from_numpy(tok),
                torch.full((2,), i, dtype=torch.int32), cfg)
            logits.append(out.numpy().copy())
    return {"logits": logits, "mode": mode, "local_k": tuple(k0.shape),
            "cache": whole(cache, c_specs, mesh)}


def job_moe_layer(mesh, inp):
    """``moe_apply`` of ``inp["moe_layer"]`` (capacity factor 1.25, its
    experts relaid to the mesh's model axis) on the mesh: y and aux."""
    from repro_torch.models.moe import MoEConfig, moe_apply
    case = inp["moe_layer"]
    m = mesh.shape["model"]
    cfg = MoEConfig(**{**case["cfg"], "model_shards": m})
    flat = relay_experts({f"ffn/{k}": v[None] for k, v in
                          case["params"].items()}, 1, m, cfg.num_experts)
    full = {k.split("/")[1]: torch.from_numpy(v[0]) for k, v in flat.items()}
    spec = mesh_mod.P("model", None, None, None)
    loc = {k: (mesh_mod.local_shard(v, spec, mesh) if v.ndim == 4 else v)
           for k, v in full.items()}
    with mesh_mod.use_mesh(mesh), torch.no_grad():
        y, aux = moe_apply(loc, torch.from_numpy(case["x"]), cfg)
    return {"y": y.numpy().copy(), "aux": float(aux)}


def job_moe_adamw(mesh, inp, key: str):
    """Two donated train steps of ``inp[key]``'s LM on ``inp[key]
    ["batches"]`` through ``make_train_step(mesh=)``: the losses and the
    parameters whole (an MoE's relaid back to one model shard)."""
    cfg, params = mesh_params(inp, key, mesh)
    specs = lm_specs(cfg, mesh, FSDP_MIN)[1]
    shards = shard(params, specs, mesh)
    opt = init_opt_state(shards)
    step = make_train_step(cfg, inp["opt_cfg"], mesh=mesh, specs=specs,
                           donate=True)
    losses = []
    for batch in inp[key]["batches"]:
        shards, opt, m = step(shards, opt, place_batch(batch, mesh))
        losses.append(float(m["loss"]))
    out = whole(shards, specs, mesh)
    if cfg.moe is not None and cfg.moe.model_shards > 1:
        out = relay_experts(out, cfg.moe.model_shards, 1,
                            cfg.moe.num_experts)
    return {"losses": losses, "params": out}


def job_pod_adamw(inp):
    """Two donated train steps of ``inp["pod"]``'s LM on a (pod 2, data 2,
    model 1) mesh over the world of 4, whose plan splits the large leaves
    over "data" alone (replicated over "pod", the reference's plan): the
    losses, the parameters whole and which leaves are split over "data"
    only."""
    m = mesh_mod.Mesh((2, 2, 1), ("pod", "data", "model"),
                      torch.device("cpu"))
    out = job_moe_adamw(m, inp, "pod")
    specs = lm_specs(inp["pod"]["cfg"], m, FSDP_MIN)[1]
    params = lm_from_jax(inp["pod"]["params"], device="cpu")
    out["data_only"] = [p for p, s in zip(tree_paths(params),
                                          mesh_mod.spec_list(specs, params))
                        if mesh_mod.batch_groups(s, m)[2] is not None]
    return out


def job_moe_ckpt(mesh, inp, out, write: bool):
    """``write``: the MoE LM's parameters, stored under the mesh's plan,
    checkpointed whole (at the mesh's model axis); else restored from
    that checkpoint onto this mesh (``moe_experts``: relaid). Either way
    the cross entropy of ``inp["mix"]``'s batch on the mesh and the
    leaves whole, relaid to one model shard."""
    from repro_torch.models.lm import lm_loss
    cfg, params = mesh_params(inp, "mix", mesh)
    specs = lm_specs(cfg, mesh, FSDP_MIN)[1]
    loc = shard(params, specs, mesh)
    d = os.path.join(out, "moe_ckpt")
    if write:
        ckpt.save_checkpoint(d, 3, loc, specs, mesh=mesh)
    else:
        like = mesh_mod.map_specs(lambda s, x: torch.zeros_like(x), specs,
                                  loc)
        loc = ckpt.restore_checkpoint(d, 3, like, mesh, specs,
                                      moe_experts=cfg.moe.num_experts)
    batch = place_batch(inp["mix"]["batch"], mesh)
    with mesh_mod.use_mesh(mesh), torch.no_grad():
        _, metrics = lm_loss(loc, batch, cfg)
    return {"loss": float(metrics["loss"]), "model": mesh.shape["model"],
            "params": relay_experts(whole(loc, specs, mesh),
                                    cfg.moe.model_shards, 1,
                                    cfg.moe.num_experts)}


# ---------------------------------------------------------------------------
# The rest of the model axis: MLA, the rwkv and hybrid heads, the
# encoder-decoder
# ---------------------------------------------------------------------------

def local_shapes(tree) -> dict:
    """Every leaf's shape on this rank, by path."""
    return {p: tuple(x.shape) for p, x in zip(tree_paths(tree),
                                              tree_leaves(tree))}


def job_family_decode(mesh, inp, key: str):
    """:func:`job_decode_key` for any LM family (MLA's latent, the
    recurrent states): every step's logits, the cache gathered whole and
    each cache leaf's shape on this rank."""
    from repro_torch.launch.specs import bind_model_axis
    from repro_torch.models.lm import init_cache, lm_decode_step
    case = inp[key]
    cfg, params = mesh_params(inp, key, mesh)
    params = shard(params, serving_specs(cfg, mesh), mesh)
    cache = init_cache(cfg, 2, case["max_seq"], torch.float32, "cpu")
    c_specs = mesh_mod.sanitize_specs(
        cache_structs(bind_model_axis(cfg, mesh), 2, case["max_seq"],
                      ("data",), model=mesh.shape["model"],
                      lif_replicated=True)[1], cache, mesh)
    cache = shard(cache, c_specs, mesh)
    shapes = local_shapes(cache)
    logits = []
    with mesh_mod.use_mesh(mesh), torch.no_grad():
        for i, tok in enumerate(case["tokens"]):
            out, cache = lm_decode_step(
                params, cache, torch.from_numpy(tok),
                torch.full((2,), i, dtype=torch.int32), cfg)
            logits.append(out.numpy().copy())
    return {"logits": logits, "local": shapes,
            "cache": whole(cache, c_specs, mesh)}


def job_encdec_decode(mesh, inp, key: str):
    """``init_encdec_cache`` of ``inp[key]``'s encoder-decoder on the mesh
    (the rank's parts of the self cache and the cross memory), then its
    decode steps: every step's logits, the cache gathered whole and each
    leaf's shape on this rank."""
    from repro_torch.models.encdec import encdec_decode_step, \
        init_encdec_cache
    case = inp[key]
    cfg = case["cfg"]
    params = shard(lm_from_jax(case["params"], device="cpu"),
                   serving_specs(cfg, mesh), mesh)
    c_specs = cache_structs(cfg, 2, case["max_seq"], None,
                            model=mesh.shape["model"])[1]
    logits = []
    with mesh_mod.use_mesh(mesh), torch.no_grad():
        cache = init_encdec_cache(params, torch.from_numpy(case["frames"]),
                                  cfg, 2, case["max_seq"], torch.float32)
        shapes = local_shapes(cache)
        for i, tok in enumerate(case["tokens"]):
            out, cache = encdec_decode_step(
                params, cache, torch.from_numpy(tok),
                torch.full((2,), i, dtype=torch.int32), cfg)
            logits.append(out.numpy().copy())
    return {"logits": logits, "local": shapes,
            "cache": whole(cache, c_specs, mesh)}


def job_family_ckpt(mesh, inp, out, key: str, write: bool):
    """``write``: ``inp[key]``'s LM, stored under the mesh's training
    plan, checkpointed whole; else restored from that checkpoint onto
    this mesh's plan. Either way the cross entropy of its batch on the
    mesh and the leaves whole."""
    from repro_torch.models.lm import lm_loss
    cfg, params = mesh_params(inp, key, mesh)
    specs = lm_specs(cfg, mesh, FSDP_MIN)[1]
    loc = shard(params, specs, mesh)
    d = os.path.join(out, f"{key}_ckpt")
    if write:
        ckpt.save_checkpoint(d, 3, loc, specs, mesh=mesh)
    else:
        like = mesh_mod.map_specs(lambda s, x: torch.zeros_like(x), specs,
                                  loc)
        loc = ckpt.restore_checkpoint(d, 3, like, mesh, specs)
    batch = place_batch(inp[key]["batch"], mesh)
    with mesh_mod.use_mesh(mesh), torch.no_grad():
        _, metrics = lm_loss(loc, batch, cfg)
    return {"loss": float(metrics["loss"]), "model": mesh.shape["model"],
            "params": whole(loc, specs, mesh)}


FAMILY_JOBS = {
    **{f"loss_{k}": (lambda k: lambda mesh, inp, out: job_lm_loss(
        mesh, inp, k))(k)
       for k in ("rwkv", "hyb", "wh4", "wh6", "wh6n", "wh514")},
    # MLA's LM is an MoE: its aux loss is weighted out (on a model axis it
    # is the mean of the ranks' own, the reference's mesh semantics)
    **{f"loss_{k}": (lambda k: lambda mesh, inp, out: job_lm_loss(
        mesh, inp, k, 0.0))(k) for k in ("mla", "mla_seq", "mla_none")},
    **{f"decode_{k}": (lambda k: lambda mesh, inp, out: job_family_decode(
        mesh, inp, k))(k) for k in ("mla_d16", "mla_d18", "mla_d16_h6",
                                    "rwkv_d", "rwkv_h_d", "hyb_d",
                                    "hyb_ds_d", "hyb_h_d")},
    **{f"encdec_decode_{k}": (lambda k: lambda mesh, inp, out:
                              job_encdec_decode(mesh, inp, k))(k)
       for k in ("whd4", "whd6_32", "whd6_30")},
    "adamw_hyb": lambda mesh, inp, out: job_moe_adamw(mesh, inp, "hyb"),
    "ckpt_write_hyb": lambda mesh, inp, out: job_family_ckpt(
        mesh, inp, out, "hyb", True),
    "ckpt_restore_hyb": lambda mesh, inp, out: job_family_ckpt(
        mesh, inp, out, "hyb", False),
}


JOBS = {
    "attn_layer": lambda mesh, inp, out: job_attn_layer(mesh, inp),
    "lm_seq6": lambda mesh, inp, out: job_lm_loss(mesh, inp, "seq6"),
    "lm_seq3": lambda mesh, inp, out: job_lm_loss(mesh, inp, "seq3"),
    "lm_none3": lambda mesh, inp, out: job_lm_loss(mesh, inp, "none3"),
    "lm_vlm": lambda mesh, inp, out: job_lm_loss(mesh, inp, "vlm"),
    "decode_seq": lambda mesh, inp, out: job_decode_key(mesh, inp, "dseq"),
    "decode_window": lambda mesh, inp, out: job_decode_key(mesh, inp,
                                                           "dwin"),
    "decode_head_dim": lambda mesh, inp, out: job_decode_key(mesh, inp,
                                                             "dhd"),
    "moe_loss": lambda mesh, inp, out: job_lm_loss(mesh, inp, "mix"),
    "moe_loss_no_aux": lambda mesh, inp, out: job_lm_loss(mesh, inp, "mix",
                                                          0.0),
    "moe2_loss": lambda mesh, inp, out: job_lm_loss(mesh, inp, "mix2"),
    "moe2_loss_no_aux": lambda mesh, inp, out: job_lm_loss(mesh, inp,
                                                           "mix2", 0.0),
    "moe_layer": lambda mesh, inp, out: job_moe_layer(mesh, inp),
    "moe_decode": lambda mesh, inp, out: job_decode_key(mesh, inp, "mixd"),
    "moe_adamw": lambda mesh, inp, out: job_moe_adamw(mesh, inp, "mix"),
    "pod_adamw": lambda mesh, inp, out: job_pod_adamw(inp),
    "moe_ckpt_write": lambda mesh, inp, out: job_moe_ckpt(mesh, inp, out,
                                                          True),
    "moe_ckpt_restore": lambda mesh, inp, out: job_moe_ckpt(mesh, inp, out,
                                                            False),
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
    "decode": lambda mesh, inp, out: job_decode_key(
        mesh, {"lm": decode_case(inp)}, "lm"),
    "adamw": lambda mesh, inp, out: job_adamw(mesh, inp),
    "ckpt_write": job_ckpt_write,
    "ckpt_restore": job_ckpt_restore,
    "one_by_one": lambda mesh, inp, out: job_one_by_one(mesh, inp),
    "moe_shards": lambda mesh, inp, out: job_moe_shards(mesh, inp),
    **FAMILY_JOBS,
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
