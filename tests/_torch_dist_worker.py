"""The ranks of ``tests/test_torch_dist.py``: one process per rank on the
CPU, gloo over a file store, no JAX. ``run`` executes the named jobs in
order on every rank; rank 0 pickles each job's result (numpy trees, or the
traceback of a job that raised) to ``<out>/<job>.pkl``. A job whose
collectives hang is cut by the parent's join timeout."""
from __future__ import annotations

import os
import pickle
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import get_spikingformer_config
from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import from_jax, lm_from_jax
from repro_torch.core.policy import named_policy
from repro_torch.core.spikingformer import tree_leaves, tree_paths
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.specs import lm_specs, spikingformer_structs
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import place_batch
from repro_torch.train.loop import (DataParallel, lm_grads, make_train_step,
                                    vision_grads)
from repro_torch.train.optimizer import OptimizerConfig

#: FSDP threshold of the tests: small enough that the smoke models shard
#: leaves over "data" (the default, 2^20 elements, shards none of them).
FSDP_MIN = 1024


def lm_cfg():
    return reduced(get_config("qwen3-0.6b"))


def vision_cfg(policy: str):
    return get_spikingformer_config("spikingformer-smoke",
                                    policy=named_policy(policy))


def _full(tree, specs, mesh):
    """Every leaf of a tree of shards gathered whole, as numpy, by path."""
    return {p: mesh_mod.gather_leaf(x, s, mesh).numpy().copy()
            for p, x, s in zip(tree_paths(tree), tree_leaves(tree),
                               mesh_mod.spec_list(specs, tree))}


def _shard(tree, specs, mesh):
    return mesh_mod.map_specs(
        lambda s, x: mesh_mod.local_shard(x, s, mesh), specs, tree)


def job_lm_grads(mesh, inp):
    cfg = lm_cfg()
    params = lm_from_jax(inp["lm_params"], device="cpu")
    specs = lm_specs(cfg, mesh, FSDP_MIN)[1]
    dp = DataParallel(cfg, mesh, specs)
    batch = place_batch(inp["lm_batch"], mesh)
    loss, _, grads = lm_grads(cfg, _shard(params, specs, mesh), batch,
                              dp=dp)
    n_sharded = sum(mesh_mod.batch_dim(s, mesh) is not None
                    for s in dp.spec_list(params))
    return {"loss": float(loss), "grads": _full(grads, specs, mesh),
            "rows": int(batch["tokens"].shape[0]), "n_sharded": n_sharded}


def job_vision_grads(mesh, inp, policy):
    cfg = vision_cfg(policy)
    params, state = from_jax(inp["sf_params"], inp["sf_state"],
                             device="cpu")
    specs = spikingformer_structs(cfg, mesh, FSDP_MIN)[1][0]
    dp = DataParallel(cfg, mesh, specs)
    b = place_batch({"images": inp["images"], "labels": inp["labels"]},
                    mesh)
    grads, new_state, metrics = vision_grads(
        cfg, _shard(params, specs, mesh), state, b["images"], b["labels"],
        dp)
    from repro_torch.core.spikingformer import spikingformer_apply
    taps = []
    with mesh_mod.use_mesh(mesh), torch.no_grad():
        spikingformer_apply(params, state, b["images"], cfg, train=True,
                            taps=taps)
    return {"loss": float(metrics["loss"]),
            "taps": [t.numpy().copy() for t in taps],
            "accuracy": float(metrics["accuracy"]),
            "grads": _full(grads, specs, mesh),
            "state": {p: x.numpy().copy() for p, x in
                      zip(tree_paths(new_state), tree_leaves(new_state))}}


def job_build_state(mesh, inp):
    from repro_torch.launch.train import build_spikingformer_state
    cfg = vision_cfg("eager")
    params, state, opt, (p_specs, _) = build_spikingformer_state(
        cfg, mesh, OptimizerConfig(), fsdp_min_elems=FSDP_MIN,
        device="cpu")
    full, *_ = build_spikingformer_state(cfg, None, OptimizerConfig(),
                                         device="cpu")
    specs = mesh_mod.spec_list(p_specs, params)
    return {"paths": tree_paths(params),
            "specs": [None if s is None else tuple(s) for s in specs],
            "shapes": [tuple(x.shape) for x in tree_leaves(params)],
            "m_shapes": [tuple(x.shape) for x in tree_leaves(opt["m"])],
            "v_shapes": [tuple(x.shape) for x in tree_leaves(opt["v"])],
            "full_shapes": [tuple(x.shape) for x in tree_leaves(full)],
            "slices_equal": all(torch.equal(
                mesh_mod.local_shard(f, s, mesh), x) for f, s, x in zip(
                tree_leaves(full), specs, tree_leaves(params)))}


def job_train_vision(mesh, inp, out):
    from repro_torch.launch.train import train_vision
    cfg = vision_cfg("eager")
    d = os.path.join(out, "train_vision_ckpt")
    _, hist = train_vision(cfg, steps=3, global_batch=4, ckpt_dir=d,
                           mesh=mesh, ckpt_every=2, log_every=10)
    latest = ckpt.latest_step(d)
    _, hist2 = train_vision(cfg, steps=4, global_batch=4, ckpt_dir=d,
                            mesh=mesh, ckpt_every=10, log_every=10)
    return {"hist": hist, "latest": latest, "hist2": hist2}


def job_adamw_steps(mesh, inp):
    cfg = lm_cfg()
    params = lm_from_jax(inp["lm_params"], device="cpu")
    specs = lm_specs(cfg, mesh, FSDP_MIN)[1]
    from repro_torch.train.optimizer import init_opt_state
    shards = _shard(params, specs, mesh)
    opt = init_opt_state(shards)
    step = make_train_step(cfg, inp["opt_cfg"], mesh=mesh, specs=specs,
                           donate=True)
    losses = []
    for batch in inp["lm_batches"]:
        shards, opt, m = step(shards, opt, place_batch(batch, mesh))
        losses.append(float(m["loss"]))
    return {"params": _full(shards, specs, mesh),
            "m": _full(opt["m"], specs, mesh), "losses": losses}


def _vision_tree(mesh):
    from repro_torch.launch.train import build_spikingformer_state
    from repro_torch.train.optimizer import init_opt_specs
    params, state, opt, (p_specs, s_specs) = build_spikingformer_state(
        vision_cfg("eager"), mesh, OptimizerConfig(),
        fsdp_min_elems=FSDP_MIN, device="cpu")
    return ({"params": params, "state": state, "opt": opt},
            {"params": p_specs, "state": s_specs,
             "opt": init_opt_specs(p_specs)})


def writer_specs():
    """The specs of the data = 4 writer, from its abstract mesh."""
    from repro_torch.train.optimizer import init_opt_specs
    _, (p_specs, s_specs) = spikingformer_structs(
        vision_cfg("eager"), mesh_mod.AbstractMesh(("data", "model"),
                                                   (4, 1)), FSDP_MIN)
    return {"params": p_specs, "state": s_specs,
            "opt": init_opt_specs(p_specs)}


def job_ckpt_write(mesh, inp, out):
    tree, specs = _vision_tree(mesh)
    ckpt.save_checkpoint(os.path.join(out, "elastic"), 7, tree, specs,
                         mesh=mesh)
    return {"world": mesh.size}


def job_ckpt_restore(mesh, inp, out):
    """Restores the data = 4 checkpoint with the writer's specs (those of
    a data = 4 build, re-resolved here) and without (from the index); the
    leaves, gathered whole, against a mesh-less build from the seed."""
    d = os.path.join(out, "elastic")
    like, _ = _vision_tree(mesh)
    written = writer_specs()
    result = {}
    for name, specs in (("with_specs", written), ("from_index", None)):
        got = ckpt.restore_checkpoint(d, 7, like, mesh, specs)
        index_specs = ckpt._spec_map(written)
        full = {}
        for path, leaf in ckpt._flatten_with_paths(got):
            spec = mesh_mod.resolve_spec(
                ckpt._as_spec(index_specs.get(path)), mesh)
            full[path] = mesh_mod.gather_leaf(leaf, spec, mesh).numpy().copy()
        result[name] = full
    return result


JOBS = {
    "lm_grads": lambda mesh, inp, out: job_lm_grads(mesh, inp),
    "vision_eager": lambda mesh, inp, out: job_vision_grads(mesh, inp,
                                                            "eager"),
    "vision_cuda_full": lambda mesh, inp, out: job_vision_grads(
        mesh, inp, "cuda-full"),
    "build_state": lambda mesh, inp, out: job_build_state(mesh, inp),
    "train_vision": lambda mesh, inp, out: job_train_vision(mesh, inp, out),
    "adamw_steps": lambda mesh, inp, out: job_adamw_steps(mesh, inp),
    "ckpt_write": job_ckpt_write,
    "ckpt_restore": job_ckpt_restore,
}


def run(rank: int, world: int, store: str, out: str, jobs: list[str],
        inputs: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        with open(inputs, "rb") as f:
            inp = pickle.load(f)
        mesh = mesh_mod.make_test_mesh(world, 1, device="cpu")
        for job in jobs:
            try:
                result = JOBS[job](mesh, inp, out)
            except Exception:   # recorded for the test that reads the job
                result = {"error": traceback.format_exc()}
            if rank == 0:
                with open(os.path.join(out, f"{job}_w{world}.pkl"),
                          "wb") as f:
                    pickle.dump(result, f)
            dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(world: int, out: str, jobs: list[str], inputs: str,
          timeout: float = 240.0) -> None:
    """Runs ``jobs`` on ``world`` spawned ranks; raises when a rank fails
    or outlives ``timeout``."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(out, f"store_w{world}")
    procs = [ctx.Process(target=run, args=(r, world, store, out, jobs,
                                           inputs)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    if alive or any(codes):
        raise RuntimeError(f"ranks of world {world}: exit codes {codes}"
                           f"{' (timed out)' if alive else ''}")


def result(out: str, job: str, world: int) -> dict:
    with open(os.path.join(out, f"{job}_w{world}.pkl"), "rb") as f:
        res = pickle.load(f)
    if "error" in res:
        raise AssertionError(f"{job} at world {world} raised:\n"
                             f"{res['error']}")
    return res
