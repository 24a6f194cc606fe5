#!/usr/bin/env python3
"""Data-parallel Spikingformer training over N ranks, one per GPU.

    torchrun --nproc_per_node=4 benchmarks/torch/bench_data_parallel.py \\
        [--preset spikingformer-8-512] [--per-rank 16] [--steps 2] [--seed 0]
    torchrun --nproc_per_node=4 benchmarks/torch/bench_data_parallel.py \\
        --device cpu --preset spikingformer-smoke --per-rank 2   # gloo

Every rank joins the world (``launch.mesh.init_distributed``: NCCL on the
cards, gloo with ``--device cpu``) and a (world, 1) mesh, then:

* ``bn_stats``: the BN kernels' split path at the preset's block shape
  (each rank's rows of a global batch drawn from the seed on every rank;
  its column sums all-reduced) against the fused path on the whole global
  batch, which every rank runs too: mu and var relative to their scale,
  y's and dx's largest error on the rank's rows; the same for
  ``neuron_layer_train`` at ``pssa.qkv`` (spike mismatch fraction); each
  call's time on its rank, split and fused, at the rank's shape.
* ``step``: the train step alone (``make_train_step(mesh=)``) on batches
  drawn and placed before the clock starts, one warm-up and ``--steps``
  timed steps (host clock around synchronised steps); then rank 0 alone
  the mesh-less step at the same global batch, the others waiting at a
  barrier; and the host time of one ``SyntheticVision.batch`` draw at the
  global batch, which every rank makes in the driver.
* ``train``: ``launch.train.train_vision`` on the mesh, ``--per-rank``
  images a rank, one warm-up and ``--steps`` timed steps (host clock
  between the driver's ``on_step`` calls, each once the loss is on the
  host); then rank 0 alone runs the mesh-less driver from the same seed
  at the same global batch, the others waiting at a barrier: losses of
  both, ms per step and images/s of both.

With ``--model M[,M...]`` the mesh is (world / M, M) for each M given,
tensor parallel over "model", and the parts are instead:

* ``tp_grads`` (one line per M): one BPTT step of the preset at the global
  batch ``--global-batch`` on exact weights (every block weight a multiple
  of 1/64 in [-1/4, 1/4], drawn from the seed), each rank on its rows and
  its slices, against the mesh-less step that rank 0 runs on the whole
  batch: the loss, every gradient leaf gathered whole (its largest error
  over max(1, its scale)), the BN state, and the spikes of the tokenizer
  and of every block on rank 0's rows (the fraction that differ); then
  the train step (``make_train_step(mesh=)``) one warm-up and ``--steps``
  timed steps (host clock around synchronised steps) and its peak memory
  on each card (the largest over the ranks), beside rank 0's mesh-less
  step at the same global batch.
* ``lm_grads`` (``--lm-arch ARCH``, on the first M): the LM cut to
  ``LM_CHECK_LAYERS`` layers, with the LIF and without it, at each of
  ``QK_SCALES`` (``wq`` and ``wk`` scaled): the step-0
  loss, the gradient norm and every gradient leaf (gathered whole)
  against rank 0's mesh-less gradient, and the branch spikes of rank 0's
  rows that differ from the mesh-less ones. Beside it, rank 0's
  mesh-less gradient again with the terms of every row-parallel sum
  (``wo``'s heads, ``w_down``'s hidden features) in reverse order
  (:func:`reverse_sums`: the same function, other roundings), against
  the first: how far the order of those sums alone moves the loss, the
  gradients and the spikes on one card.
* ``lm`` (``--lm-arch ARCH``, on the first M, where the dry run's
  estimate of a rank's peak fits the card, or on the CPU the host's
  memory with every rank's): the LM with the LIF on every FFN branch, fp32,
  each layer recomputed, ``--lm-batch`` x ``--lm-seq`` tokens, 1 +
  ``--steps`` steps through ``launch.train.train`` on the mesh: every
  step's metrics, whether every parameter leaf moved, the ms per timed
  step, and the peak memory on each card over the timed steps (above
  what was allocated before the driver started) against the dry run's
  estimate of the same step on the same mesh (counted on ``meta``
  tensors under a fake process group before the real one starts).

Rank 0 prints one JSON line per part, with the cards' names and power
limits, and with ``--out FILE`` writes them there too.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_spikingformer_config  # noqa: E402
from repro_torch.kernels import fused_bn, neuron_layer  # noqa: E402
from repro_torch.launch.mesh import (init_distributed,  # noqa: E402
                                     make_test_mesh, shutdown_distributed)
from repro_torch.launch.train import train_vision  # noqa: E402


def call_ms(fn, device, iters: int = 20) -> float:
    """Mean time of ``fn`` over ``iters`` calls after a warm-up: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def bn_stats(cfg, mesh, rank, world, per_rank, seed) -> dict:
    dev, group = mesh.device, mesh.batch_group
    rows = cfg.time_steps * per_rank * cfg.num_tokens
    d = cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((world * rows, d), generator=gen, device=dev) * 2 + 0.5
    g = torch.randn((world * rows, d), generator=gen, device=dev)
    gamma = torch.rand((d,), generator=gen, device=dev) + 0.5
    beta = torch.randn((d,), generator=gen, device=dev) * 0.3
    mine = slice(rank * rows, (rank + 1) * rows)
    y, mu, sd = fused_bn.bn_fwd(x[mine], gamma, beta, group=group)
    dx, _, _ = fused_bn.bn_bwd(g[mine], x[mine], gamma, mu, sd, group)
    yw, muw, sdw = fused_bn.bn_fwd(x, gamma, beta)
    dxw, _, _ = fused_bn.bn_bwd(g, x, gamma, muw, sdw)
    t, m = cfg.time_steps, per_rank * cfg.num_tokens
    s = (torch.rand((t, world * m, d), generator=gen, device=dev)
         < 0.2).float()
    w = torch.randn((d, d), generator=gen, device=dev) * 2 * d ** -0.5
    cols = slice(rank * m, (rank + 1) * m)
    xs = s[:, cols].contiguous()
    sp, nmu, nvar = neuron_layer.neuron_layer_train(xs, w, gamma, beta,
                                                    packed=True, group=group)
    spw, nmuw, nvarw = neuron_layer.neuron_layer_train(s, w, gamma, beta,
                                                       packed=True)
    out = {"rows_per_rank": rows, "d": d,
           "bn_mu": rel(mu, muw), "bn_var": rel(sd * sd, sdw * sdw),
           "bn_y_max_abs_err": float((y - yw[mine]).abs().max()),
           "bn_dx_rel_err": rel(dx, dxw[mine]),
           "nl_mu": rel(nmu, nmuw), "nl_var": rel(nvar, nvarw),
           "nl_spike_mismatch": float((sp != spw[:, cols]).float().mean()),
           "bn_fwd_ms": call_ms(lambda: fused_bn.bn_fwd(x[mine], gamma,
                                                        beta), dev),
           "bn_fwd_split_ms": call_ms(lambda: fused_bn.bn_fwd(
               x[mine], gamma, beta, group=group), dev),
           "bn_bwd_ms": call_ms(lambda: fused_bn.bn_bwd(
               g[mine], x[mine], gamma, mu, sd), dev),
           "bn_bwd_split_ms": call_ms(lambda: fused_bn.bn_bwd(
               g[mine], x[mine], gamma, mu, sd, group), dev),
           "nl_ms": call_ms(lambda: neuron_layer.neuron_layer_train(
               xs, w, gamma, beta, packed=True), dev),
           "nl_split_ms": call_ms(lambda: neuron_layer.neuron_layer_train(
               xs, w, gamma, beta, packed=True, group=group), dev)}
    return out


def run_steps(cfg, mesh, global_batch, steps, seed, device) -> dict:
    """``1 + steps`` steps of ``make_train_step`` on pre-placed batches."""
    from repro_torch.launch.train import build_spikingformer_state
    from repro_torch.train.data import (SyntheticVision, VisionDataConfig,
                                        place_batch)
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptimizerConfig
    opt_cfg = OptimizerConfig(lr=2e-3, total_steps=1 + steps,
                              weight_decay=0.01, warmup_steps=5)
    params, state, opt, (p_specs, _) = build_spikingformer_state(
        cfg, mesh, opt_cfg, seed, device=device)
    step = make_train_step(cfg, opt_cfg, mesh=mesh,
                           specs=p_specs if mesh is not None else None)
    data = SyntheticVision(VisionDataConfig(
        image_size=cfg.image_size, num_classes=cfg.num_classes,
        global_batch=global_batch, channels=cfg.in_channels, seed=seed))
    t0 = time.perf_counter()
    drawn = data.batch(0)
    draw_ms = (time.perf_counter() - t0) * 1e3
    batches = [place_batch(data.batch(i) if i else drawn, mesh, device)
               for i in range(1 + steps)]
    ms = []
    for b in batches:
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, opt, m = step(params, state, opt, b["images"],
                                     b["labels"])
        float(m["loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"ms_per_step": ms[1:], "draw_ms": draw_ms,
            "images_per_s": global_batch / (sorted(ms[1:])[
                len(ms[1:]) // 2] / 1e3)}


def run_train(cfg, mesh, global_batch, steps, seed, device) -> dict:
    stamps = []
    with contextlib.redirect_stdout(sys.stderr):
        _, history = train_vision(
            cfg, steps=1 + steps, global_batch=global_batch, ckpt_dir=None,
            mesh=mesh, seed=seed, device=device,
            on_step=lambda step, m: stamps.append(time.perf_counter()))
    ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    return {"losses": history, "ms_per_step": ms,
            "images_per_s": global_batch / (sorted(ms)[len(ms) // 2] / 1e3)}


def exact_blocks(params, seed: int, span: int = 16):
    """Every weight matrix of the blocks in place as multiples of 1/64 in
    [-span/64, span/64], drawn on the CPU from ``seed``: the products of
    spikes with them are exact in fp32 in any order. The kernels' BN
    statistics add fp32 partial sums of chunks of rows, which a split of
    the batch over ranks cuts otherwise: those sums are exact, and the
    statistics of a split batch the whole batch's bit for bit, only where
    every partial sum of z^2 (multiples of 1/4096) stays below 4096, which
    ``span`` = 4 keeps and 16 (the CPU tests' weights) does not."""
    gen = torch.Generator().manual_seed(seed)

    def walk(tree):
        for k, v in tree.items():
            if k == "w":
                tree[k] = (torch.randint(-span, span + 1, v.shape,
                                         generator=gen)
                           / 64).to(v.device, v.dtype)
            elif isinstance(v, dict):
                walk(v)
    walk(params["blocks"])
    return params


def tp_grads(cfg, mesh, rank, global_batch, steps, seed, device,
             span: int = 16) -> dict:
    """The ``tp_grads`` part on ``mesh`` (see the module docstring), on
    block weights of ``exact_blocks(..., span)``."""
    from repro_torch.core.spikingformer import (init_spikingformer,
                                                spikingformer_apply,
                                                spikingformer_grad_step,
                                                tree_leaves, tree_paths)
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.specs import spikingformer_structs
    from repro_torch.train.data import (SyntheticVision, VisionDataConfig,
                                        place_batch)
    from repro_torch.train.loop import (DataParallel, make_train_step,
                                        vision_grads)
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

    def shard(tree, specs):
        return mesh_mod.map_specs(lambda s, x: mesh_mod.local_shard(
            x, s, mesh), specs, tree)
    params, state = init_spikingformer(torch.Generator().manual_seed(seed),
                                       cfg, device)
    params = exact_blocks(params, seed + 1, span)
    p_specs, s_specs = spikingformer_structs(cfg, mesh)[1]
    host = SyntheticVision(VisionDataConfig(
        image_size=cfg.image_size, num_classes=cfg.num_classes,
        global_batch=global_batch, channels=cfg.in_channels,
        seed=seed)).batch(0)
    b = place_batch(host, mesh, device)
    p_loc, s_loc = shard(params, p_specs), shard(state, s_specs)
    dp = DataParallel(cfg, mesh, p_specs)
    grads, new_state, metrics = vision_grads(cfg, p_loc, s_loc, b["images"],
                                             b["labels"], dp)
    taps = []
    with mesh_mod.use_mesh(mesh), torch.no_grad():
        spikingformer_apply(dp.gather(p_loc), s_loc, b["images"], cfg,
                            train=True, taps=taps)
    whole = [mesh_mod.gather_full(g, s, mesh) for g, s in zip(
        tree_leaves(grads), mesh_mod.spec_list(p_specs, grads))]
    whole_state = [mesh_mod.gather_full(x, s, mesh) for x, s in zip(
        tree_leaves(new_state), mesh_mod.spec_list(s_specs, new_state))]
    del grads, new_state
    out = {"mesh": dict(mesh.shape), "weights": f"k/64, |k| <= {span}",
           "global_batch": global_batch,
           "rows_per_rank": int(b["images"].shape[0]),
           "loss": float(metrics["loss"])}
    dist.barrier()
    if rank == 0:
        full = place_batch(host, None, device)
        g1, st1, m1 = spikingformer_grad_step(params, state, full["images"],
                                              full["labels"], cfg)
        taps1 = []
        with torch.no_grad():
            spikingformer_apply(params, state, full["images"], cfg,
                                train=True, taps=taps1)
        rows = taps[0].shape[1]
        out.update(
            one_card_loss=float(m1["loss"]),
            loss_abs_err=abs(out["loss"] - float(m1["loss"])),
            grad_max_err=max(
                float((a - w).abs().max() / max(1.0, float(w.abs().max())))
                for a, w in zip(whole, tree_leaves(g1))),
            grad_leaves=len(whole),
            worst_leaf=max(zip(
                (float((a - w).abs().max() / max(1.0, float(
                    w.abs().max()))) for a, w in zip(whole,
                                                     tree_leaves(g1))),
                tree_paths(g1)))[1],
            state_max_abs_err=max(float((a - w).abs().max()) for a, w in
                                  zip(whole_state, tree_leaves(st1))),
            spike_mismatch=[float((a != w[:, :rows]).float().mean())
                            for a, w in zip(taps, taps1)])
        out["held"] = out["loss_abs_err"] < 1e-5 and \
            out["grad_max_err"] < 1e-5 and max(out["spike_mismatch"]) == 0
        del g1, st1, taps1
    del whole, whole_state, taps
    dist.barrier()
    opt_cfg = OptimizerConfig(lr=2e-3, total_steps=1 + steps,
                              weight_decay=0.01, warmup_steps=5)
    step = make_train_step(cfg, opt_cfg, mesh=mesh, specs=p_specs)
    opt = init_opt_state(p_loc)
    ms = []
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for _ in range(1 + steps):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_loc, s_loc, opt, m = step(p_loc, s_loc, opt, b["images"],
                                    b["labels"])
        float(m["loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
    out["ms_per_step"] = ms[1:]
    if device.type == "cuda":
        peak = torch.tensor(float(torch.cuda.max_memory_allocated()),
                            device=device)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        out["peak_bytes_per_card"] = float(peak)
    del p_loc, s_loc, opt, step
    dist.barrier()
    if rank == 0:
        one = run_steps(cfg, None, global_batch, steps, seed, device)
        out["one_card_ms_per_step"] = one["ms_per_step"]
    dist.barrier()
    return out


#: The LM's depth in the ``lm_grads`` check (one card holds the
#: mesh-less gradient of ``deepseek-7b`` at this depth).
LM_CHECK_LAYERS = 4

#: The factors of the query and key projections in the ``lm_grads``
#: check: the published init, and 1/4 (exact in fp32), the CPU parity
#: tests' softer attention.
QK_SCALES = (1.0, 0.25)

#: The dense LM's leaves whose dim feeds a row-parallel sum: the heads of
#: the attention's projections and ``wo``, the hidden features of SwiGLU.
SUM_TERM_DIMS = {("blocks", "attn", "wq"): 2, ("blocks", "attn", "wk"): 2,
                 ("blocks", "attn", "wv"): 2, ("blocks", "attn", "wo"): 1,
                 ("blocks", "ffn", "w_gate"): 2, ("blocks", "ffn", "w_up"): 2,
                 ("blocks", "ffn", "w_down"): 1}


def reverse_sums(tree):
    """A dense LM's parameter (or gradient) tree with the heads and the
    hidden features in reverse order (:data:`SUM_TERM_DIMS`): the same
    function of the input (a kv head's q heads stay its own), whose
    ``wo`` and ``w_down`` products add their terms in the other order.
    Its own inverse."""
    def copy(t):
        return {k: copy(v) if isinstance(v, dict) else v
                for k, v in t.items()}
    out = copy(tree)
    for path, dim in SUM_TERM_DIMS.items():
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = node[path[-1]].flip(dim)
    return out


@contextlib.contextmanager
def branch_spikes():
    """The LIF's branch spikes of every layer, in the order the layers
    run (``models.lm._seq_lif`` wrapped for the block); under ``remat``
    the recomputations follow the forward's."""
    from repro_torch.models import lm
    seen, inner = [], lm._seq_lif

    def record(f, cfg):
        s = inner(f, cfg)
        seen.append(s.detach())
        return s
    lm._seq_lif = record
    try:
        yield seen
    finally:
        lm._seq_lif = inner


def spikes_differing(got, want) -> list[float]:
    """Per layer, the fraction of ``got``'s spikes (its rows, the leading
    ones of ``want``'s) that differ from ``want``'s."""
    return [float((a != w[:a.shape[0]]).float().mean())
            for a, w in zip(got, want)]


def grad_err(got: list, want) -> tuple[float, str]:
    """The largest error of a leaf of ``got`` (leaves in ``want``'s order)
    against the gradient tree ``want``, over max(1, the leaf's scale), and
    that leaf's path."""
    from repro_torch.core.spikingformer import tree_leaves, tree_paths
    errs = [float((a - w).abs().max() / max(1.0, float(w.abs().max())))
            for a, w in zip(got, tree_leaves(want))]
    i = errs.index(max(errs))
    return errs[i], tree_paths(want)[i]


def norm(leaves) -> float:
    return float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in leaves)))


def lm_cfg(arch: str, reduced: bool):
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.registry import reduced as reduce_cfg
    from repro_torch.core.lif import LIFConfig
    from repro_torch.core.policy import named_policy
    cfg = get_config(arch)
    if reduced:
        cfg = reduce_cfg(cfg)
    return cfg.replace(dtype=torch.float32, remat=True, lif=LIFConfig(
        policy=named_policy("cuda-full")))


def scale_qk(params, qk_scale: float):
    """``params`` (whole or a rank's slices) with ``wq`` and ``wk``
    multiplied by ``qk_scale`` in place."""
    for k in ("wq", "wk"):
        params["blocks"]["attn"][k].mul_(qk_scale)
    return params


def lm_grads_check(cfg, mesh, rank, batch, seq, seed, device,
                   qk_scale: float = 1.0) -> dict:
    """The LM's step-0 loss, gradient norm, every gradient leaf and the
    branch spikes on the mesh against rank 0's mesh-less step on the same
    weights and batch, and that step against itself with the row-parallel
    sums reversed (``cfg`` cut in depth so that one card holds it; ``wq``
    and ``wk`` times ``qk_scale``)."""
    from repro_torch.core.spikingformer import tree_leaves, value_and_grad
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.train import build_state, lm_step_batch
    from repro_torch.models.lm import lm_loss
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.loop import DataParallel, lm_grads
    layers = cfg.num_layers
    params, _, specs = build_state(cfg, mesh, seed=seed)
    scale_qk(params, qk_scale)
    host = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed)).batch(0)
    dp = DataParallel(cfg, mesh, specs)
    with branch_spikes() as spikes:
        loss, _, grads = lm_grads(cfg, params, lm_step_batch(
            cfg, host, device, mesh), dp=dp)
    whole = [mesh_mod.gather_full(g, s, mesh) for g, s in zip(
        tree_leaves(grads), dp.spec_list(params))]
    del grads, params
    out = {"arch": cfg.name, "layers": layers, "mesh": dict(mesh.shape),
           "tokens": [batch, seq], "qk_scale": qk_scale, "loss": float(loss),
           "grad_norm": norm(whole)}
    dist.barrier()
    if rank == 0:
        full = scale_qk(build_state(cfg, None, seed=seed, device=device)[0],
                        qk_scale)
        full_batch = lm_step_batch(cfg, host, device)
        with branch_spikes() as spikes1:
            (l1, _), g1 = value_and_grad(lm_loss, full, full_batch, cfg)
        err, leaf = grad_err(whole, g1)
        out.update(one_card_loss=float(l1),
                   loss_abs_err=abs(out["loss"] - float(l1)),
                   one_card_grad_norm=norm(tree_leaves(g1)),
                   grad_max_err=err, worst_leaf=leaf,
                   spikes_differing=spikes_differing(spikes[:layers],
                                                     spikes1[:layers]))
        with branch_spikes() as spikes2:
            (l2, _), g2 = value_and_grad(lm_loss, reverse_sums(full),
                                         full_batch, cfg)
        err, leaf = grad_err(tree_leaves(reverse_sums(g2)), g1)
        out["sums_reversed"] = {
            "loss_abs_err": abs(float(l2) - float(l1)),
            "grad_norm": norm(tree_leaves(g2)), "grad_max_err": err,
            "worst_leaf": leaf,
            "spikes_differing": spikes_differing(spikes2[:layers],
                                                 spikes1[:layers])}
        del full, g1, g2, spikes1, spikes2
    del whole, spikes
    dist.barrier()
    return out


def lm_estimate(cfg, shape: tuple[int, int], batch: int, seq: int) -> dict:
    """The dry run's count of the driver's step of ``cfg`` on a mesh of
    ``shape`` (rank 0 of a fake process group on ``meta``)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import ShapeSpec, input_specs
    sh = ShapeSpec("train", seq, batch)
    with dryrun.fake_world(shape[0] * shape[1]):
        mesh = Mesh(shape, ("data", "model"), torch.device("meta"))
        fn, structs, specs = input_specs(cfg, sh, mesh)
        args = dryrun.shard_args(structs, specs, mesh)
        del structs
        counts = dryrun.count_step(fn, args)
        del args
        return dryrun.cell_result(cfg.name, sh, cfg, counts,
                                  f"{shape[0]}x{shape[1]}", mesh.size)


def holds(estimate, world: int, device) -> bool:
    """Whether ``device`` holds the ``lm`` part by the dry run's
    ``estimate`` of a rank's peak: within the card's memory, or on the CPU
    the world's ranks together within the host's."""
    import os
    peak = estimate["bytes_per_device"]["peak"]
    if device.type == "cuda":
        return peak <= torch.cuda.get_device_properties(device).total_memory
    return world * peak <= os.sysconf("SC_PAGE_SIZE") * \
        os.sysconf("SC_PHYS_PAGES")


def lm_part(cfg, mesh, rank, batch, seq, steps, seed, device,
            estimate) -> dict:
    """The ``lm`` part (see the module docstring)."""
    from repro_torch.core.spikingformer import tree_leaves
    from repro_torch.launch.train import build_state, train
    init = [x.clone() for x in tree_leaves(build_state(
        cfg, mesh, seed=seed)[0])]
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated() if device.type == "cuda" else 0
    rows, stamps = [], []

    def on_step(step, m):
        stamps.append(time.perf_counter())
        rows.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                              "nonfinite") if k in m})
        if step == 0 and device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(sys.stderr):
        params, history = train(cfg, steps=1 + steps, global_batch=batch,
                                seq_len=seq, seed=seed, device=device,
                                on_step=on_step, mesh=mesh)
    from repro_torch.core.spikingformer import tree_paths
    unmoved = [p for p, a, b in zip(tree_paths(params), tree_leaves(params),
                                    init) if torch.equal(a, b)]
    moved = len(init) - len(unmoved)
    flag = torch.tensor(float(moved == len(init)), device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    out = {"arch": cfg.name, "layers": cfg.num_layers, "mesh":
           dict(mesh.shape), "tokens": [batch, seq], "metrics": rows,
           "finite": all(r.get("nonfinite", 0.0) == 0.0 for r in rows)
           and all(math.isfinite(x) for x in history),
           "leaves": len(init), "moved_leaves_rank0": moved,
           "unmoved_rank0": unmoved,
           "every_leaf_moved_on_every_rank": bool(flag),
           "ms_per_step": [(b - a) * 1e3 for a, b in zip(stamps,
                                                        stamps[1:])]}
    if device.type == "cuda":
        peak = torch.tensor(float(torch.cuda.max_memory_allocated()
                                  - before), device=device)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    if device.type == "cuda" and estimate is not None:
        est = estimate["bytes_per_device"]["peak"]
        out.update(measured_peak_bytes=float(peak),
                   estimated_peak_bytes=est,
                   peak_rel_err=(est - float(peak)) / float(peak),
                   estimate_fits=estimate["fits"],
                   estimate_roofline=estimate["roofline"],
                   estimate_collectives=estimate[
                       "collective_bytes_per_device"])
    return out


def cards() -> list[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return out.stdout.strip().splitlines()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="spikingformer-8-512")
    ap.add_argument("--policy", default="cuda-full")
    ap.add_argument("--per-rank", type=int, default=16)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--device", default=None,
                    help="default: the card of the rank (NCCL); 'cpu': gloo")
    ap.add_argument("--model", default=None,
                    help="model-axis sizes, comma separated: the "
                         "tensor-parallel parts on (world / M, M) meshes")
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--lm-arch", default=None,
                    help="the lm part's LM (with --model)")
    ap.add_argument("--lm-reduced", action="store_true")
    ap.add_argument("--lm-batch", type=int, default=8)
    ap.add_argument("--lm-seq", type=int, default=128)
    ap.add_argument("--exact-span", default="16",
                    help="block weights k/64 with |k| <= span, comma "
                         "separated: one tp_grads line per span")
    args = ap.parse_args()
    if args.model:
        return main_tp(args)
    if args.device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rank, world, device = init_distributed(args.device)
    lines = []
    try:
        mesh = make_test_mesh(world, 1, args.device)
        cfg = get_spikingformer_config(f"{args.preset}@{args.policy}")
        lines.append({"part": "bn_stats", "world": world,
                      **bn_stats(cfg, mesh, rank, world, args.per_rank,
                                 args.seed)})
        dist.barrier()
        gb = args.per_rank * world
        mesh_steps = run_steps(cfg, mesh, gb, args.steps, args.seed, device)
        dist.barrier()
        one = run_steps(cfg, None, gb, args.steps, args.seed, device) \
            if rank == 0 else None
        dist.barrier()
        lines.append({"part": "step", "preset": f"{args.preset}@"
                      f"{args.policy}", "world": world, "global_batch": gb,
                      "steps": f"1 warm-up + {args.steps} timed",
                      "mesh": mesh_steps, "one_device": one})
        mesh_run = run_train(cfg, mesh, gb, args.steps, args.seed, device)
        dist.barrier()
        one = run_train(cfg, None, gb, args.steps, args.seed, device) \
            if rank == 0 else None
        dist.barrier()
        lines.append({"part": "train", "preset": f"{args.preset}@"
                      f"{args.policy}", "world": world, "global_batch": gb,
                      "steps": f"1 warm-up + {args.steps} timed",
                      "mesh": mesh_run, "one_device": one})
    finally:
        shutdown_distributed()
    if rank != 0:
        return
    card = cards() if device.type == "cuda" else []
    for line in lines:
        line.update(device=str(device), cards=card,
                    torch=torch.__version__)
        print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines)
                                  + "\n")


def main_tp(args) -> None:
    """The tensor-parallel parts (``--model``)."""
    import os
    shards = [int(m) for m in args.model.split(",")]
    world = int(os.environ.get("WORLD_SIZE", 1))
    lm = lm_cfg(args.lm_arch, args.lm_reduced) if args.lm_arch else None
    # the dry run's count, on rank 0 before the real group starts
    estimate = lm_estimate(lm, (world // shards[0], shards[0]),
                           args.lm_batch, args.lm_seq) \
        if lm and os.environ.get("RANK", "0") == "0" else None
    if args.device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rank, world, device = init_distributed(args.device)
    lines = []
    try:
        cfg = get_spikingformer_config(f"{args.preset}@{args.policy}")
        meshes = {m: make_test_mesh(world // m, m, args.device)
                  for m in shards}
        for span in (int(x) for x in args.exact_span.split(",")):
            for m in shards:
                lines.append({"part": "tp_grads", "preset": f"{args.preset}@"
                              f"{args.policy}", "world": world,
                              "steps": f"1 warm-up + {args.steps} timed",
                              **tp_grads(cfg, meshes[m], rank,
                                         args.global_batch, args.steps,
                                         args.seed, device, span)})
                if device.type == "cuda":
                    torch.cuda.empty_cache()
        if lm is not None:
            # with the LIF (a spike may flip where the row-parallel sums
            # add in another order) and without it (no discrete step), at
            # the published attention and a softer one
            for qk, cut in ((qk, cut) for qk in QK_SCALES
                            for cut in (lm, lm.replace(lif=None))):
                lines.append({"part": "lm_grads", "world": world,
                              "lif": cut.lif is not None,
                              **lm_grads_check(
                                  cut.replace(num_layers=LM_CHECK_LAYERS),
                                  meshes[shards[0]], rank, args.lm_batch,
                                  args.lm_seq, args.seed, device, qk)})
                if device.type == "cuda":
                    torch.cuda.empty_cache()
        # the whole model trains only where the dry run's estimate of its
        # step on this mesh says the device holds it (rank 0's verdict,
        # sent to every rank)
        fits = torch.tensor(float(estimate is not None and holds(
            estimate, world, device)), device=device)
        dist.broadcast(fits, 0)
        if lm is not None and not fits:
            lines.append({"part": "lm", "world": world, "mesh": dict(
                meshes[shards[0]].shape), "skipped": "the dry run's peak "
                "a rank does not fit the device", "estimated_peak_bytes":
                estimate and estimate["bytes_per_device"]["peak"]})
        elif lm is not None:
            lines.append({"part": "lm", "world": world,
                          "steps": f"1 warm-up + {args.steps} timed",
                          **lm_part(lm, meshes[shards[0]], rank,
                                    args.lm_batch, args.lm_seq, args.steps,
                                    args.seed, device, estimate)})
    finally:
        shutdown_distributed()
    if rank != 0:
        return
    card = cards() if device.type == "cuda" else []
    for line in lines:
        line.update(device=str(device), cards=card,
                    torch=torch.__version__)
        print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines)
                                  + "\n")


if __name__ == "__main__":
    main()
