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
  ``LM_CHECK_LAYERS`` layers (an MoE to ``MOE_CHECK_LAYERS``), with the
  LIF and without it (an MoE: with it, at capacity factor 8, where no
  pair drops, and at its published one), at each of ``QK_SCALES`` (``wq``
  and ``wk`` scaled): the step-0 loss, the gradient norm and every
  gradient leaf (gathered whole) against rank 0's mesh-less gradient, and
  the branch spikes of rank 0's rows that differ from the mesh-less ones
  (an MoE's loss with its aux loss weighted out: the aux loss is the mean
  of the ranks', each over its own rows, as in the reference). Beside it,
  rank 0's mesh-less gradient again with the terms of every sum the
  model axis splits (``wo``'s heads, a dense ``w_down``'s hidden
  features, each family's own: :func:`sum_terms`) in reverse order
  (:func:`reverse_sums`: the same function, other roundings),
  against the first: how far the order of those sums alone moves the
  loss, the gradients and the spikes on one card.
* ``lm_decode`` (an MoE ``--lm-arch``, on the first M): 16 decode steps of
  two slots of the ``MOE_CHECK_LAYERS``-layer cut with the LIF from a zero
  cache of 64 positions on the mesh (every rank routes every token to its
  own experts) against rank 0's mesh-less decode: each step's largest
  logit error and whether the greedy tokens agree.
* ``arms`` (``--lm-arch``, on the first M): the attention schemes and
  decode modes that divisibility picks on a model axis of M at reduced
  widths (``reduced(qwen3-0.6b)`` + LIF with 6 heads: "seq" at S = 8 and
  "none" at S = 7 training; 2 kv heads: flash-decode over a cache of 16,
  head_dim over one of 18) against rank 0's mesh-less step and decode.
* ``lm`` (``--lm-arch ARCH``, on each M, where the dry run's estimate of
  a rank's peak fits the card, or on the CPU the host's memory with every
  rank's; a model that does not is cut to the deepest depth whose
  estimate is within ``FIT_BYTES`` and whose whole weights, which every
  rank draws, within ``DRAW_BYTES``): the LM with the LIF on every FFN
  branch, fp32, each layer recomputed, ``--lm-batch`` x ``--lm-seq``
  tokens, 1 + ``--steps`` steps through ``launch.train.train`` on the
  mesh: every step's metrics, whether every parameter leaf moved, an
  MoE's pairs dropped by each layer in the first forward (over the
  ranks), the ms per timed step, and the peak memory on each card over
  the timed steps (above what was allocated before ``train`` started)
  against the dry run's estimate of the same step on the same mesh
  (counted on ``meta`` tensors under a fake process group before the real
  one starts).

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
#: mesh-less gradient of ``deepseek-7b`` at this depth), and an MoE's
#: (``mixtral-8x7b``: 1.45 G parameters a layer).
LM_CHECK_LAYERS = 4
MOE_CHECK_LAYERS = 2
#: ... and MLA's (``deepseek-v2-236b``), and the other families'.
MLA_CHECK_LAYERS = 1
FAMILY_CHECK_LAYERS = 2
#: The hybrid's SSD chunk on the card (ROADMAP C6: the published 128
#: overflows the masked exp, and the gradient is not finite).
HYBRID_CHUNK = 16
#: The ``lm`` part's depth cut: a rank's estimated peak (the card's 80 GB
#: less the CUDA context, NCCL's buffers and the allocator's slack), and
#: the whole fp32 weights every rank draws before it keeps its slices.
FIT_BYTES = 64e9
DRAW_BYTES = 48e9

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


def _attn_terms(prefix: tuple, stacked: bool = True) -> dict:
    """An attention's heads (``wq`` / ``wk`` / ``wv`` / ``wo``) under
    ``prefix``, its leaves stacked on a layer axis or not."""
    o = int(stacked)
    return {(*prefix, "wq"): 1 + o, (*prefix, "wk"): 1 + o,
            (*prefix, "wv"): 1 + o, (*prefix, "wo"): o}


def sum_terms(cfg) -> dict:
    """The leaves of ``cfg``'s tree whose dims hold the terms of a sum the
    model axis splits, by path: a dim (all of it) or ``(dim, first,
    count)``, each reversed by :func:`reverse_sums`. Dense and MoE:
    :data:`SUM_TERM_DIMS` (an MoE's attention only: an expert's hidden
    features are summed on one rank); MLA its heads; RWKV every channel
    of the time mix (each head's dk and dv too, so the state, ``ln_x``'s
    statistics and ``w_out``'s rows sum in the other order) and the
    channel mix's hidden features; Mamba2 its heads (``w_in``'s z, x and
    dt blocks, the conv's x channels) beside the shared block's;
    whisper's attentions' heads and its MLPs' hidden features."""
    if cfg.family == "rwkv":
        t, c = ("blocks", "time"), ("blocks", "chan")
        return {**{(*t, w): 2 for w in ("w_r", "w_k", "w_v", "w_g",
                                         "w_decay")},
                (*t, "decay_bias"): 1, (*t, "u_bonus"): (1, 2),
                (*t, "ln_x", "scale"): 1, (*t, "ln_x", "bias"): 1,
                (*t, "w_out"): 1, (*c, "w_k"): 2, (*c, "w_v"): 1}
    if cfg.family == "hybrid":
        di, ds, h = cfg.ssm.d_inner, cfg.ssm.d_state, cfg.ssm.n_heads
        m = ("blocks", "ssm")
        return {(*m, "w_in"): ((2, 0, di), (2, di, di),
                               (2, 2 * di + 2 * ds, h)),
                (*m, "conv_w"): ((2, 0, di),), (*m, "conv_b"): ((1, 0, di),),
                (*m, "a_log"): 1, (*m, "dt_bias"): 1, (*m, "d_skip"): 1,
                (*m, "w_out"): 1, **_attn_terms(("shared", "attn"), False),
                ("shared", "ffn", "w_gate"): 1, ("shared", "ffn", "w_up"): 1,
                ("shared", "ffn", "w_down"): 0}
    if cfg.family == "audio":
        out = {}
        for blk, attns in (("enc_blocks", ("attn",)),
                           ("dec_blocks", ("self", "cross"))):
            for a in attns:
                out.update(_attn_terms((blk, a)))
            out.update({(blk, "mlp", "w_in"): 2, (blk, "mlp", "b_in"): 1,
                        (blk, "mlp", "w_out"): 1})
        return out
    if cfg.mla is not None:
        return {("blocks", "attn", w): 2 for w in ("w_uq", "w_uk", "w_uv")} \
            | {("blocks", "attn", "wo"): 1}
    return {k: d for k, d in SUM_TERM_DIMS.items()
            if cfg.moe is None or k[1] != "ffn"}


def _flip(x, spec):
    """``x`` with each part ``spec`` names reversed (:func:`sum_terms`)."""
    if isinstance(spec, int):
        return x.flip(spec)
    if all(isinstance(d, int) for d in spec):
        return x.flip(spec)
    x = x.clone()
    for dim, lo, n in spec:
        part = x.narrow(dim, lo, n)
        part.copy_(part.flip(dim))
    return x


def reverse_sums(tree, cfg):
    """``cfg``'s parameter (or gradient) tree with the terms of every sum
    the model axis splits in reverse order (:func:`sum_terms`): the same
    function of the input (a kv head's q heads stay its own), whose sums
    add their terms in the other order. Its own inverse."""
    def copy(t):
        return {k: copy(v) if isinstance(v, dict) else v
                for k, v in t.items()}
    out = copy(tree)
    for path, spec in sum_terms(cfg).items():
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = _flip(node[path[-1]], spec)
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
    errs = [max_err(a, w) / max(1.0, float(w.max()), -float(w.min()))
            for a, w in zip(got, tree_leaves(want))]
    i = errs.index(max(errs))
    return errs[i], tree_paths(want)[i]


#: Elements a piece of a leaf in :func:`max_err` and :func:`norm`: a
#: whole leaf's fp64 copy or difference would not fit beside the
#: gradients (``deepseek-v2-236b``'s routed experts are 2.4 G elements a
#: layer).
PIECE = 1 << 26


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b|, a piece at a time."""
    return max((float((x - y).abs().max()) for x, y in zip(
        a.reshape(-1).split(PIECE), b.reshape(-1).split(PIECE))),
        default=0.0)


def norm(leaves) -> float:
    return math.sqrt(sum(float(torch.sum(x.double() ** 2)) for g in leaves
                         for x in g.reshape(-1).split(PIECE)))


@contextlib.contextmanager
def counting_drops(out: list):
    """While open, every MoE layer call appends to ``out`` the number of
    its (token, choice) pairs past their expert's capacity on this rank (a
    device scalar): ``moe._route`` wrapped, its results unchanged."""
    from repro_torch.models import moe
    route = moe._route

    def counted(router_w, x_flat, cfg):
        gates, experts, aux = route(router_w, x_flat, cfg)
        pos = moe._expert_positions(experts.reshape(-1), cfg.num_experts)
        out.append((pos >= cfg.capacity(x_flat.shape[0])).sum())
        return gates, experts, aux
    moe._route = counted
    try:
        yield out
    finally:
        moe._route = route


def lm_cfg(arch: str, reduced: bool):
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.registry import reduced as reduce_cfg
    from repro_torch.core.lif import LIFConfig
    from repro_torch.core.policy import named_policy
    cfg = get_config(arch)
    if reduced:
        cfg = reduce_cfg(cfg)
    if cfg.ssm is not None and not reduced:
        # C6: the published chunk's masked exp overflows the gradient
        cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm,
                                                  chunk=HYBRID_CHUNK))
    return cfg.replace(dtype=torch.float32, remat=True, lif=LIFConfig(
        policy=named_policy("cuda-full")))


def check_cut(lm):
    """``lm`` at the depth of its ``lm_grads`` check (one card holds its
    gradient there): ``LM_CHECK_LAYERS`` for the dense family,
    ``MOE_CHECK_LAYERS`` for an MoE, ``MLA_CHECK_LAYERS`` for MLA's
    (``deepseek-v2-236b``: 3.97 G parameters a layer), else
    ``FAMILY_CHECK_LAYERS`` (the hybrid's as one group, the shared block
    after them)."""
    if lm.mla is not None:
        return lm.replace(num_layers=MLA_CHECK_LAYERS)
    if lm.moe is not None:
        return lm.replace(num_layers=MOE_CHECK_LAYERS)
    if lm.family in ("dense", "vlm"):
        return lm.replace(num_layers=LM_CHECK_LAYERS)
    if lm.family == "hybrid":
        return lm.replace(num_layers=FAMILY_CHECK_LAYERS,
                          hybrid_attn_every=FAMILY_CHECK_LAYERS)
    if lm.family == "audio":
        return lm.replace(num_layers=FAMILY_CHECK_LAYERS,
                          encoder_layers=FAMILY_CHECK_LAYERS)
    return lm.replace(num_layers=FAMILY_CHECK_LAYERS)


def lm_check_cuts(lm) -> list:
    """The ``lm_grads`` cases of ``lm`` (see the module docstring):
    ``(config cut in depth, qk_scale)`` pairs."""
    import dataclasses
    lm = check_cut(lm)
    if lm.family == "audio":            # no LIF to take away
        variants = (lm,)
    elif lm.moe is None:
        variants = (lm, lm.replace(lif=None))
    else:
        variants = [lm.replace(moe=dataclasses.replace(
            lm.moe, capacity_factor=c))
            for c in (8.0, lm.moe.capacity_factor)]
    return [(v, qk) for qk in QK_SCALES for v in variants]


def scale_qk(params, qk_scale: float):
    """``params`` (whole or a rank's slices) with every attention's query
    and key projections (``wq`` / ``wk``, MLA's ``w_uq`` / ``w_uk``)
    multiplied by ``qk_scale`` in place."""
    for k, v in params.items():
        if isinstance(v, dict):
            scale_qk(v, qk_scale)
        elif k in ("wq", "wk", "w_uq", "w_uk"):
            v.mul_(qk_scale)
    return params


def dense_attention(cfg) -> bool:
    """Whether ``cfg`` is a GQA LM with a SwiGLU or MoE FFN (its reduced
    arms are :func:`arms_check`'s, the others :func:`family_arms`)."""
    return cfg.family in ("dense", "moe", "vlm") and cfg.mla is None


def loss_of(cfg):
    """The family's loss (an MoE's with its aux loss weighted out)."""
    import functools
    if cfg.family == "audio":
        from repro_torch.models.encdec import encdec_loss
        return encdec_loss
    from repro_torch.models.lm import lm_loss
    return functools.partial(lm_loss, aux_weight=0.0) \
        if cfg.moe is not None else lm_loss


def lm_weights(cfg, mesh, seed: int, device):
    """``launch.train.build_state``'s weights of ``cfg`` from ``seed``
    and their specs, without its AdamW moments (twice the weights, which
    at a model axis of 1 would sit beside the gradients): on ``mesh`` the
    rank's slices, the moments dropped as soon as they are made; without
    one drawn whole on ``device`` as ``build_state`` draws them."""
    from repro_torch.launch.train import build_state
    from repro_torch.models.common import split_tree
    if mesh is not None:
        params, opt, specs = build_state(cfg, mesh, seed=seed)
        del opt
        return params, specs
    if cfg.family == "audio":
        from repro_torch.models.encdec import init_encdec as init
    else:
        from repro_torch.models.lm import init_lm as init
    gen = torch.Generator(device=device).manual_seed(seed)
    return split_tree(init(gen, cfg, device))


def lm_grads_check(cfg, mesh, rank, batch, seq, seed, device,
                   qk_scale: float = 1.0) -> dict:
    """The LM's step-0 loss, gradient norm, every gradient leaf and the
    branch spikes on the mesh against rank 0's mesh-less step on the same
    weights and batch, and that step against itself with the row-parallel
    sums reversed (``cfg`` cut in depth so that one card holds it; ``wq``
    and ``wk`` times ``qk_scale``). An MoE's experts are relaid to one
    shard for the comparison, its aux loss weighted out."""
    from repro_torch.core.spikingformer import (tree_leaves, tree_paths,
                                                value_and_grad)
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.train import lm_step_batch
    from repro_torch.models.moe import relayout
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.loop import DataParallel
    layers = cfg.num_layers
    moe = cfg.moe is not None
    loss_fn = loss_of(cfg)
    params, specs = lm_weights(cfg, mesh, seed, device)
    scale_qk(params, qk_scale)
    host = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed)).batch(0)
    dp = DataParallel(cfg, mesh, specs)
    mcfg = cfg.with_model_shards(mesh.shape["model"])
    with branch_spikes() as spikes, mesh_mod.use_mesh(mesh):
        b = lm_step_batch(cfg, host, device, mesh)
        (loss, metrics), grads = value_and_grad(loss_fn, dp.gather(params),
                                                b, mcfg)
        share = dp.token_share(b)
        grads = dp.reduce(grads, params, share)
        loss = dp.weighted_sum(metrics["loss"], share)
    whole = [mesh_mod.gather_full(g, s, mesh) for g, s in zip(
        tree_leaves(grads), dp.spec_list(params))]
    if moe:     # the experts' gradients in the one-shard layout
        m = mesh.shape["model"]
        whole = [relayout(g, 1, cfg.moe.num_experts,
                          -2 if p.endswith("w_down") else -1)
                 if p.split(".")[-1] in ("w_gate", "w_up", "w_down")
                 and g.ndim == 5 and m > 1 else g
                 for p, g in zip(tree_paths(grads), whole)]
    del grads, params
    out = {"arch": cfg.name, "layers": layers, "mesh": dict(mesh.shape),
           "tokens": [batch, seq], "qk_scale": qk_scale, "loss": float(loss),
           "grad_norm": norm(whole)}
    if moe:
        out.update(capacity_factor=cfg.moe.capacity_factor, aux_weight=0.0)
    dist.barrier()
    if rank == 0:
        full = scale_qk(lm_weights(cfg, None, seed, device)[0], qk_scale)
        full_batch = lm_step_batch(cfg, host, device)
        with branch_spikes() as spikes1:
            (l1, m1), g1 = value_and_grad(loss_fn, full, full_batch, cfg)
        l1 = m1["loss"]
        err, leaf = grad_err(whole, g1)
        out.update(one_card_loss=float(l1),
                   loss_abs_err=abs(out["loss"] - float(l1)),
                   one_card_grad_norm=norm(tree_leaves(g1)),
                   grad_max_err=err, worst_leaf=leaf,
                   spikes_differing=spikes_differing(spikes[:layers],
                                                     spikes1[:layers]))
    del whole           # its room goes to the reversed step's gradient
    if rank == 0:
        with branch_spikes() as spikes2:
            (_, m2), g2 = value_and_grad(loss_fn, reverse_sums(full, cfg),
                                         full_batch, cfg)
        l2 = m2["loss"]
        err, leaf = grad_err(tree_leaves(reverse_sums(g2, cfg)), g1)
        out["sums_reversed"] = {
            "loss_abs_err": abs(float(l2) - float(l1)),
            "grad_norm": norm(tree_leaves(g2)), "grad_max_err": err,
            "worst_leaf": leaf,
            "spikes_differing": spikes_differing(spikes2[:layers],
                                                 spikes1[:layers])}
        del g2, spikes2
    if rank == 0:
        del full, g1, spikes1
    del spikes
    dist.barrier()
    return out


def lm_decode_check(cfg, mesh, rank, seed, device, steps: int = 16,
                    max_seq: int = 64) -> dict:
    """``steps`` decode steps of two slots from a zero cache on the mesh
    (the cache laid out as ``launch.specs.cache_structs`` lays it out for
    the mesh's model axis; the encoder-decoder's from
    ``init_encdec_cache`` of two rows of frames) against rank 0's
    mesh-less decode of the same weights and tokens: each step's largest
    logit error and whether the greedy tokens agree, and the mode (the
    attention's, MLA's, or the rank's shapes of the recurrent states).
    Whisper's query and key projections are scaled by ``QK_SCALES[-1]``
    (C7: its attention at the published init is too sharp to compare)."""
    from repro_torch.core.spikingformer import tree_leaves, tree_paths
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.specs import bind_model_axis, cache_structs
    mcfg = bind_model_axis(cfg, mesh)
    params, specs = lm_weights(cfg, mesh, seed, device)
    # the serving plan's leaves: the training plan's gathered over "data"
    params = mesh_mod.map_specs(lambda s, x: mesh_mod.gather_leaf(
        x, s, mesh), specs, params)
    gen = torch.Generator().manual_seed(seed + 9)
    toks = torch.randint(0, cfg.vocab_size, (steps, 2, 1), generator=gen)
    frames = torch.randn((2, cfg.encoder_seq or 1, cfg.d_model),
                         generator=gen).to(device)
    audio = cfg.family == "audio"
    qk = QK_SCALES[-1] if audio else 1.0   # C7: whisper's sharp init
    scale_qk(params, qk)
    if audio:
        from repro_torch.models.encdec import (encdec_decode_step as step,
                                               init_encdec_cache)
    else:
        from repro_torch.models.lm import init_cache
        from repro_torch.models.lm import lm_decode_step as step
    logits = []
    with mesh_mod.use_mesh(mesh), torch.no_grad():
        if audio:
            cache = init_encdec_cache(params, frames, mcfg, 2, max_seq,
                                      torch.float32)
        else:
            cache = init_cache(mcfg, 2, max_seq, torch.float32, device)
            c_specs = mesh_mod.sanitize_specs(cache_structs(
                mcfg, 2, max_seq, (), model=mesh.shape["model"],
                lif_replicated=True)[1], cache, mesh)
            cache = mesh_mod.map_specs(lambda s, x: mesh_mod.local_shard(
                x, s, mesh), c_specs, cache)
        mode = {p: list(x.shape) for p, x in zip(tree_paths(cache),
                                                 tree_leaves(cache))
                if not p.split(".")[-2:-1] == ["lif"]}
        for i in range(steps):
            out, cache = step(
                params, cache, toks[i].to(device),
                torch.full((2,), i, dtype=torch.int32, device=device), mcfg)
            logits.append(out)
    del params, cache
    res = {"arch": cfg.name, "layers": cfg.num_layers,
           "mesh": dict(mesh.shape), "steps": steps, "cache": max_seq,
           "qk_scale": qk, "mode": mode}
    dist.barrier()
    if rank == 0:
        full = scale_qk(lm_weights(cfg, None, seed, device)[0], qk)
        if audio:
            cache = init_encdec_cache(full, frames, cfg, 2, max_seq,
                                      torch.float32)
        else:
            cache = init_cache(cfg, 2, max_seq, torch.float32, device)
        err, same = [], []
        with torch.no_grad():
            for i in range(steps):
                want, cache = step(
                    full, cache, toks[i].to(device),
                    torch.full((2,), i, dtype=torch.int32, device=device),
                    cfg)
                err.append(float((logits[i] - want).abs().max()))
                same.append(bool(torch.equal(logits[i].argmax(-1),
                                             want.argmax(-1))))
        res.update(max_abs_err_per_step=err, greedy_equal_per_step=same)
        del full, cache
    dist.barrier()
    return res


def family_arms(lm, mesh, rank, seed, device) -> list[dict]:
    """The layouts a model axis of M picks for ``lm``'s family at reduced
    widths (MLA with M + 2 heads: "seq" at S = 8, and its latent cache on
    its positions and on its features; RWKV's state on dk; Mamba2's
    ``h`` on its head_dim columns, and on d_state where head_dim is 2;
    whisper with M + 2 heads: "seq" and "none", and its cross memory on
    head_dim), each against rank 0's mesh-less step and decode at
    ``QK_SCALES[-1]``."""
    import dataclasses
    base = lm_cfg(lm.name, True)
    m = mesh.shape["model"]
    out = []
    if lm.mla is not None:
        h = m + 2
        wide = base.replace(n_heads=h, mla=dataclasses.replace(
            base.mla, n_heads=h))
        out.append(("train seq", lm_grads_check(
            wide, mesh, rank, 4, 8, seed, device, QK_SCALES[-1])))
        for c in (16, 18):
            out.append((f"decode latent cache {c}", lm_decode_check(
                base, mesh, rank, seed, device, 12, c)))
    elif lm.family == "rwkv":
        out.append(("train heads", lm_grads_check(
            base, mesh, rank, 4, 16, seed, device, QK_SCALES[-1])))
        out.append(("decode dk", lm_decode_check(base, mesh, rank, seed,
                                                 device, 12, 16)))
    elif lm.family == "hybrid":
        ds = base.replace(ssm=dataclasses.replace(base.ssm, head_dim=2))
        out.append(("train heads", lm_grads_check(
            base, mesh, rank, 4, 16, seed, device, QK_SCALES[-1])))
        out.append(("decode head_dim", lm_decode_check(
            base, mesh, rank, seed, device, 12, 16)))
        out.append(("decode d_state", lm_decode_check(
            ds, mesh, rank, seed, device, 12, 16)))
    elif lm.family == "audio":
        h = m + 2
        wide = base.replace(n_heads=h, n_kv_heads=h)
        for seq, frames in ((8, 32), (7, 30)):
            out.append((f"train {seq} tokens, {frames} frames",
                        lm_grads_check(wide.replace(encoder_seq=frames),
                                       mesh, rank, 4, seq, seed, device,
                                       QK_SCALES[-1])))
        out.append(("decode cross memory on head_dim", lm_decode_check(
            wide.replace(encoder_seq=30), mesh, rank, seed, device, 12,
            16)))
    return [{"arm": name, **row} for name, row in out]


def arms_check(mesh, rank, seed, device) -> list[dict]:
    """The schemes a model axis of M picks at reduced widths (see the
    module docstring), each on the mesh against rank 0's mesh-less run of
    the same weights: training, the loss's and every gradient leaf's
    largest error over max(1, its scale); decode, each step's largest
    logit error."""
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.core.spikingformer import tree_leaves, value_and_grad
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.train import build_state, lm_step_batch
    from repro_torch.models.attention import attn_scheme
    from repro_torch.models.lm import lm_loss
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.loop import DataParallel, lm_grads
    base = lm_cfg("qwen3-0.6b", True)
    m = mesh.shape["model"]
    heads = m + 2 if m > 2 else 3
    out = []
    for seq in (8, 7):
        cfg = base.replace(n_heads=heads, n_kv_heads=heads // 2 if
                           heads % 2 == 0 else heads)
        params, _, specs = build_state(cfg, mesh, seed=seed)
        host = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                      global_batch=4, seed=seed)).batch(0)
        dp = DataParallel(cfg, mesh, specs)
        with mesh_mod.use_mesh(mesh):
            scheme = attn_scheme(cfg.attn, seq)
        loss, _, grads = lm_grads(cfg, params, lm_step_batch(
            cfg, host, device, mesh), dp=dp)
        whole = [mesh_mod.gather_full(g, s, mesh) for g, s in zip(
            tree_leaves(grads), dp.spec_list(params))]
        row = {"arm": f"train {scheme}", "heads": cfg.n_heads,
               "kv_heads": cfg.n_kv_heads, "seq": seq,
               "mesh": dict(mesh.shape)}
        if rank == 0:
            full = build_state(cfg, None, seed=seed, device=device)[0]
            (l1, _), g1 = value_and_grad(lm_loss, full, lm_step_batch(
                cfg, host, device), cfg)
            err, leaf = grad_err(whole, g1)
            row.update(loss_abs_err=abs(float(loss) - float(l1)),
                       grad_max_err=err, worst_leaf=leaf)
        dist.barrier()
        out.append(row)
    for max_seq in (16, 18):
        row = lm_decode_check(base.replace(n_kv_heads=2), mesh, rank, seed,
                              device, steps=12, max_seq=max_seq)
        out.append({"arm": f"decode, cache {max_seq}", **row})
    return out


def deepest_fit(cfg, shape: tuple[int, int], batch: int, seq: int):
    """``cfg`` at its depth where the dry run's estimate of a rank's peak
    is within ``FIT_BYTES`` and its whole fp32 weights within
    ``DRAW_BYTES``; else cut to the deepest such depth (the estimate is
    affine in the depth: counted at 1 and 2 layers, then checked), and
    that depth's estimate."""
    whole = cfg.param_count() * 4
    full = lm_estimate(cfg, shape, batch, seq)
    if full["bytes_per_device"]["peak"] <= FIT_BYTES and whole <= DRAW_BYTES:
        return cfg, full
    one, two = (lm_estimate(cfg.replace(num_layers=n), shape, batch, seq)
                ["bytes_per_device"]["peak"] for n in (1, 2))
    per_layer_w = (cfg.param_count() - cfg.replace(num_layers=0)
                   .param_count()) / cfg.num_layers * 4
    n = min(int((FIT_BYTES - one) // (two - one)) + 1,
            int(DRAW_BYTES // per_layer_w), cfg.num_layers)
    while n > 1:
        est = lm_estimate(cfg.replace(num_layers=n), shape, batch, seq)
        if est["bytes_per_device"]["peak"] <= FIT_BYTES:
            return cfg.replace(num_layers=n), est
        n -= 1
    return cfg.replace(num_layers=1), lm_estimate(
        cfg.replace(num_layers=1), shape, batch, seq)


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
    # the initial shards, on the host (the card holds the step's state)
    init = [x.cpu() for x in tree_leaves(build_state(
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
    drops: list = []
    with contextlib.redirect_stdout(sys.stderr), \
            counting_drops(drops) if cfg.moe is not None else \
            contextlib.nullcontext():
        params, history = train(cfg, steps=1 + steps, global_batch=batch,
                                seq_len=seq, seed=seed, device=device,
                                on_step=on_step, mesh=mesh)
    from repro_torch.core.spikingformer import tree_paths
    unmoved = [p for p, a, b in zip(tree_paths(params), tree_leaves(params),
                                    init) if torch.equal(a.cpu(), b)]
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
    if drops:       # the first forward's layers, summed over the ranks
        first = torch.stack(drops[:cfg.num_layers]).to(device)
        dist.all_reduce(first)
        out["dropped_pairs_per_layer"] = [int(d) for d in first]
        out["capacity_factor"] = cfg.moe.capacity_factor
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
    """The tensor-parallel parts (``--model``). Rank 0 prints each line as
    its part ends. The ``lm`` part runs near the card's capacity, so the
    allocator grows its segments in place (``expandable_segments``)
    rather than leave freed blocks too small to reuse."""
    import os
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    shards = [int(m) for m in args.model.split(",")]
    world = int(os.environ.get("WORLD_SIZE", 1))
    lm = lm_cfg(args.lm_arch, args.lm_reduced) if args.lm_arch else None
    # the dry run's counts and the depth cut on each mesh, on rank 0
    # before the real group starts
    plans = {m: deepest_fit(lm, (world // m, m), args.lm_batch, args.lm_seq)
             for m in shards} \
        if lm and os.environ.get("RANK", "0") == "0" else {}
    if args.device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rank, world, device = init_distributed(args.device)
    card = cards() if device.type == "cuda" and rank == 0 else []
    if rank == 0 and args.out:
        Path(args.out).write_text("")

    def emit(line: dict) -> None:
        """Rank 0 prints the line (and appends it to ``--out``) now."""
        if rank != 0:
            return
        line.update(device=str(device), cards=card, torch=torch.__version__)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    try:
        cfg = get_spikingformer_config(f"{args.preset}@{args.policy}")
        meshes = {m: make_test_mesh(world // m, m, args.device)
                  for m in shards}
        for span in (int(x) for x in args.exact_span.split(",")):
            for m in shards:
                emit({"part": "tp_grads", "preset": f"{args.preset}@"
                      f"{args.policy}", "world": world,
                      "steps": f"1 warm-up + {args.steps} timed",
                      **tp_grads(cfg, meshes[m], rank, args.global_batch,
                                 args.steps, args.seed, device, span)})
                if device.type == "cuda":
                    torch.cuda.empty_cache()
        first = meshes[shards[0]]
        if lm is not None:
            for cut, qk in lm_check_cuts(lm):
                emit({"part": "lm_grads", "world": world,
                      "lif": cut.lif is not None,
                      **lm_grads_check(cut, first, rank, args.lm_batch,
                                       args.lm_seq, args.seed, device, qk)})
                if device.type == "cuda":
                    torch.cuda.empty_cache()
            if lm.moe is not None or not dense_attention(lm):
                emit({"part": "lm_decode", "world": world,
                      **lm_decode_check(check_cut(lm), first, rank,
                                        args.seed, device)})
            arms = arms_check(first, rank, args.seed, device) \
                if dense_attention(lm) else family_arms(lm, first, rank,
                                                   args.seed, device)
            for row in arms:
                emit({"part": "arms", "world": world, **row})
            if device.type == "cuda":
                torch.cuda.empty_cache()
        for m in shards if lm is not None else ():
            # the model trains only where the dry run's estimate of its
            # step on this mesh says the device holds it (rank 0's
            # verdict and depth, sent to every rank)
            cut, estimate = plans.get(m, (None, None))
            plan = torch.tensor([
                float(estimate is not None and holds(estimate, world,
                                                     device)),
                float(cut.num_layers if cut is not None else 0)],
                device=device)
            dist.broadcast(plan, 0)
            if not plan[0]:
                emit({"part": "lm", "world": world, "mesh": dict(
                    meshes[m].shape), "skipped": "the dry run's peak a rank "
                    "does not fit the device", "estimated_peak_bytes":
                    estimate and estimate["bytes_per_device"]["peak"]})
                continue
            emit({"part": "lm", "world": world,
                  "steps": f"1 warm-up + {args.steps} timed",
                  "published_layers": lm.num_layers,
                  **lm_part(lm.replace(num_layers=int(plan[1])), meshes[m],
                            rank, args.lm_batch, args.lm_seq, args.steps,
                            args.seed, device, estimate)})
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    main()
