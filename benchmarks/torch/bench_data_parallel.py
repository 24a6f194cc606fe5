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

Rank 0 prints one JSON line per part, with the cards' names and power
limits, and with ``--out FILE`` writes them there too.
"""
from __future__ import annotations

import argparse
import contextlib
import json
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
    args = ap.parse_args()
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


if __name__ == "__main__":
    main()
