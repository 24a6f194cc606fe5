#!/usr/bin/env python3
"""Where one forward, or one training step, of the PyTorch/CUDA port spends
its time on the card.

    python3 benchmarks/torch/profile_forward.py [--preset spikingformer-8-512]
        [--batch 16] [--depth 8] [--top 25] [--train]

For the ``cuda-full`` and the ``eager`` policy on the same random weights it
prints, as JSON lines: the time of a whole request (host clock around a
synchronised forward, median of 5), the time of the tokenizer alone and of
one block alone (CUDA events), and — from ``torch.profiler`` over one
forward — the device-busy time, its share of the request, the number of
kernel launches, and the kernels that take the most device time. With ``--train`` it does the same for one
BPTT + AdamW step of ``make_train_step`` on a ``SyntheticVision`` batch
(step time: host clock around a synchronised step, median of 3, each from
the same state), with the peak device memory of a step. Needs a CUDA
device; weights are random (``--seed``), so only times mean anything here.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_spikingformer_config  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.core.spiking_layers import block_apply  # noqa: E402
from repro_torch.core.spikingformer import (SpikingFormer,  # noqa: E402
                                            _index_tree, init_spikingformer,
                                            tokenizer_apply)
from repro_torch.train.data import (SyntheticVision,  # noqa: E402
                                    VisionDataConfig)
from repro_torch.train.loop import make_train_step  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         init_opt_state)


def event_ms(fn, iters: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, top: int, wall_ms: float) -> dict:
    """``torch.profiler`` over one call of ``fn``: device time by kernel
    name, and the device-busy time against ``wall_ms``."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.device_time_total / 1e3)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    return {"device_busy_ms": busy,
            "device_idle_share": max(0.0, 1 - busy / wall_ms) if busy
            else None,
            "device_kernels": len(rows),
            "device_launches": sum(r[1] for r in rows),
            "top_kernels": [{"name": k[:90], "calls": c, "ms": round(ms, 3)}
                            for k, c, ms in rows[:top]]}


def profile_train(cfg, args) -> None:
    """One training step per policy, from the same state each time."""
    params, state = init_spikingformer(
        torch.Generator().manual_seed(args.seed), cfg)
    batch = SyntheticVision(VisionDataConfig(
        image_size=cfg.image_size, num_classes=cfg.num_classes,
        global_batch=args.batch, channels=cfg.in_channels)).batch(0)
    images, labels = (torch.from_numpy(batch[k]).cuda()
                      for k in ("images", "labels"))
    for name in ("cuda-full", "eager"):
        step = make_train_step(cfg.with_policy(named_policy(name)),
                               OptimizerConfig())
        opt = init_opt_state(params)

        def one():
            return step(params, state, opt, images, labels)

        one()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        whole = []
        for _ in range(3):
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            whole.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(whole)
        print(json.dumps({
            "policy": name, "train_step_ms": whole,
            "train_step_ms_median": med,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            **device_profile(one, args.top, med)}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="spikingformer-8-512")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--train", action="store_true",
                    help="profile one training step instead of a forward")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = dataclasses.replace(get_spikingformer_config(args.preset + "@eager"),
                              num_layers=args.depth)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "preset": args.preset, "batch": args.batch,
                      "depth": args.depth, "train": args.train}), flush=True)
    if args.train:
        profile_train(cfg, args)
        return
    eager = SpikingFormer(cfg, seed=args.seed)
    models = {"eager": eager,
              "cuda-full": eager.with_policy(named_policy("cuda-full"))}
    gen = torch.Generator().manual_seed(args.seed + 1)
    images = torch.rand((args.batch, cfg.image_size, cfg.image_size,
                         cfg.in_channels), generator=gen).cuda()
    images_t = images.unsqueeze(0).expand(cfg.time_steps, *images.shape)

    for name, model in models.items():
        mcfg, params, state = model.cfg, model.params, model.state
        model(images)
        torch.cuda.synchronize()
        whole = []
        for _ in range(5):
            t0 = time.perf_counter()
            model(images)
            torch.cuda.synchronize()
            whole.append((time.perf_counter() - t0) * 1e3)
        with torch.no_grad():
            tokens, _ = tokenizer_apply(params["tokenizer"],
                                        state["tokenizer"], images_t, mcfg,
                                        train=False)
            tok_ms = event_ms(lambda: tokenizer_apply(
                params["tokenizer"], state["tokenizer"], images_t, mcfg,
                train=False))
            bp, bs = (_index_tree(t["blocks"], 0) for t in (params, state))
            blk_ms = event_ms(lambda: block_apply(bp, bs, tokens, mcfg.block,
                                                  train=False))
        med = statistics.median(whole)
        print(json.dumps({
            "policy": name, "request_ms": whole, "request_ms_median": med,
            "tokenizer_ms": tok_ms, "one_block_ms": blk_ms,
            **device_profile(lambda: model(images), args.top, med)}),
            flush=True)


if __name__ == "__main__":
    main()
