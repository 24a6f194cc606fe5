#!/usr/bin/env python3
"""Where one forward of the PyTorch/CUDA port spends its time on the card.

    python3 benchmarks/torch/profile_forward.py [--preset spikingformer-8-512]
        [--batch 16] [--depth 8] [--top 25]

For the ``cuda-full`` and the ``eager`` policy on the same random weights it
prints, as JSON lines: the time of a whole request (host clock around a
synchronised forward, median of 5), the time of the tokenizer alone and of
one block alone (CUDA events), and — from ``torch.profiler`` over one
forward — the device-busy time, its share of the request, and the kernels
that take the most device time. Needs a CUDA device; weights are random
(``--seed``), so only times mean anything here.
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
                                            _index_tree, tokenizer_apply)


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="spikingformer-8-512")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = dataclasses.replace(get_spikingformer_config(args.preset + "@eager"),
                              num_layers=args.depth)
    eager = SpikingFormer(cfg, seed=args.seed)
    models = {"eager": eager,
              "cuda-full": eager.with_policy(named_policy("cuda-full"))}
    gen = torch.Generator().manual_seed(args.seed + 1)
    images = torch.rand((args.batch, cfg.image_size, cfg.image_size,
                         cfg.in_channels), generator=gen).cuda()
    images_t = images.unsqueeze(0).expand(cfg.time_steps, *images.shape)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "preset": args.preset, "batch": args.batch,
                      "depth": args.depth}), flush=True)

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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(images)
            torch.cuda.synchronize()
        rows = [(e.key, e.count, e.device_time_total / 1e3)
                for e in prof.key_averages() if e.device_time_total > 0
                and e.device_type == torch.autograd.DeviceType.CUDA]
        rows.sort(key=lambda r: -r[2])
        busy = sum(r[2] for r in rows)
        med = statistics.median(whole)
        print(json.dumps({
            "policy": name, "request_ms": whole, "request_ms_median": med,
            "tokenizer_ms": tok_ms, "one_block_ms": blk_ms,
            "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1 - busy / med) if busy else None,
            "device_kernels": len(rows),
            "top_kernels": [{"name": k[:90], "calls": c, "ms": round(ms, 3)}
                            for k, c, ms in rows[:args.top]]}), flush=True)


if __name__ == "__main__":
    main()
