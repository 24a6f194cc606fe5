#!/usr/bin/env python3
"""Where the spiking LM's forward, one serving step and one training step
spend their time on the card.

    python3 benchmarks/torch/profile_lm.py [--arch qwen3-0.6b] [--layers 28]
        [--seq 256] [--slots 8] [--max-seq 256] [--steps 10] [--top 20]
    python3 benchmarks/torch/profile_lm.py --arch deepseek-v2-236b --layers 2
    python3 benchmarks/torch/profile_lm.py --train [--batch 8] [--seq 128]

For the ``cuda-full`` and the ``eager`` policy on the same random weights
(fp32, the LIF on every FFN branch) it prints, as JSON lines: ``lm_forward``
+ unembedding of one (1, ``--seq``) token batch (host clock around a
synchronised call, median of 3) and, from ``torch.profiler`` over one call,
the device-busy time, its share of the call, the launches and the kernels
that take the most device time; then the same for one step of a
``ServingEngine`` with every slot busy (``--slots`` requests of 32 prompt
tokens, timed over ``--steps`` synchronised steps after a warm-up), with
the fused step alone timed by CUDA events. Any dense or moe config of the
registry runs at its published widths (``--layers`` cuts the depth:
``deepseek-v2-236b`` fits the card at 2 of its 60 layers, 33.9 GB in
fp32). With ``--train``, instead: one
``make_train_step`` step (AdamW, the layers recomputed in the backward as
the registry's ``remat`` says) on a (``--batch``, ``--seq``) ``SyntheticLM``
batch, timed over ``--steps`` synchronised steps from the same state after
a warm-up, its peak memory, and the same profile of one step. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from profile_forward import device_profile, event_ms  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.lif import LIFConfig  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.models.common import split_tree, unembed  # noqa: E402
from repro_torch.models.lm import init_lm, lm_forward  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.train.loop import make_train_step  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         init_opt_state)


def host_ms(fn, n: int) -> list[float]:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def profile_train(base, params, args) -> None:
    """One training step per policy, from the same state each time."""
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(
        DataConfig(vocab_size=base.vocab_size, seq_len=args.seq,
                   global_batch=args.batch, seed=args.seed)).batch(0).items()}
    opt = init_opt_state(params)
    for name in ("cuda-full", "eager"):
        step = make_train_step(
            base.replace(lif=LIFConfig(policy=named_policy(name))),
            OptimizerConfig())

        def one():
            return step(params, opt, batch)
        one()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        whole = host_ms(one, args.steps)
        med = statistics.median(whole)
        print(json.dumps({"policy": name, "path": "lm_train_step",
                          "ms": whole, "ms_median": med,
                          "tokens_per_s": args.batch * args.seq / med * 1e3,
                          "peak_memory_bytes":
                              torch.cuda.max_memory_allocated(),
                          **device_profile(one, args.top, med)}),
              flush=True)
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth (0: the published depth)")
    ap.add_argument("--seq", type=int, default=None,
                    help="tokens a row (default 256; 128 with --train)")
    ap.add_argument("--batch", type=int, default=8,
                    help="rows of the training batch (--train)")
    ap.add_argument("--train", action="store_true",
                    help="profile one training step instead")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=None,
                    help="timed steps (default 10; 3 with --train)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    args.seq = args.seq or (128 if args.train else 256)
    args.steps = args.steps or (3 if args.train else 10)
    if not torch.cuda.is_available():
        raise SystemExit("profile_lm: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    base = get_config(args.arch).replace(dtype=torch.float32)
    if args.layers:
        base = base.replace(num_layers=args.layers)
    params = split_tree(init_lm(
        torch.Generator(device="cuda").manual_seed(args.seed), base))[0]
    rng = np.random.default_rng(args.seed)
    toks = torch.from_numpy(rng.integers(0, base.vocab_size, (1, args.seq))
                            ).cuda()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "arch": args.arch, "layers": base.num_layers,
                      "seq": args.seq, "slots": args.slots,
                      "max_seq": args.max_seq, "train": args.train,
                      "batch": args.batch, "remat": base.remat}),
          flush=True)
    if args.train:
        profile_train(base, params, args)
        return
    for name in ("cuda-full", "eager"):
        cfg = base.replace(lif=LIFConfig(policy=named_policy(name)))

        def forward():
            with torch.inference_mode():
                h, _ = lm_forward(params, {"tokens": toks}, cfg)
                return unembed(params["embed"], h)
        forward()
        torch.cuda.synchronize()
        whole = host_ms(forward, 3)
        med = statistics.median(whole)
        print(json.dumps({"policy": name, "path": "lm_forward",
                          "ms": whole, "ms_median": med,
                          **device_profile(forward, args.top, med)}),
              flush=True)

        engine = ServingEngine(params, cfg, slots=args.slots,
                               max_seq=args.max_seq)
        for uid in range(args.slots):
            engine.submit(Request(uid=uid, prompt=rng.integers(
                0, base.vocab_size, 32).tolist(), max_new_tokens=64))
        for _ in range(4):                   # admit, prefill a little
            engine.step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps = host_ms(engine.step, args.steps)
        med = statistics.median(steps)
        inputs = (torch.tensor(engine._next_tok, device="cuda"),
                  torch.tensor(engine._pos, device="cuda"),
                  torch.zeros(args.slots, dtype=torch.bool, device="cuda"))
        fused_ms = event_ms(lambda: engine._step(engine.params, engine.cache,
                                                 *inputs))
        print(json.dumps({"policy": name, "path": "decode_step",
                          "ms": steps, "ms_median": med,
                          "fused_step_event_ms": fused_ms,
                          "peak_memory_bytes":
                              torch.cuda.max_memory_allocated(),
                          **device_profile(engine.step, args.top, med)}),
              flush=True)
        del engine
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
