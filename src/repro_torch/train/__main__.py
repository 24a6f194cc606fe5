"""Train a Spikingformer with BPTT on the synthetic quadrant task.

    python -m repro_torch.train [--preset spikingformer-tiny] [--steps 200]
        [--batch 16] [--policy cuda-full] [--time-chunk N] [--device cpu]

The port's counterpart of ``examples/train_spikingformer.py``: AdamW with a
warm-up + cosine schedule, the ``SyntheticVision`` stream (loss falls well
below ln(4), chance, within about 100 steps at ``spikingformer-tiny``). It
runs on the CUDA device unless ``--device cpu`` is given, and raises where
there is none.
"""
from __future__ import annotations

import argparse
import math
import os
import statistics
import time

import torch

from repro_torch.configs import get_spikingformer_config, \
    list_spikingformer_configs
from repro_torch.core.backend import resolve_device
from repro_torch.core.policy import list_named_policies, named_policy
from repro_torch.core.spikingformer import init_spikingformer
from repro_torch.train.data import SyntheticVision, VisionDataConfig
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="spikingformer-tiny",
                    choices=list_spikingformer_configs())
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--policy", choices=list_named_policies(),
                    default=os.environ.get("REPRO_BACKEND", "cuda-full"),
                    help="execution policy: eager (plain PyTorch), cuda (the "
                         "LIF and BN kernels) or cuda-full (adds the packed "
                         "spike matmuls, packed attention and the "
                         "neuron-layer kernel)")
    ap.add_argument("--time-chunk", type=int, default=None,
                    help="temporal tile length of the BPTT scan")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "PyTorch versions of the kernels")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_spikingformer_config(args.preset,
                                   policy=named_policy(args.policy),
                                   time_chunk=args.time_chunk)
    print(f"spikingformer params: {cfg.param_count():,} preset={args.preset} "
          f"policy={args.policy} time_chunk={cfg.time_chunk} device={device}")
    print(cfg.describe_execution())
    params, state = init_spikingformer(
        torch.Generator().manual_seed(args.seed), cfg, device)
    opt_cfg = OptimizerConfig(lr=2e-3, warmup_steps=20,
                              total_steps=args.steps, weight_decay=0.01)
    opt_state = init_opt_state(params)
    train_step = make_train_step(cfg, opt_cfg)
    data = SyntheticVision(VisionDataConfig(
        image_size=cfg.image_size, num_classes=cfg.num_classes,
        global_batch=args.batch, channels=cfg.in_channels,
        spikes=cfg.spike_input))

    times = []
    for step in range(args.steps):
        batch = data.batch(step)
        images = torch.from_numpy(batch["images"]).to(device)
        labels = torch.from_numpy(batch["labels"]).to(device)
        t0 = time.perf_counter()
        params, state, opt_state, metrics = train_step(
            params, state, opt_state, images, labels)
        loss = float(metrics["loss"])            # synchronises the step
        times.append(time.perf_counter() - t0)
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {loss:.4f} "
                  f"acc {float(metrics['accuracy']):.2f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"nonfinite {float(metrics['nonfinite']):.0f}", flush=True)
    print(f"median step time {statistics.median(times) * 1e3:.0f} ms "
          f"(chance loss = {math.log(4):.3f})")


if __name__ == "__main__":
    main()
