"""End-to-end driver of the port: train a ~1M-param Spikingformer with BPTT
on a learnable synthetic vision task for a few hundred steps, with AdamW,
cosine schedule, checkpointing and straggler monitoring.

The task: classify which quadrant of the image carries the brightest
Gaussian blob (the shared ``repro_torch.train.data.SyntheticVision``
stream — loss should fall well below ln(4) chance level within ~100 steps).

Run:  PYTHONPATH=src python examples/torch/train_spikingformer.py \
          [--steps 200] [--device cpu]

The port's twin of ``examples/train_spikingformer.py``. It runs on the
CUDA device unless ``--device cpu`` is given (the kernels' plain PyTorch
versions there), under ``$REPRO_BACKEND`` or ``cuda-full``: the
reference's defaults to ``jnp`` because its Pallas kernels run interpreted
off the TPU, while the port's kernels run natively on the card. The
reference's deprecated ``--spike-mm`` has no counterpart (``--policy
cuda-full`` is what it spelled).

For training data parallel over ranks use the launch driver instead:
``python -m repro_torch.launch.train --arch spikingformer-tiny`` (same
model, same train-step factory, plus ZeRO-3 over "data" and the model
axis).
"""
from __future__ import annotations

import argparse
import math
import os

import torch

from repro_torch.configs.spikingformer import get_spikingformer_config
from repro_torch.core.backend import resolve_device
from repro_torch.core.policy import list_named_policies, named_policy
from repro_torch.core.spikingformer import init_spikingformer
from repro_torch.train.checkpoint import finish_save, save_checkpoint
from repro_torch.train.data import SyntheticVision, VisionDataConfig
from repro_torch.train.loop import make_spikingformer_train_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.resilience import StragglerMonitor


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--policy", choices=list_named_policies(),
                    default=os.environ.get("REPRO_BACKEND", "cuda-full"),
                    help="execution policy: eager (plain PyTorch), cuda "
                         "(the LIF and BN kernels) or cuda-full (adds the "
                         "packed spike matmuls, packed attention and the "
                         "neuron-layer kernel)")
    ap.add_argument("--time-chunk", type=int, default=None,
                    help="temporal tile length for the BPTT scan (memory "
                         "scales with T/time_chunk; gradients are exact)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "PyTorch versions of the kernels")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_spikingformer_config("spikingformer-tiny",
                                   policy=named_policy(args.policy),
                                   time_chunk=args.time_chunk)
    print(f"spikingformer params: {cfg.param_count():,} "
          f"policy={args.policy} time_chunk={cfg.time_chunk} "
          f"device={device}")
    print(cfg.describe_execution())
    params, state = init_spikingformer(torch.Generator().manual_seed(0), cfg,
                                       device)
    opt_cfg = OptimizerConfig(lr=2e-3, warmup_steps=20,
                              total_steps=args.steps, weight_decay=0.01)
    opt_state = init_opt_state(params)
    train_step = make_spikingformer_train_step(cfg, opt_cfg)
    data = SyntheticVision(VisionDataConfig(
        image_size=cfg.image_size, num_classes=cfg.num_classes,
        global_batch=args.batch, channels=cfg.in_channels))
    monitor = StragglerMonitor()

    writer = None
    for step in range(args.steps):
        monitor.step_start()
        batch = data.batch(step)
        images = torch.from_numpy(batch["images"]).to(device)
        labels = torch.from_numpy(batch["labels"]).to(device)
        params, state, opt_state, metrics = train_step(
            params, state, opt_state, images, labels)
        loss = float(metrics["loss"])            # synchronises the step
        monitor.step_end()
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {loss:.4f} "
                  f"acc {float(metrics['accuracy']):.2f} "
                  f"gnorm {float(metrics['grad_norm']):.2f}", flush=True)
        if args.ckpt_dir and (step + 1) % 100 == 0:
            finish_save(writer)
            writer = save_checkpoint(args.ckpt_dir, step + 1,
                                     {"params": params, "bn": state},
                                     async_save=True)
    finish_save(writer)
    print(f"median step time {monitor.median * 1e3:.0f} ms "
          f"(chance loss = {math.log(4):.3f})")


if __name__ == "__main__":
    main()
