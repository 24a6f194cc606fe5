"""Quickstart of the PyTorch/CUDA port: its three layers in ~80 lines.

1. Simulate the E2ATST accelerator on the Spikingformer training workload
   (the paper's core contribution) and find the optimal dataflow.
2. Train a tiny Spikingformer for a few BPTT steps on random images.
3. Run one of the assigned LM architectures (reduced) through a train step
   and a decode step.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

The port's twin of ``examples/quickstart.py``. It runs on the CUDA device
unless ``--device cpu`` is given (the kernels' plain PyTorch versions), and
the Spikingformer under ``$REPRO_BACKEND`` or ``cuda-full``: the
reference's runs under ``jnp`` unless told otherwise, because its Pallas
kernels run interpreted off the TPU; the port's kernels run natively on the
card.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.configs.registry import get_config, reduced
from repro_torch.core.backend import resolve_device
from repro_torch.core.energy import E2ATSTSimulator
from repro_torch.core.policy import list_named_policies, named_policy
from repro_torch.core.spikingformer import (SpikingFormerConfig,
                                            init_spikingformer,
                                            spikingformer_grad_step,
                                            tree_map)
from repro_torch.models.common import split_tree
from repro_torch.models.lm import (init_cache, init_lm, lm_decode_step,
                                   lm_loss)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "PyTorch versions of the kernels")
    ap.add_argument("--policy", choices=list_named_policies(),
                    default=os.environ.get("REPRO_BACKEND", "cuda-full"),
                    help="the Spikingformer's execution policy")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. the E2ATST simulator --------------------------------------------
    sim = E2ATSTSimulator()
    best = sim.optimal(metric="energy")
    m = sim.table_ix()
    print(f"[sim] optimal dataflow: {best.dataflow}  "
          f"energy={best.energy_j * 1e3:.0f} mJ/step  "
          f"latency={best.latency_s * 1e3:.0f} ms/step")
    print(f"[sim] Table IX: {m['eff_tflops']:.2f} TFLOPS @ "
          f"{m['power_w']:.2f} W => {m['tflops_per_w']:.2f} TFLOPS/W "
          f"(util {m['mac_utilization']:.0%})")

    # --- 2. Spikingformer BPTT ----------------------------------------------
    cfg = SpikingFormerConfig(num_layers=2, d_model=64, n_heads=2, d_ff=128,
                              time_steps=2, image_size=32, patch_grid=8,
                              num_classes=10,
                              policy=named_policy(args.policy))
    params, state = init_spikingformer(torch.Generator().manual_seed(0), cfg,
                                       device)
    gen = torch.Generator().manual_seed(1)
    imgs = torch.rand((8, 32, 32, 3), generator=gen).to(device)
    labels = (torch.arange(8) % 10).to(device)
    for step in range(5):
        grads, state, metrics = spikingformer_grad_step(params, state, imgs,
                                                        labels, cfg)
        params = tree_map(lambda p, g: p - 5e-2 * g, params, grads)
        print(f"[snn] step {step} loss {float(metrics['loss']):.4f}")

    # --- 3. an assigned architecture -----------------------------------------
    acfg = reduced(get_config("qwen3-0.6b"))
    lm_params = split_tree(init_lm(torch.Generator().manual_seed(2), acfg,
                                   device))[0]
    gen = torch.Generator().manual_seed(3)
    batch = {k: torch.randint(0, acfg.vocab_size, (2, 16),
                              generator=gen).to(device)
             for k in ("tokens", "labels")}
    with torch.no_grad():
        loss, _ = lm_loss(lm_params, batch, acfg)
        print(f"[lm ] qwen3-0.6b (reduced) train loss {float(loss):.4f}")
        cache = init_cache(acfg, 2, 32, dtype=torch.float32, device=device)
        logits, cache = lm_decode_step(
            lm_params, cache, batch["tokens"][:, :1],
            torch.zeros((2,), dtype=torch.int32, device=device), acfg)
    print(f"[lm ] decode logits {tuple(logits.shape)} — quickstart OK")


if __name__ == "__main__":
    main()
