#!/usr/bin/env python3
"""``test_one_training_step_on_the_card`` many times in one process.

    python3 benchmarks/torch/repeat_train_step.py [--runs 20] [--out DIR]

Each run calls the test function of ``tests/test_torch_cuda.py`` as pytest
would, so its images come from the device's default generator, unseeded,
and each run gets other images. Beside the test's verdict, the same step
is replayed from the same generator state (so on the same images): the
``cuda-full`` loss against the ``eager`` loss (the test holds them within
1e-3), and every kernel call of the ``cuda-full`` step judged against its
oracle on its own operands (``chip_smoke.SiteWalk``: a neuron layer's
spikes must be the oracle's outside the band around the threshold that the
product's and the statistics' tolerances give, ``analysis.contracts.
spike_verdict``). One JSON line per run; a failing run's images are saved
under ``--out`` (``torch.save``). The last line counts the runs that
failed. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests"), str(ROOT)]

import torch  # noqa: E402


def step_losses(images, labels, walk_cls) -> dict:
    """The test's step from its own initial state under ``cuda-full``
    (inside a ``SiteWalk``) and ``eager`` on ``images``."""
    from repro_torch.configs import get_spikingformer_config
    from repro_torch.core.policy import named_policy
    from repro_torch.core.spikingformer import init_spikingformer
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    cfg = get_spikingformer_config("spikingformer-smoke@cuda-full")
    params, state = init_spikingformer(torch.Generator().manual_seed(0), cfg,
                                       images.device)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for name in ("cuda-full", "eager"):
            step = make_train_step(cfg.with_policy(named_policy(name)),
                                   OptimizerConfig())
            walk = walk_cls()
            with walk if name == "cuda-full" else contextlib.nullcontext():
                *_, metrics = step(params, state, init_opt_state(params),
                                   images, labels)
            torch.cuda.synchronize()
            out[name] = float(metrics["loss"])
            if name == "cuda-full":
                out["site_walk"] = walk.rows
                out["site_walk_bad"] = walk.bad
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "repeat_train_step"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("repeat_train_step: no CUDA device")
    import chip_smoke as cs
    import test_torch_cuda as tc
    cs.setup_card()
    dev = torch.device("cuda")
    labels = torch.tensor([0, 1, 2, 3], device=dev)
    failed = 0
    for run in range(args.runs):
        rng = torch.cuda.get_rng_state()
        row = {"run": run}
        try:
            tc.test_one_training_step_on_the_card()
            row["test"] = "passed"
        except AssertionError:
            row["test"] = "failed"
            row["error"] = traceback.format_exc(limit=1).splitlines()[-1]
        after = torch.cuda.get_rng_state()
        torch.cuda.set_rng_state(rng)
        images = torch.rand(4, 32, 32, 3, device=dev)   # the test's draw
        losses = step_losses(images, labels, cs.SiteWalk)
        torch.cuda.set_rng_state(after)
        row.update(loss_cuda_full=losses["cuda-full"],
                   loss_eager=losses["eager"],
                   loss_gap=abs(losses["cuda-full"] - losses["eager"]),
                   site_walk_bad=losses["site_walk_bad"],
                   neuron_layer_train=losses["site_walk"].get(
                       "neuron_layer_train_fwd"))
        if row["test"] == "failed":
            failed += 1
            out = Path(args.out)
            out.mkdir(parents=True, exist_ok=True)
            torch.save(images.cpu(), out / f"images_run{run}.pt")
            row["images"] = str(out / f"images_run{run}.pt")
        print(json.dumps(row), flush=True)
    print(json.dumps({"runs": args.runs, "failed": failed}), flush=True)


if __name__ == "__main__":
    main()
