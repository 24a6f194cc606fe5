#!/usr/bin/env python3
"""The spike matmul cases of ``chip_smoke.py`` for one checkout's kernel.

    python3 benchmarks/torch/bench_spike_matmul.py [--src DIR] [--label NAME]
        [--bf16]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two checkouts can be compared on one
card in one session: parent, change, change, parent. The cases, their
checks, times, bounds and errors against an fp64 product are
``chip_smoke.spike_matmul_cases`` at seed 0 and the preset's batch (with
``--bf16``: ``chip_smoke.bf16_matmul_cases``, the bf16 arm's sites, each
row naming the plan kernel the rule launched and, where that is the wgmma
kernel, the one-plane mainloop forced beside it); each prints as one JSON
line with ``label``, after the ``device`` line that names the card and its
power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--bf16", action="store_true",
                    help="the bf16 cases (chip_smoke.bf16_matmul_cases)")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    # the checkout under test first: chip_smoke's own ``import repro_torch``
    # then finds this one already imported
    sys.path.insert(0, str(src))
    import repro_torch
    if src not in Path(repro_torch.__file__).resolve().parents:
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}, "
                         f"not from {src}")
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    import torch

    chip_smoke.setup_card()
    chip_smoke.build.load()
    gen = torch.Generator(device=chip_smoke.DEVICE).manual_seed(0)
    if args.bf16:
        sm = chip_smoke.spike_matmul
        cases = chip_smoke.bf16_matmul_cases(
            gen, chip_smoke.BATCH, require_wgmma=hasattr(sm, "WGMMA")).values()
    else:
        cases = chip_smoke.spike_matmul_cases(gen, chip_smoke.BATCH)
    for rows in cases:
        for row in rows:
            print(json.dumps({"label": args.label, "src": str(src), **row}),
                  flush=True)


if __name__ == "__main__":
    main()
