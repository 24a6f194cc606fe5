"""Roofline aggregation: read the dry-run JSON cells and emit the roofline
table (three terms per cell, dominant bound, peak, useful-flops ratio,
one-line lever note) on the H100 (the counterpart of
``repro.launch.roofline``).

  PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh data16] [--md]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

LEVERS = {
    ("compute",): "raise tensor-core use: bf16 products, a larger "
                  "microbatch a card, fuse small products",
    ("memory",): "cut HBM traffic: flash attention, fused elementwise "
                 "code, in-place (donated) updates, a CUDA graph of the "
                 "small launches",
    ("collective",): "reshard: fewer model-axis gathers, overlap the "
                     "gathers and reductions with compute, compress grads",
}


def load_cells(mesh_name: str) -> list[dict]:
    base = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                        "..", "..", "experiments", "torch",
                                        "dryrun", mesh_name))
    return [json.load(open(f))
            for f in sorted(glob.glob(os.path.join(base, "*.json")))]


def fmt_row(r: dict, md: bool) -> str:
    rl = r["roofline"]
    peak = (r["bytes_per_device"]["peak"] or 0) / 1e9
    ratio = r["useful_flops_ratio"]
    cells = [r["arch"], r["shape"],
             f"{rl['compute_s']:.3e}", f"{rl['memory_s']:.3e}",
             f"{rl['collective_s']:.3e}", rl["bound"],
             f"{peak:.2f}", f"{ratio:.2f}" if ratio else "-"]
    sep = " | " if md else ","
    return ("| " if md else "") + sep.join(cells) + (" |" if md else "")


def main(argv=None) -> None:
    from repro_torch.launch.dryrun import (HBM_BW, IB_BW, ICI_BW, NODE_GPUS,
                                           PEAK_FLOPS, PEAK_FLOPS_FP32)
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="data16")
    ap.add_argument("--md", action="store_true")
    args = ap.parse_args(argv)
    cells = load_cells(args.mesh)
    header = ["arch", "shape", "compute_s", "memory_s", "collective_s",
              "bound", "peak_GB", "useful_ratio"]
    if args.md:
        print("| " + " | ".join(header) + " |")
        print("|" + "---|" * len(header))
    else:
        print(",".join(header))
    for r in cells:
        print(fmt_row(r, args.md))
    bounds = {}
    for r in cells:
        bounds[r["roofline"]["bound"]] = bounds.get(
            r["roofline"]["bound"], 0) + 1
    print(f"\n# {len(cells)} cells on {args.mesh}; dominant bounds: {bounds}")
    print(f"# NVIDIA H100 SXM: {PEAK_FLOPS / 1e12:.0f} TFLOP/s dense bf16, "
          f"{PEAK_FLOPS_FP32 / 1e12:.0f} fp32, {HBM_BW / 1e12:.2f} TB/s "
          f"HBM, {ICI_BW / 1e9:.0f} GB/s NVLink within {NODE_GPUS} GPUs, "
          f"{IB_BW / 1e9:.0f} GB/s beyond")
    for k, v in LEVERS.items():
        print(f"# lever[{k[0]}]: {v}")


if __name__ == "__main__":
    main()
