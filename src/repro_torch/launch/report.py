"""Render the dry-run and perf sections from the JSON the port's dry run
writes under ``experiments/torch/`` (the counterpart of
``repro.launch.report``). "compile s" is the seconds of the counted run on
``meta`` tensors (``compile_s``), the port's stand-in for XLA's compile.

  PYTHONPATH=src python -m repro_torch.launch.report > /tmp/sections.md
"""
from __future__ import annotations

import glob
import json
import os

BASE = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    "..", "experiments", "torch"))
SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
               "long_500k": 3}


def cells(mesh: str) -> list[dict]:
    out = [json.load(open(f)) for f in
           glob.glob(os.path.join(BASE, "dryrun", mesh, "*.json"))]
    return sorted(out, key=lambda r: (r["arch"], SHAPE_ORDER[r["shape"]]))


def dryrun_section() -> str:
    lines = ["## §Dry-run", ""]
    for mesh, title in (("data16", "Data 16 (16 x H100, model axis 1)"),
                        ("pod2xdata16",
                         "Two pods (2 x 16 = 32 x H100, model axis 1)")):
        rows = cells(mesh)
        fit = sum(bool(r.get("fits")) for r in rows)
        lines += [f"### {title} — {len(rows)} cells, {fit} fit in 80 GB",
                  "", "| arch | shape | peak GB/dev | args GB | compile s | "
                  "dominant collective |", "|---|---|---|---|---|---|"]
        for r in rows:
            b = r["bytes_per_device"]
            coll = r["collective_bytes_per_device"]
            dom = max(coll, key=coll.get) if coll else "-"
            dom_s = f"{dom} ({coll[dom] / 1e9:.1f} GB)" if coll else "-"
            lines.append(
                f"| {r['arch']} | {r['shape']} | "
                f"{(b['peak'] or 0) / 1e9:.2f} | "
                f"{(b['argument'] or 0) / 1e9:.2f} | {r['compile_s']} | "
                f"{dom_s} |")
        lines.append("")
    return "\n".join(lines)


def roofline_section() -> str:
    from repro_torch.launch.dryrun import (HBM_BW, IB_BW, PEAK_FLOPS,
                                           PEAK_FLOPS_FP32)
    rows = cells("data16")
    lines = [f"## §Roofline (data 16, NVIDIA H100 SXM: "
             f"{PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, "
             f"{PEAK_FLOPS_FP32 / 1e12:.0f} fp32, "
             f"{HBM_BW / 1e9:.0f} GB/s HBM, {IB_BW / 1e9:.0f} GB/s a GPU "
             f"between nodes)", "",
             "| arch | shape | compute s | memory s | collective s | bound |"
             " useful ratio | lever |", "|---|---|---|---|---|---|---|---|"]
    lever = {
        "compute": "more useful flops a byte: bf16, batch, fusion",
        "memory": "cut HBM traffic: flash attention, fusion, donation, "
                  "CUDA graphs",
        "collective": "overlapped collectives, fewer reshards",
    }
    for r in rows:
        rl = r["roofline"]
        ratio = r["useful_flops_ratio"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.2e} | "
            f"{rl['memory_s']:.2e} | {rl['collective_s']:.2e} | "
            f"**{rl['bound']}** | "
            f"{ratio:.2f} | {lever[rl['bound']]} |")
    bounds: dict[str, int] = {}
    for r in rows:
        bounds[r["roofline"]["bound"]] = bounds.get(
            r["roofline"]["bound"], 0) + 1
    lines += ["", f"Bound distribution: {bounds}."]
    return "\n".join(lines)


def perf_section() -> str:
    lines = ["## §Perf raw variant measurements", ""]
    for f in sorted(glob.glob(os.path.join(BASE, "perf", "*.json"))):
        name = os.path.basename(f)[:-5]
        data = json.load(open(f))
        lines += [f"### {name}", "",
                  "| variant | compute s | memory s | collective s | "
                  "peak GB |", "|---|---|---|---|---|"]
        for var, m in data.items():
            peak = (m.get("peak_bytes") or 0) / 1e9
            lines.append(f"| {var} | {m['compute_s']:.3e} | "
                         f"{m['memory_s']:.3e} | {m['collective_s']:.3e} | "
                         f"{peak:.2f} |")
        lines.append("")
    return "\n".join(lines)


def main() -> None:
    print(dryrun_section())
    print()
    print(roofline_section())
    print()
    print(perf_section())


if __name__ == "__main__":
    main()
