#!/usr/bin/env python3
"""The spike matmul cases of ``chip_smoke.py`` for one checkout's kernel.

    python3 benchmarks/torch/bench_spike_matmul.py [--src DIR] [--label NAME]
        [--bf16] [--diagnose]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two checkouts can be compared on one
card in one session: parent, change, change, parent. The cases, their
checks, times, bounds and errors against an fp64 product are
``chip_smoke.spike_matmul_cases`` at seed 0 and the preset's batch (with
``--bf16``: ``chip_smoke.bf16_matmul_cases``, the bf16 arm's sites, each
row naming the plan kernel the rule launched and, where that is the wgmma
kernel, the one-plane mainloop forced beside it); each prints as one JSON
line with ``label``, after the ``device`` line that names the card and its
power limit. ``--diagnose`` prints instead the bf16 Small tile (tile 2
forced) at ``attn_qk`` for G = 64, 128, 256 and 512 per-head products
(``diagnose_rows``), beside a device ``copy_`` that moves as many bytes,
a store-only ``zero_`` of the output's bytes, and the Small tile on an
unpadded 256 x 64 x 256 product and on a unit-stride weight, all L2
cold. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def diagnose_rows(chip_smoke, gen) -> list[dict]:
    """The Small tile's time at ``attn_qk`` against the traffic it must
    move, to tell its causes apart: its scaling with G, a copy of the same
    bytes and a store of the output's, no padding (256 x 64 x 256) and a
    weight read along its unit stride (n-major) instead of the K^T view."""
    import torch

    sm, bf16 = chip_smoke.spike_matmul, torch.bfloat16
    dev = chip_smoke.DEVICE
    cfg = chip_smoke.get_spikingformer_config(chip_smoke.PRESET)
    t, d, h, n = cfg.time_steps, cfg.d_model, cfg.n_heads, cfg.num_tokens
    dh = d // h
    rows = []

    def row(case, call, operands, moved, **extra):
        times = chip_smoke.cold_warm(call, operands, moved)
        b_ms = moved / chip_smoke.HBM_BYTES_PER_S * 1e3
        rows.append({"case": case, "moved_bytes": moved, "bound_ms": b_ms,
                     **times, "bound_share": b_ms / times["device_ms"],
                     "achieved_gb_s": moved / times["device_ms"] / 1e6,
                     **extra})

    small = lambda p, w: sm.spike_matmul_packed_batched(p, w, tile=2)
    for tb in (t * 2, t * 4, t * 8, t * 16):      # G = 8 tb: 64 .. 512
        q = chip_smoke.spikes(gen, (tb, n, d))
        k = chip_smoke.spikes(gen, (tb, n, d)).to(bf16)
        packed = sm.spike_pack(q.view(tb, n, h, dh).permute(0, 2, 1, 3))
        w = k.view(tb, n, h, dh).permute(0, 2, 1, 3).transpose(-1, -2)
        out_bytes = tb * h * n * n * 2
        moved = chip_smoke.nbytes(packed, w) + out_bytes
        row(f"Small tile, attn_qk G={tb * h}", small, (packed, w), moved,
            shape=[tb, h, n, dh, n])
        if tb == t * 16:
            src = torch.zeros(moved // 4, dtype=bf16, device=dev)
            dst = torch.empty_like(src)
            row("copy_ of the same bytes (half read, half written)",
                lambda a, b: a.copy_(b), (dst, src), 2 * src.numel() * 2)
            out = torch.empty(out_bytes // 2, dtype=bf16, device=dev)
            row("zero_ of the output's bytes (store only)",
                lambda a: a.zero_(), (out,), out_bytes)
            wn = w.contiguous()
            row(f"Small tile, G={tb * h}, unit-stride weight", small,
                (packed, wn), moved, w_stride=list(wn.stride()))
            p256 = sm.spike_pack(chip_smoke.spikes(gen, (tb, h, 256, dh)))
            w256 = chip_smoke.spikes(gen, (tb, h, 256, dh)).to(
                bf16).transpose(-1, -2)
            row(f"Small tile, G={tb * h}, 256 x 64 x 256 (no padding)",
                small, (p256, w256),
                chip_smoke.nbytes(p256, w256) + tb * h * 256 * 256 * 2)
            del src, dst, out
        del q, k, packed, w
        torch.cuda.empty_cache()
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--bf16", action="store_true",
                    help="the bf16 cases (chip_smoke.bf16_matmul_cases)")
    ap.add_argument("--diagnose", action="store_true",
                    help="the Small tile's diagnosis at attn_qk "
                         "(diagnose_rows)")
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
    if args.diagnose:
        cases = [diagnose_rows(chip_smoke, gen)]
    elif args.bf16:
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
