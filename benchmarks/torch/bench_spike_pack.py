#!/usr/bin/env python3
"""The spike pack of one checkout at the shapes of the main path's packed
calls, in device time.

    python3 benchmarks/torch/bench_spike_pack.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two checkouts can be compared on one
card in one run: parent, change, change, parent. After the ``device`` line
that names the card and its power limit it prints one JSON line per
packed call of the ``spikingformer-8-512`` forward at a batch of 16
(``chip_smoke.pack_inputs``: spikes at rate 0.2 from seed 0, each in the
layout the model hands ``spike_matmul.spike_pack``) in fp32 and then bf16:

- ``device_ms``: ``spike_pack``'s device ms per call, ten calls back to
  back behind a held stream with the L2 cold (each call on the next of
  copies of its operand that span four L2s, ``chip_smoke.cold_warm``), and
  ``device_ms_l2_warm``, the same operand every call;
- ``kernels``: the device ms per call of every kernel one call launches
  (``torch.profiler`` over ``ITERS`` calls, warm), so that a checkout that
  packs with several ATen launches shows each;
- ``host_us``: the host's microseconds to enqueue one call
  (``chip_smoke.host_us``);
- ``bound_ms``: the spikes read once in their dtype and one byte written
  per eight, over 3.35 TB/s;
- ``digest``: the SHA-256 prefix of the packed bytes (two checkouts that
  pack alike print the same digests).

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: Calls per ``torch.profiler`` window.
ITERS = 20


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    # the checkout under test first: chip_smoke's own ``import
    # repro_torch`` then finds this one already imported
    sys.path.insert(0, str(src))
    import repro_torch
    if src not in Path(repro_torch.__file__).resolve().parents:
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}, "
                         f"not from {src}")
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import torch
    from profile_forward import device_profile

    from repro_torch.kernels import build, spike_matmul

    cs.setup_card()
    build.load()
    pack = spike_matmul.spike_pack
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=cs.DEVICE).manual_seed(0)
        for case, x in cs.pack_inputs(gen, cs.BATCH, dtype):
            out = pack(x)
            moved = cs.nbytes(x, out)
            call_ms = cs.time_ms(lambda: pack(x))
            prof = device_profile(lambda: [pack(x) for _ in range(ITERS)],
                                  10, call_ms * ITERS)
            row = {"label": args.label, "src": str(src), "case": case,
                   "dtype": str(dtype).removeprefix("torch."),
                   "shape": list(x.shape), "stride": list(x.stride()),
                   **cs.cold_warm(pack, (x,), moved),
                   "kernels": {k["name"]: k["ms"] / ITERS
                               for k in prof["top_kernels"]},
                   "host_us": cs.host_us(lambda: pack(x)),
                   "call_ms": call_ms,
                   "bound_ms": moved / cs.HBM_BYTES_PER_S * 1e3,
                   "digest": cs.digest(out)}
            print(json.dumps(row), flush=True)
            del x, out
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
