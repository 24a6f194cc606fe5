#!/usr/bin/env python3
"""The eval-mode neuron layer of one checkout, site by site, in device time.

    python3 benchmarks/torch/bench_eval_kernels.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two checkouts can be compared on one
card in one run: parent, change, change, parent. After the ``device`` line
that names the card and its power limit it prints one JSON line per
neuron-layer site of ``spikingformer-8-512`` at a batch of 16 (spikes at
rate 0.2 or a uniform image, Gaussian weights and bias from seed 0):

- ``call_ms``: ``neuron_layer_eval``'s CUDA-event time per call, host
  included, and ``passes``, the device ms per call of every kernel that one
  call launches (``spike_pack``'s and the kernel's), from
  ``profile_forward.device_profile`` over ``ITERS`` calls;
- ``kernel_ms``: the kernel alone on the packed input, device ms per call,
  for the tile its entry point picks (``rule``) and, where the checkout's
  entry point takes a tile, for ``Large`` and ``Small`` each;
  ``kernel_call_ms`` the same calls' CUDA-event times;
- at the packed sites the yardsticks on the same operands: the device ms of
  ``spike_pack``, of the spike matmul over the T*M rows, and of the
  train-mode neuron layer's passes (its first pass, the same product that
  writes z), and ``bitwise_spike_matmul``: whether the kernel's spikes equal
  those of the spike matmul plus bias through the plain SOMA, bit for bit
  (reported here, held in ``chip_smoke.py``), with the spikes that differ
  from the plain version.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import inspect
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
    # the checkout under test first: chip_smoke's and profile_forward's own
    # ``import repro_torch`` then find this one already imported
    sys.path.insert(0, str(src))
    import repro_torch
    if src not in Path(repro_torch.__file__).resolve().parents:
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}, "
                         f"not from {src}")
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import torch
    from profile_forward import device_profile

    from repro_torch.kernels import build, lif_soma, neuron_layer, \
        spike_matmul

    def device_ms(fn) -> tuple[float, dict[str, float]]:
        """Device ms per call of ``fn``, in all and by kernel."""
        call_ms = cs.time_ms(fn)
        prof = device_profile(lambda: [fn() for _ in range(ITERS)], 10,
                              call_ms * ITERS)
        by = {k["name"]: k["ms"] / ITERS for k in prof["top_kernels"]}
        return sum(by.values()), by

    takes_tile = "tile" in inspect.signature(
        neuron_layer._launch_neuron_layer_eval).parameters
    tiles = {"rule": 0, "Large": 1, "Small": 2} if takes_tile \
        else {"rule": None}

    cs.setup_card()
    build.load()
    gen = torch.Generator(device=cs.DEVICE).manual_seed(0)
    for case, t, m, c, k, packed in cs.neuron_layer_sites(cs.BATCH):
        if packed:
            x = cs.spikes(gen, (t, m, c))
            w = torch.randn((c, k), generator=gen, device=cs.DEVICE) * 2.0 \
                * c ** -0.5
        else:
            x = torch.rand((t, m, c), generator=gen, device=cs.DEVICE)
            w = torch.randn((c, k), generator=gen, device=cs.DEVICE) \
                * c ** -0.5
        bias = torch.randn((k,), generator=gen, device=cs.DEVICE) * 0.1
        xin = spike_matmul.spike_pack(x) if packed else x

        def call():
            return neuron_layer.neuron_layer_eval(x, w, bias, packed=packed)

        row = {"case": case, "shape": [t, m, c, k], "packed": packed,
               "call_ms": cs.time_ms(call), "passes": device_ms(call)[1],
               "kernel_ms": {}, "kernel_call_ms": {}}
        for name, tile in tiles.items():
            kw = {} if tile is None else {"tile": tile}

            def kernel():
                return neuron_layer._launch_neuron_layer_eval(
                    xin, w, bias, t, m, c, k, packed, 0.5, 1.0, **kw)

            row["kernel_ms"][name] = device_ms(kernel)[0]
            row["kernel_call_ms"][name] = cs.time_ms(kernel)
        if packed:
            xp = xin.reshape(t * m, c // 8)
            gamma = torch.ones((k,), device=cs.DEVICE)
            row["spike_pack_ms"] = device_ms(
                lambda: spike_matmul.spike_pack(x))[0]
            row["spike_matmul_ms"] = device_ms(
                lambda: spike_matmul.spike_matmul_packed(xp, w))[0]
            row["train_passes"] = device_ms(
                lambda: neuron_layer.neuron_layer_train(
                    x, w, gamma, bias, packed=True))[1]
            got = call()
            exact = lif_soma.lif_soma_fwd_plain(spike_matmul.spike_matmul_packed(
                xp, w).reshape(t, m, k) + bias)[0]
            plain = neuron_layer.neuron_layer_eval_plain(x, w, bias)
            torch.cuda.synchronize()
            row["bitwise_spike_matmul"] = torch.equal(got, exact)
            row["plain_mismatch"] = int((got != plain).sum())
            row["spike_rate"] = float(got.mean())
            del got, exact, plain
        print(json.dumps({"label": args.label, "src": str(src), **row}),
              flush=True)
        del x, w, xin
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
