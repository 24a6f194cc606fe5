#!/usr/bin/env python3
"""The eval-mode neuron layer of one checkout, site by site, in device time.

    python3 benchmarks/torch/bench_eval_kernels.py [--src DIR] [--label NAME]
        [--bf16]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two checkouts can be compared on one
card in one run: parent, change, change, parent. After the ``device`` line
that names the card and its power limit it prints one JSON line per
neuron-layer site of ``spikingformer-8-512`` at a batch of 16 (spikes at
rate 0.2 or a uniform image, Gaussian weights and bias from seed 0; with
``--bf16`` the input and the weight in bf16, the bias fp32):

- ``call_ms``: ``neuron_layer_eval``'s CUDA-event time per call, host
  included, ``call_device_ms`` its device ms per call with the L2 cold and
  warm (``chip_smoke.cold_warm``), and ``passes``, the device ms per call
  of every kernel that one call launches (``spike_pack``'s and the
  kernel's), from ``profile_forward.device_profile`` over ``ITERS`` calls;
- ``kernel_ms``: the kernel alone on the packed input, device ms per call,
  for the tile the wrapper asks for (``rule``: ``neuron_layer.eval_kernel``
  where the checkout has it, else the entry point's own pick) and, where
  the checkout's entry point takes a tile, for ``Large`` and ``Small``
  each; ``kernel_call_ms`` the same calls' CUDA-event times,
  ``kernel_device_ms`` their device ms cold and warm, ``rule_tile`` the
  tile code of ``rule`` and ``bound_ms`` the kernel's bound (the packed
  rows, the weight, the bias and the spikes once over 3.35 TB/s, or 2 T*M*C*K
  over 989 TFLOP/s at bf16 and 67 at fp32);
- at the packed sites the yardsticks on the same operands: the device ms of
  ``spike_pack``, of the spike matmul over the T*M rows, and of the
  train-mode neuron layer's passes (its first pass, the same product that
  writes z); at fp32 ``bitwise_spike_matmul``: whether the kernel's spikes
  equal those of the spike matmul plus bias through the plain SOMA, bit for
  bit, at bf16 ``bitwise_z_pass``: the same through the fp32 z of the
  train arm's first pass (the spike matmul rounds to bf16) (reported here,
  held in ``chip_smoke.py``), with the spikes that differ from the plain
  version; at bf16 also the unfused path's device ms, cold and warm
  (``chip_smoke.unfused_yardstick``: cuBLAS's bf16 GEMM with an fp32
  result on the unpacked spikes, the bf16 LIF on a (T, M, K) current, and
  ``yardstick_device_ms``, their cold sum), and ``digests``, the
  SHA-256 prefixes of the spike matmul's output and of the z pass's z on
  these operands (two checkouts whose kernels give the same bits print the
  same digests).

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
    ap.add_argument("--bf16", action="store_true",
                    help="the input and the weight in bf16")
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
    # the wrapper's rule where the checkout has one, else the entry point's
    rule = getattr(neuron_layer, "eval_kernel", lambda m, w: 0)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

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
        x, w = x.to(dtype), w.to(dtype)
        xin = spike_matmul.spike_pack(x) if packed else x
        rule_tile = rule(m, w) if packed else 0
        tiles = {"rule": rule_tile, "Large": 1, "Small": 2} if takes_tile \
            else {"rule": None}

        def call(x, w, bias):
            return neuron_layer.neuron_layer_eval(x, w, bias, packed=packed)

        moved = cs.nbytes(xin, w, bias) + t * m * k * x.element_size()
        b_ms = moved / cs.HBM_BYTES_PER_S * 1e3
        o_ms = 2.0 * t * m * c * k / (
            cs.BF16_FLOPS if args.bf16 else cs.FP32_FLOPS) * 1e3
        row = {"case": case, "shape": [t, m, c, k], "packed": packed,
               "dtype": str(dtype), "rule_tile": rule_tile,
               "bound_ms": max(b_ms, o_ms),
               "bound_by": "bytes" if b_ms >= o_ms else "operations",
               "call_ms": cs.time_ms(lambda: call(x, w, bias)),
               "call_device_ms": cs.cold_warm(
                   call, (x, w, bias), cs.nbytes(x, w, bias) + moved),
               "passes": device_ms(lambda: call(x, w, bias))[1],
               "kernel_ms": {}, "kernel_call_ms": {}, "kernel_device_ms": {}}
        for name, tile in tiles.items():
            kw = {} if tile is None else {"tile": tile}

            def kernel(xin, w, bias, kw=kw):
                return neuron_layer._launch_neuron_layer_eval(
                    xin, w, bias, t, m, c, k, packed, 0.5, 1.0, **kw)

            row["kernel_ms"][name] = device_ms(
                lambda: kernel(xin, w, bias))[0]
            row["kernel_call_ms"][name] = cs.time_ms(
                lambda: kernel(xin, w, bias))
            row["kernel_device_ms"][name] = cs.cold_warm(
                kernel, (xin, w, bias), moved)
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
            got = call(x, w, bias)
            mm = spike_matmul.spike_matmul_packed(xp, w)
            plain = neuron_layer.neuron_layer_eval_plain(x, w, bias)
            if args.bf16:
                z = neuron_layer.neuron_layer_train_z(x, w, packed=True,
                                                      xin=xin)
                exact = lif_soma.lif_soma_fwd_plain(z + bias)[0].to(dtype)
                torch.cuda.synchronize()
                row["bitwise_z_pass"] = torch.equal(got, exact)
                row["digests"] = {"spike_matmul": cs.digest(mm),
                                  "z_pass": cs.digest(z)}
                row.update(cs.unfused_yardstick(x, w, bias))
                del z
            else:
                exact = lif_soma.lif_soma_fwd_plain(
                    mm.reshape(t, m, k) + bias)[0]
                torch.cuda.synchronize()
                row["bitwise_spike_matmul"] = torch.equal(got, exact)
            row["plain_mismatch"] = int((got != plain).sum())
            row["spike_rate"] = float(got.float().mean())
            del got, exact, plain, mm
        print(json.dumps({"label": args.label, "src": str(src), **row}),
              flush=True)
        del x, w, xin
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
