#!/usr/bin/env python3
"""The training kernels' cases of ``chip_smoke.py`` for one checkout's
kernels, with the device time of each pass.

    python3 benchmarks/torch/bench_train_kernels.py [--src DIR] [--label NAME]
        [--bf16]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two checkouts can be compared on one
card in one run: parent, change, change, parent. It prints, as JSON
lines after the ``device`` line that names the card and its power limit:

- ``chip_smoke.train_kernel_cases`` at seed 0 and the preset's batch: the
  ``bn_fwd``, ``bn_bwd`` and ``neuron_layer_train`` cases with their
  checks, CUDA-event times, bounds and library times (``kind: "case"``);
  ``bn_bwd`` at each of the five distinct shapes of a step, with the device
  time of each of its passes (``passes``) and ATen's batch-norm backward
  alone as ``library_ms``; the dense ``tokenizer.conv.0`` case with its
  passes and its z's error against fp64;
- for ``bn_fwd`` and each neuron-layer site, the device time per call of
  every kernel one wrapper call launches, from ``chip_smoke.pass_ms``
  (``torch.profiler``) over ``ITERS`` calls (``kind: "passes"``), beside the wrapper's CUDA-event time; for ``bn_fwd`` the
  same two for ``F.batch_norm(training=True)``, the library yardstick; at
  the packed sites also the spike matmul's time on the same operands, the
  z round trip's byte time (``2 * T*M*K * 4`` bytes at 3.35 TB/s), the
  yardstick of the tensor-core design, and the RMS error of the z that the
  kernel's first pass writes and of fp32 ``torch.matmul``'s against an
  fp64 product, with the kernel's distance from ``torch.matmul``;
- ``chip_smoke.block_grad_case`` on its seeds (``kind: "block_grad"``):
  one block's spike mismatch f against ``eager`` and its worst gradient
  leaf.

With ``--bf16`` it times the two bf16 arms instead, with the L2 cold and
warm (``chip_smoke.cold_warm``) and per pass (``chip_smoke.pass_ms``):

- ``bn_bwd`` at the five distinct shapes of a step (``kind: "bn_bwd"``),
  beside ATen's ``native_batch_norm_backward`` on the same bf16 operands
  and the byte bound; ``bitwise_dyadic``: dx, dgamma and dbeta equal to the
  plain version's on inputs whose every column sum is exact;
- ``neuron_layer_train`` at every packed site (``kind:
  "neuron_layer_train"``), with the plan kernel of its z pass
  (``z_kernel``), beside the bf16 spike matmul on the same operands (the
  kernel its rule picks, ``spike_matmul_kernel``) and the bound of the z
  pass: one bf16 tensor-core pass or z's fp32 bytes, whichever is longer;
  ``z_pass``: the first pass alone (``chip_smoke.z_pass_row``: its device
  time cold and warm beside the fastest cuBLAS call that forms the same
  fp32 z from the unpacked spikes, ``library_device_ms``).

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
    ap.add_argument("--bf16", action="store_true",
                    help="time the bf16 arms of bn_bwd and of the neuron "
                         "layer's train mode")
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
    import chip_smoke as cs
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build, fused_bn, neuron_layer, spike_matmul

    def emit(kind, **fields):
        print(json.dumps({"label": args.label, "kind": kind, **fields}),
              flush=True)

    def passes(fn) -> dict[str, float]:
        """Device ms per call of every kernel ``fn`` launches."""
        return cs.pass_ms(fn, ITERS)

    def rms(a) -> float:
        return float(a.double().pow(2).mean().sqrt())

    def first_pass_z(x, w, gamma, beta):
        """z = x @ w as the packed arm's first pass writes it: the wrapper
        keeps z as scratch, so this calls the C entry point itself."""
        t, m, c = x.shape
        k = w.shape[1]
        xp = spike_matmul.spike_pack(x)
        f32 = dict(dtype=torch.float32, device=x.device)
        z, s = (torch.empty((t, m, k), **f32) for _ in range(2))
        part = torch.empty((2, -(-t * m // neuron_layer.TILE_ROWS), k), **f32)
        mu, var, sqrt_d = (torch.empty((k,), **f32) for _ in range(3))
        # the fp32 arm's kernel, named where the entry takes it (a --src
        # tree from before the rule moved to Python plans it itself)
        kernel = (neuron_layer.Z_MMA,) \
            if len(build.SIGNATURES["e2a_neuron_layer_train"]) > 20 else ()
        code = build.load().e2a_neuron_layer_train(
            xp.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            z.data_ptr(), part.data_ptr(), mu.data_ptr(), var.data_ptr(),
            sqrt_d.data_ptr(), s.data_ptr(), t, m, c, k, 1, *kernel, 0.5, 1.0,
            1e-5, 0, torch.cuda.current_stream().cuda_stream)
        build.check_launch(code, "neuron_layer_train")
        torch.cuda.synchronize()
        return z

    cs.setup_card()
    build.load()
    gen = torch.Generator(device=cs.DEVICE).manual_seed(0)
    if args.bf16:
        bf16_arms(cs, emit, gen)
        return
    for name, rows in cs.train_kernel_cases(gen, cs.BATCH).items():
        for row in rows:
            emit("case", kernel=name, src=str(src), **row)

    cfg = cs.get_spikingformer_config(cs.PRESET)
    m = cfg.time_steps * cs.BATCH * cfg.num_tokens
    x = torch.randn((m, cfg.d_model), generator=gen, device=cs.DEVICE)
    gamma = torch.rand((cfg.d_model,), generator=gen, device=cs.DEVICE) + 0.5
    beta = torch.randn((cfg.d_model,), generator=gen, device=cs.DEVICE)

    def kernel():
        return fused_bn.bn_fwd(x, gamma, beta)

    def library():
        return F.batch_norm(x, None, None, gamma, beta, training=True,
                            eps=1e-5)

    ms, library_ms = cs.time_ms(kernel), cs.time_ms(library)
    emit("passes", kernel="bn_fwd", case="pssa.proj/smlp.b",
         shape=[m, cfg.d_model], ms=ms, passes=passes(kernel),
         library_ms=library_ms, library_passes=passes(library))
    del x
    for case, t, m, c, k, packed in cs.neuron_layer_sites(cs.BATCH):
        x, w, gamma, beta = cs.neuron_layer_train_inputs(gen, t, m, c, k,
                                                         packed)

        def call():
            return neuron_layer.neuron_layer_train(x, w, gamma, beta,
                                                   packed=packed)

        ms = cs.time_ms(call)
        row = {"case": case, "shape": [t, m, c, k], "ms": ms,
               "passes": passes(call)}
        if packed:
            xp = spike_matmul.spike_pack(x).reshape(t * m, c // 8)
            row["spike_matmul_ms"] = cs.time_ms(
                lambda: spike_matmul.spike_matmul_packed(xp, w))
            row["z_round_trip_ms"] = 2 * t * m * k * 4 / \
                cs.HBM_BYTES_PER_S * 1e3
            z = first_pass_z(x, w, gamma, beta)
            z_lib = torch.matmul(x, w)
            z64 = torch.matmul(x.double(), w.double())
            row["z"] = {"rms": rms(z64), "kernel_rms_err": rms(z - z64),
                        "matmul_rms_err": rms(z_lib - z64),
                        "kernel_vs_matmul_rms": rms(z - z_lib),
                        "kernel_vs_matmul_differ": float(
                            (z != z_lib).float().mean())}
            del xp, z, z_lib, z64
        emit("passes", kernel="neuron_layer_train", **row)
        del x, w
        torch.cuda.empty_cache()

    for seed in range(cs.BLOCK_SEEDS):
        got = cs.block_grad_case(seed, cs.BATCH)
        emit("block_grad", seed=seed, spike_mismatch=got["spike_mismatch"],
             worst_grad_rel_l2=got["worst_grad_rel_l2"], ok=got["ok"])
        torch.cuda.empty_cache()


def bf16_arms(cs, emit, gen) -> None:
    """``--bf16``: ``bn_bwd`` at the step's five shapes and
    ``neuron_layer_train`` at its packed sites, bf16 operands."""
    import torch

    from repro_torch.kernels import fused_bn, neuron_layer, spike_matmul

    bf16 = torch.bfloat16

    def timed(call, operands, moved) -> dict:
        return {"ms": cs.time_ms(lambda: call(*operands)),
                **cs.cold_warm(call, operands, moved),
                "passes": cs.pass_ms(lambda: call(*operands), ITERS)}

    for m, d in cs.bn_bwd_shapes(cs.BATCH):
        exact = [a.to(bf16) if i < 2 else a
                 for i, a in enumerate(cs.dyadic_bn_bwd(gen, m, d))]
        bitwise = all(torch.equal(a, b) for a, b in zip(
            fused_bn.bn_bwd(*exact), fused_bn.bn_bwd_plain(*exact)))
        del exact
        x = (torch.randn((m, d), generator=gen, device=cs.DEVICE) * 2.0
             + 0.5).to(bf16)
        g = torch.randn((m, d), generator=gen, device=cs.DEVICE).to(bf16)
        gamma = torch.rand((d,), generator=gen, device=cs.DEVICE) + 0.5
        _, mu, sd = fused_bn.bn_fwd_plain(x, gamma, gamma)
        inv = (1.0 / sd).reshape(-1)
        ops = (g, x, gamma, mu, sd)
        out = fused_bn.bn_bwd(*ops)
        moved = cs.nbytes(*ops, *out)

        def aten(g, x, gamma, mu, inv):
            return torch.ops.aten.native_batch_norm_backward(
                g, x, gamma, None, None, mu.reshape(-1), inv, True, 1e-5,
                [True, True, True])

        emit("bn_bwd", shape=[m, d], bitwise_dyadic=bitwise,
             bound_ms=moved / cs.HBM_BYTES_PER_S * 1e3, bound_by="bytes",
             **timed(fused_bn.bn_bwd, ops, moved),
             library=timed(aten, (g, x, gamma, mu, inv), moved))
        del x, g, out
        torch.cuda.empty_cache()

    for case, t, m, c, k, packed in cs.neuron_layer_sites(cs.BATCH):
        if not packed:
            continue
        x = cs.spikes(gen, (t, m, c)).to(bf16)
        w = (torch.randn((c, k), generator=gen, device=cs.DEVICE) * 2.0
             * c ** -0.5).to(bf16)
        gamma = torch.rand((k,), generator=gen, device=cs.DEVICE) * 0.4 + 0.8
        beta = torch.randn((k,), generator=gen, device=cs.DEVICE) * 0.2 + 0.3
        ops = (x, w, gamma, beta)

        def call(x, w, gamma, beta):
            return neuron_layer.neuron_layer_train(x, w, gamma, beta,
                                                   packed=True)

        out = call(*ops)
        xp = spike_matmul.spike_pack(x).reshape(t * m, c // 8)
        mm = spike_matmul.spike_matmul_packed
        z_bytes = t * m * k * 4
        emit("neuron_layer_train", case=case, shape=[t, m, c, k],
             z_kernel=cs.plan_kernels(call, *ops)[0],
             spike_matmul_kernel=cs.plan_kernels(mm, xp, w)[0],
             tc_pass_ms=2.0 * t * m * c * k / cs.BF16_FLOPS * 1e3,
             z_bytes_ms=z_bytes / cs.HBM_BYTES_PER_S * 1e3,
             **timed(call, ops, cs.nbytes(*ops, *out)),
             spike_matmul=timed(mm, (xp, w), cs.nbytes(xp, w)
                                + t * m * k * 2),
             z_pass=cs.z_pass_row(x, w, True, gen))
        del x, w, out, xp
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
