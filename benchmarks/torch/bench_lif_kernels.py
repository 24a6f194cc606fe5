#!/usr/bin/env python3
"""The LIF kernels (``lif_soma_fwd`` / ``lif_soma_bwd``) of one checkout on
the card: each arm at the shapes the paths give them, the crossover between
the arms, and the launches of the paths around them.

    python3 benchmarks/torch/bench_lif_kernels.py [--src DIR] [--label NAME]
        [--lm]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two checkouts can be compared on one
card in one run: parent, change, change, parent. It prints, as JSON lines
after the ``device`` line that names the card and its power limit:

- ``kind: "kernel"``: at each shape of the paths, (T, M, D) = (1, 8, 1024)
  decode from a carried state, (128, 8, 1024) training, (256, 1 or 8, 1024)
  forward and the Spikingformer's (4, 3136, 512), in the contiguous layout
  and in the LM's (S, B, D) view of a (B, S, D) tensor, each arm the
  checkout has (launched as its wrapper does; a checkout without arms: its
  wrapper, on contiguous operands from rest): device ms per call
  (``torch.profiler``) with the L2 cold (``chip_smoke.l2_cold``: operands
  and outputs cycled over four L2s) and warm, CUDA-event ms of a call, the
  bitwise check against the plain version, and the byte bound (and, where
  the checkout has ring kernels, ``chip_smoke.lif_bound``'s chain bound);
- ``kind: "crossover"``: where the checkout has both arms, each arm's device
  ms, L2 cold, over T = 1 .. 128 and n = 65,536 .. 401,408 elements
  (contiguous);
- ``kind: "path"``: launches and device ms of one call of the LM's LIF as
  the model runs it: the (128, 8, 1024) training forward and backward
  through ``lif_scan`` (``cuda-full``) on the (S, B, D) view with a
  (B, S, D) cotangent, the (256, 8, 1024) forward, and the decode step's
  ``lif_decode_step`` at (8, 1024);
- with ``--lm``, ``kind: "lm"``: ``qwen3-0.6b`` + LIF (fp32, 28 layers,
  weights from seed 0): launches and device-busy ms of one serving step
  with 8 busy slots and of one training step of 8 x 128 tokens (the
  registry's remat), under ``cuda-full``.

Needs a CUDA device. Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: Calls per ``torch.profiler`` window (of whole LM steps with ``--lm``).
ITERS, LM_ITERS = 20, 3

#: (case, T, M, D, kernels): the shapes of the paths.
SHAPES = (("lm.ffn.lif decode", 1, 8, 1024, ("fwd",)),
          ("lm.ffn.lif train", 128, 8, 1024, ("fwd", "bwd")),
          ("lm.ffn.lif forward b1", 256, 1, 1024, ("fwd",)),
          ("lm.ffn.lif forward b8", 256, 8, 1024, ("fwd",)),
          ("pssa.lif/smlp.lif", 4, 3136, 512, ("fwd", "bwd")))
#: The LIF parameters of a launch on one arm (the wrappers' defaults).
LIF, GRAD = (0.5, 1.0, 0.0, 2.0), (0.5, 1.0)
#: The crossover grid: T, and (M, D).
CROSS_T = (1, 4, 16, 64, 128)
CROSS_MD = ((64, 1024), (128, 1024), (256, 1024), (784, 512))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--lm", action="store_true",
                    help="also count one LM serving and training step")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import repro_torch
    if src not in Path(repro_torch.__file__).resolve().parents:
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}, "
                         f"not from {src}")
    sys.path.insert(1, str(ROOT))
    sys.path.insert(2, str(ROOT / "benchmarks" / "torch"))
    import chip_smoke as cs
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.lif import LIFConfig, lif_decode_step, lif_scan
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import build, lif_soma

    def emit(kind, **fields):
        print(json.dumps({"label": args.label, "kind": kind, **fields}),
              flush=True)

    def profiled(fn, iters: int = ITERS) -> dict:
        """Device ms and launches per call of ``fn`` over ``iters``
        calls, after one."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.device_time_total > 0]
        return {"device_ms": sum(e.device_time_total for e in rows)
                / 1e3 / iters,
                "launches": sum(e.count for e in rows) / iters,
                "kernels": {e.key[:60]: e.count / iters for e in rows}}

    has_arm = hasattr(lif_soma, "choose_arm")
    arms = ("flat", "ring") if has_arm else (None,)

    def launcher(kernel, arm):
        """One kernel on one arm (``_launch_fwd`` / ``_launch_bwd``, as the
        wrapper makes it); ``arm`` None, a checkout without arms: its
        wrapper."""
        if arm is None:
            return getattr(lif_soma, f"lif_soma_{kernel}")
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "fwd":
            return lambda x, u0=None, s0=None: lif_soma._launch_fwd(
                x, u0, s0, arm, LIF, stream)
        return lambda g, u, s, mask: lif_soma._launch_bwd(
            g, u, s, mask, None, arm, GRAD, stream)

    def timed(call, ops, moved) -> dict:
        """Device ms of ``call(*ops)`` with the L2 cold (``l2_cold``) and
        warm, its launches, and the CUDA-event ms of a call."""
        cold = profiled(cs.l2_cold(call, ops, moved))
        return {"ms": cs.time_ms(lambda: call(*ops)),
                "device_ms": cold["device_ms"],
                "device_ms_l2_warm": profiled(lambda: call(*ops))[
                    "device_ms"],
                "launches": cold["launches"]}
    cs.setup_card()
    build.load()
    gen = torch.Generator(device=cs.DEVICE).manual_seed(0)

    for case, t, m, d, kernels in SHAPES:
        carry = t == 1
        for layout in ("dense", "lm"):
            if layout == "lm" and (t == 1 or d == 512):
                continue
            x = cs.lif_input(gen, t, m, d, layout)
            if not has_arm and (carry or not x.is_contiguous()):
                continue    # the parent's kernel takes neither
            for kernel in kernels:
                if kernel == "fwd":
                    ops = (x,) + ((
                        torch.randn((m, d), generator=gen, device=cs.DEVICE),
                        cs.spikes(gen, (m, d), 0.4)) if carry else ())
                else:
                    s, u, mask = lif_soma.lif_soma_fwd_plain(x)
                    g = torch.empty_like(u).copy_(torch.randn(
                        (t, m, d), generator=gen, device=cs.DEVICE))
                    ops = (g, u, s, mask)
                want = getattr(lif_soma, f"lif_soma_{kernel}_plain")(*ops)
                want = want if isinstance(want, tuple) else (want,)
                moved = cs.nbytes(*ops, *want)
                for arm in arms:
                    if arm == "flat" and (carry or not x.is_contiguous()):
                        continue
                    call = launcher(kernel, arm)
                    got = call(*ops)
                    got = got if isinstance(got, tuple) else (got,)
                    torch.cuda.synchronize()
                    row = {"case": case, "kernel": f"lif_soma_{kernel}",
                           "shape": [t, m, d], "layout": layout,
                           "carry": carry, "arm": arm or "default",
                           "bitwise": len(got) == len(want) and all(
                               torch.equal(a, b) for a, b in zip(got, want)),
                           **timed(call, ops, moved),
                           "byte_bound_ms": moved / cs.HBM_BYTES_PER_S * 1e3}
                    if has_arm:
                        row.update(cs.lif_bound(f"lif_soma_{kernel}", t,
                                                moved, 0.0))
                    emit("kernel", **row)
            del x
        torch.cuda.empty_cache()

    if has_arm:
        for t in CROSS_T:
            for m, d in CROSS_MD:
                x = cs.lif_input(gen, t, m, d, "dense")
                s, u, mask = lif_soma.lif_soma_fwd_plain(x)
                g = torch.randn((t, m, d), generator=gen, device=cs.DEVICE)
                row = {"shape": [t, m, d], "n": m * d}
                for arm in arms:
                    for kernel, ops in (("fwd", (x,)), ("bwd", (g, u, s,
                                                                mask))):
                        row[f"{arm}_{kernel}_ms"] = profiled(cs.l2_cold(
                            launcher(kernel, arm), ops,
                            cs.nbytes(x) * (4 if kernel == "fwd" else 5)))[
                                "device_ms"]
                emit("crossover", **row)
                del x, s, u, mask, g
        torch.cuda.empty_cache()

    cfg = LIFConfig(policy=named_policy("cuda-full"))
    for what, t, b in (("train forward + backward", 128, 8),
                       ("forward", 256, 8)):
        f = torch.randn((b, t, 1024), generator=gen, device=cs.DEVICE,
                        requires_grad=what.startswith("train"))
        gy = torch.randn((b, t, 1024), generator=gen, device=cs.DEVICE)

        def step():
            spikes = lif_scan(f.transpose(0, 1), cfg).transpose(0, 1)
            if f.requires_grad:
                torch.autograd.grad(spikes, f, gy)
        emit("path", what=f"lm.ffn.lif {what}", shape=[t, b, 1024],
             **profiled(step))
    xd, u0 = (torch.randn((8, 1024), generator=gen, device=cs.DEVICE)
              for _ in range(2))
    s0 = cs.spikes(gen, (8, 1024), 0.4)
    with torch.inference_mode():
        emit("path", what="lm.ffn.lif decode step (lif_decode_step)",
             shape=[1, 8, 1024],
             **profiled(lambda: lif_decode_step(xd, u0, s0, cfg)))
    if args.lm:
        lm_counts(emit, profiled, gen)


def lm_counts(emit, profiled, gen) -> None:
    """Launches and device ms of one serving step (8 busy slots) and one
    training step (8 x 128) of ``qwen3-0.6b`` + LIF under ``cuda-full``."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.lif import LIFConfig
    from repro_torch.core.policy import named_policy
    from repro_torch.models.common import split_tree
    from repro_torch.models.lm import init_lm
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-0.6b").replace(
        dtype=torch.float32, lif=LIFConfig(policy=named_policy("cuda-full")))
    params = split_tree(init_lm(torch.Generator(device="cuda").manual_seed(0),
                                cfg))[0]
    rng = np.random.default_rng(0)
    engine = ServingEngine(params, cfg, slots=8, max_seq=256)
    for uid in range(8):
        engine.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, 32).tolist(), max_new_tokens=64))
    for _ in range(4):
        engine.step()
    torch.cuda.synchronize()
    got = profiled(engine.step, LM_ITERS)
    emit("lm", what="serving step, 8 busy slots", layers=cfg.num_layers,
         device_ms=got["device_ms"], launches=got["launches"],
         lif_launches={k: v for k, v in got["kernels"].items()
                       if "lif" in k})
    del engine
    torch.cuda.empty_cache()
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8,
                   seed=0)).batch(0).items()}
    opt = init_opt_state(params)
    step = make_train_step(cfg, OptimizerConfig())
    got = profiled(lambda: step(params, opt, batch), LM_ITERS)
    emit("lm", what="training step, 8 x 128 tokens", layers=cfg.num_layers,
         remat=cfg.remat, device_ms=got["device_ms"],
         launches=got["launches"],
         lif_launches={k: v for k, v in got["kernels"].items()
                       if "lif" in k})


if __name__ == "__main__":
    main()
