#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--depth 8] [--verbose-build]

Builds the CUDA kernels from the sources in this checkout, holds each kernel
against its plain PyTorch version on the card at the shapes the
``spikingformer-8-512`` forward gives it, then serves a few request batches
through ``SpikingFormer.forward`` under the ``cuda-full`` policy and compares
with the same weights under the ``eager`` policy on the same card. It needs
one CUDA device and ``nvcc`` and fails (non-zero exit, no result line)
without them. Every phase prints one JSON line; the line before the last but
one lists the kernels, and the last line is the verdict.

Times are CUDA-event times after a warm-up, inputs left warm in the L2 cache
as the model leaves them. ``bound_ms`` is the least time the card could
take: the larger of the bytes the function must move (inputs once, outputs
once) over 3.35 TB/s and the fp32 operations these inputs need over
67 TFLOP/s (the published H100 SXM rates; spikes are data, so the spike
products count one addition per set bit and output column).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.configs import get_spikingformer_config  # noqa: E402
from repro_torch.core.lif import _lif_scan_eager  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.core.spiking_layers import block_apply  # noqa: E402
from repro_torch.core.spikingformer import (SpikingFormer,  # noqa: E402
                                            _index_tree, init_spikingformer,
                                            spikingformer_apply)
from repro_torch.kernels import (KERNELS, build,  # noqa: E402
                                 launch_counts, lif_soma, neuron_layer,
                                 reset_launch_counts, spike_matmul)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
PRESET = "spikingformer-8-512"
REQUESTS, BATCH = 3, 16         # request batches served, images in each
DEVICE = torch.device("cuda")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def time_ms(fn, min_ms: float = 30.0, max_iters: int = 50) -> float:
    """CUDA-event time of one call of ``fn``, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = start.elapsed_time(end)
    iters = int(max(1, min(max_iters, min_ms / max(once, 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def spikes(gen, shape, rate=0.2):
    return (torch.rand(shape, generator=gen, device=DEVICE) < rate).float()


def dyadic(gen, shape, scale=64, span=16):
    """Multiples of 1/scale in [-span/scale, span/scale): every fp32 partial
    sum of such weights under {0,1} inputs is exact in any order."""
    return torch.randint(-span, span, shape, generator=gen,
                         device=DEVICE).float() / scale


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version at the preset's shapes
# ---------------------------------------------------------------------------

def check_lif(gen, t, m, d):
    x = torch.randn((t, m, d), generator=gen, device=DEVICE) * 1.2 + 0.3
    got = lif_soma.lif_soma_fwd(x)
    want = lif_soma.lif_soma_fwd_plain(x)
    torch.cuda.synchronize()
    bad = [n for n, a, b in zip("SUM", got, want) if not torch.equal(a, b)]
    if bad:
        fail(f"lif_soma_fwd differs from its plain version in {bad}")
    b_ms, b_by = bound(4 * nbytes(x), 6.0 * x.numel())
    return {"case": "pssa.lif/smlp.lif", "shape": [t, m, d],
            "max_abs_err": float((got[1] - want[1]).abs().max()),
            "spike_mismatch": 0, "compared": x.numel(),
            "tolerance": "bitwise on S, U and mask",
            "ms": time_ms(lambda: lif_soma.lif_soma_fwd(x)),
            "plain_ms": time_ms(lambda: lif_soma.lif_soma_fwd_plain(x)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


def check_matmul(case, packed, w, fn, shared_w=False):
    """``fn(packed, w)`` against fp32 ``torch.matmul`` on the unpacked
    operand (rtol 1e-5, atol 1e-4: the same products, summed in another
    order)."""
    got = fn(packed, w)
    dense = spike_matmul.spike_unpack(packed, torch.float32)
    want = torch.matmul(dense, w)
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"{case}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = (got - want).abs()
    if not bool((err <= 1e-4 + 1e-5 * want.abs()).all()):
        fail(f"{case}: max abs err {float(err.max())} beyond rtol 1e-5 / "
             f"atol 1e-4 of torch.matmul")
    k = w.shape[-1]
    w_bytes = nbytes(w) // (w.shape[0] if shared_w else 1)
    b_ms, b_by = bound(nbytes(packed, got) + w_bytes, float(dense.sum()) * k)
    c = w.shape[-2]
    return {"case": case, "shape": {"packed": list(packed.shape),
                                    "w": list(w.shape),
                                    "w_stride": list(w.stride())},
            "max_abs_err": float(err.max()),
            "tolerance": "rtol 1e-5, atol 1e-4 vs fp32 torch.matmul",
            "ms": time_ms(lambda: fn(packed, w)),
            "plain_ms": time_ms(
                lambda: spike_matmul.spike_matmul_packed_plain(packed, w)),
            "library_ms": time_ms(lambda: torch.matmul(dense, w)),
            "bound_ms": b_ms, "bound_by": b_by,
            "dense_fp32_bound_ms":
                2.0 * got.numel() * c / FP32_FLOPS * 1e3}


def check_neuron_layer(gen, case, t, m, c, k, packed):
    """Gaussian weights: spike mismatch <= 1e-4 of the elements (a membrane
    within rounding of the threshold may fire differently under another
    order of summation). Dyadic weights: every partial sum is exact, so the
    spikes must agree bit for bit."""
    if packed:
        x = spikes(gen, (t, m, c))
    else:   # float image patches; dyadic values keep the exact case exact
        x = dyadic(gen, (t, m, c), scale=16, span=32)
    out = {"case": case, "shape": [t, m, c, k], "arm": "packed" if packed
           else "dense", "compared": t * m * k}
    for kind in ("dyadic", "gaussian"):
        if kind == "dyadic":
            w, bias = dyadic(gen, (c, k)), dyadic(gen, (k,))
        else:
            w = torch.randn((c, k), generator=gen, device=DEVICE) * c ** -0.5
            bias = torch.randn((k,), generator=gen, device=DEVICE) * 0.1
        if packed:   # rate 0.2 of c inputs: bring the sums near threshold
            w = w * (2.0 if kind == "gaussian" else 1.0)
        got = neuron_layer.neuron_layer_eval(x, w, bias, packed=packed)
        want = neuron_layer.neuron_layer_eval_plain(x, w, bias)
        torch.cuda.synchronize()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"neuron_layer_eval {case}: bad output")
        n_bad = int((got != want).sum())
        out[f"{kind}_mismatch"] = n_bad
        out[f"{kind}_rate"] = float(want.mean())
        limit = 0 if kind == "dyadic" else 1e-4 * want.numel()
        if n_bad > limit:
            fail(f"neuron_layer_eval {case} ({kind} weights): {n_bad} of "
                 f"{want.numel()} spikes differ (limit {limit})")
        if kind == "dyadic":
            out["max_abs_err"] = float((got - want).abs().max())
    # timed on the Gaussian weights (the last ones)
    ops = (float(x.sum()) * k if packed else 2.0 * t * m * c * k) \
        + 8.0 * t * m * k
    b_ms, b_by = bound(nbytes(x, w, bias, got), ops)
    out.update({
        "tolerance": "spikes: 0 differ on dyadic weights, <= 1e-4 of the "
                     "elements on Gaussian weights",
        "ms": time_ms(lambda: neuron_layer.neuron_layer_eval(
            x, w, bias, packed=packed)),
        "plain_ms": time_ms(lambda: neuron_layer.neuron_layer_eval_plain(
            x, w, bias)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "dense_fp32_bound_ms": 2.0 * t * m * c * k / FP32_FLOPS * 1e3})
    if packed:
        out["pack_ms"] = time_ms(lambda: spike_matmul.spike_pack(x))
    return out


def kernel_phase(seed: int, batch: int) -> dict[str, list[dict]]:
    cfg = get_spikingformer_config(PRESET)
    t, d, f, h = cfg.time_steps, cfg.d_model, cfg.d_ff, cfg.n_heads
    n, dh = cfg.num_tokens, cfg.d_model // cfg.n_heads
    m = batch * n
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    cases: dict[str, list[dict]] = {name: [] for name in KERNELS}

    cases["lif_soma_fwd"].append(check_lif(gen, t, m, d))

    for site, c in (("pssa.proj", d), ("smlp.b", f)):
        packed = spike_matmul.spike_pack(spikes(gen, (t * m, c)))
        w = torch.randn((c, d), generator=gen, device=DEVICE) * c ** -0.5
        cases["spike_matmul_packed"].append(check_matmul(
            site, packed, w, spike_matmul.spike_matmul_packed))

    bmm = spike_matmul.spike_matmul_packed_batched
    # attn_qk: per-head views of (T*B, N, h*dh) spikes; K^T is a strided view
    q, k = (spikes(gen, (t * batch, n, d)) for _ in range(2))
    qh, kh = (a.view(t * batch, n, h, dh).permute(0, 2, 1, 3) for a in (q, k))
    cases["spike_matmul_packed_batched"].append(check_matmul(
        "attn_qk", spike_matmul.spike_pack(qh), kh.transpose(-1, -2), bmm))
    # attn_av-style at N = 64: packed V^T (dh, M) x attn^T (M, N), both views
    n64 = 64
    v = spikes(gen, (t * batch, h, n64, dh))
    attn = torch.randint(0, dh, (t * batch, h, n64, n64), generator=gen,
                         device=DEVICE).float()
    cases["spike_matmul_packed_batched"].append(check_matmul(
        "attn_av(N=64)", spike_matmul.spike_pack(v.transpose(-1, -2)),
        attn.transpose(-1, -2), bmm))
    # one weight shared by all T batches: zero batch stride, never copied
    c3 = 9 * (d // 2)
    patches = spike_matmul.spike_pack(spikes(gen, (t, m, c3)))
    w3 = torch.randn((c3, d), generator=gen, device=DEVICE) * c3 ** -0.5
    w3e = w3.unsqueeze(0).expand(t, c3, d)
    if w3e.stride(0) != 0:
        fail("expanded weight does not have a zero batch stride")
    cases["spike_matmul_packed_batched"].append(check_matmul(
        "tokenizer.conv.3(shared w)", patches, w3e, bmm, shared_w=True))

    size, c_in = cfg.image_size, cfg.in_channels
    for i, (c_in, c_out) in enumerate(cfg.tokenizer_stage_channels()):
        size //= 2
        cases["neuron_layer_eval"].append(check_neuron_layer(
            gen, f"tokenizer.conv.{i}", t, batch * size * size, 9 * c_in,
            c_out, packed=i > 0))
        torch.cuda.empty_cache()
    for site, k_out in (("pssa.qkv", d), ("smlp.a", f)):
        cases["neuron_layer_eval"].append(check_neuron_layer(
            gen, site, t, m, d, k_out, packed=True))
    return cases


# ---------------------------------------------------------------------------
# Phase 4: the model
# ---------------------------------------------------------------------------

def _zip_bn(params, state, fn):
    """Call ``fn(bn_params, bn_state)`` for every BN of the two trees."""
    if isinstance(state, dict):
        if "mean" in state:
            fn(params, state)
        else:
            for k in state:
                _zip_bn(params[k], state[k], fn)
    elif isinstance(state, list):
        for p, st in zip(params, state):
            _zip_bn(p, st, fn)


def _map_weights(tree, fn):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "w":
                tree[k] = fn(v)
            else:
                _map_weights(v, fn)
    elif isinstance(tree, list):
        for v in tree:
            _map_weights(v, fn)


def _exact_var(sqrt_d: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 ``var`` with ``var + eps == sqrt_d ** 2`` exactly, so that
    ``sqrt(var + eps)`` gives back the power of two ``sqrt_d``."""
    target = sqrt_d * sqrt_d
    var = target - eps
    for steps in (1, -1, 2, -2, 3, -3):
        miss = (var + eps) != target
        if not bool(miss.any()):
            break
        cand = target - eps
        toward = torch.full_like(cand, float("inf") if steps > 0
                                 else float("-inf"))
        for _ in range(abs(steps)):
            cand = torch.nextafter(cand, toward)
        var = torch.where(miss & ((cand + eps) == target), cand, var)
    if bool(((var + eps) != target).any()) or \
            bool((torch.sqrt(var + eps) != sqrt_d).any()):
        fail("could not build BN statistics with an exact square root")
    return var


def make_model(seed: int, depth: int, batch: int, weights: str):
    """A ``SpikingFormer`` at the preset's widths under the ``eager``
    policy, everything from ``seed``.

    BN gamma/beta are perturbed and the running statistics are set from the
    batch statistics of one calibration batch (one train-mode pass of the
    eager policy), so that every BN is non-trivial and the network keeps
    spiking through its depth.

    ``weights="gaussian"``: the package's own initialisation.
    ``weights="dyadic"``: weights, gamma, beta, BN means and pixels are
    small multiples of powers of two and every BN's ``sqrt(var + eps)`` is
    rounded to a power of two. Then every sum and every BN, folded or not, is exact in
    fp32 whatever the order of the additions, so two policies that compute
    the same function must give the same logits bit for bit.
    """
    import dataclasses

    cfg = dataclasses.replace(get_spikingformer_config(PRESET + "@eager"),
                              num_layers=depth)
    gen = torch.Generator().manual_seed(seed)
    params, state = init_spikingformer(gen, cfg, DEVICE)
    exact = weights == "dyadic"

    def rand_like(t, fn):
        return fn(t.shape).to(t)

    if exact:
        _map_weights(params, lambda w: rand_like(w, lambda sh: torch.randint(
            -16, 16, sh, generator=gen).float() / 64))

    def perturb(bn, _):
        if exact:
            bn["gamma"] = rand_like(bn["gamma"], lambda sh: torch.randint(
                3, 6, sh, generator=gen).float() / 4)
            bn["beta"] = rand_like(bn["beta"], lambda sh: torch.randint(
                -4, 5, sh, generator=gen).float() / 16)
        else:
            bn["gamma"] = rand_like(bn["gamma"], lambda sh: 0.8 + 0.4 *
                                    torch.rand(sh, generator=gen))
            bn["beta"] = rand_like(bn["beta"], lambda sh: 0.2 *
                                   torch.randn(sh, generator=gen))

    _zip_bn(params, state, perturb)

    def make_images():
        shape = (batch, cfg.image_size, cfg.image_size, cfg.in_channels)
        if exact:
            return (torch.randint(0, 16, shape, generator=gen).float()
                    / 16).to(DEVICE)
        return torch.rand(shape, generator=gen).to(DEVICE)

    with torch.no_grad():
        _, new_state = spikingformer_apply(params, state, make_images(), cfg,
                                           train=True)

    def unblend(new, old):   # new = 0.9 * old + 0.1 * batch statistic
        if isinstance(new, dict):
            return {k: unblend(new[k], old[k]) for k in new}
        if isinstance(new, list):
            return [unblend(a, b) for a, b in zip(new, old)]
        return (new - 0.9 * old) / 0.1

    state = unblend(new_state, state)

    def round_stats(bn_p, bn_s):
        # sqrt(var + eps) -> the nearest power of two; gamma (a multiple of
        # 1/16) takes up the change of scale, so that the rounded network
        # stays close to the calibrated one and keeps its spike rates.
        true = torch.sqrt(bn_s["var"].clamp_min(0) + 1e-5)
        sqrt_d = torch.exp2(torch.round(torch.log2(true)).clamp(-2, 4))
        bn_p["gamma"] = (torch.round(bn_p["gamma"] * sqrt_d / true * 16)
                         .clamp(1, 32) / 16)
        bn_s["var"] = _exact_var(sqrt_d)
        bn_s["mean"] = torch.round(bn_s["mean"] * 64) / 64

    if exact:
        _zip_bn(params, state, round_stats)
    return SpikingFormer(cfg, params, state, device=DEVICE), make_images


def spike_mismatch(a: torch.Tensor, b: torch.Tensor, lif_cfg) -> float:
    """Fraction of differing spikes after the LIF the next block applies to
    a block's output (the tokenizer's output is spikes already)."""
    sa, sb = (_lif_scan_eager(x, lif_cfg, "pssa.lif") for x in (a, b))
    return float((sa != sb).float().mean())


def run_model(seed: int, depth: int, requests: int, batch: int, weights: str):
    """Serve ``requests`` batches under ``cuda-full`` and under ``eager``
    with one set of weights and compare. Returns the launch counts of the
    ``cuda-full`` run."""
    eager, make_images = make_model(seed, depth, batch, weights)
    cfg = eager.cfg
    full = eager.with_policy(named_policy("cuda-full"))
    plan = {r.site: r.effective for r in full.cfg.execution_plan()}
    images = [make_images() for _ in range(requests)]

    def serve(model, taps_out):
        logits, times = [], []
        for img in images:
            taps: list = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits.append(model(img, taps=taps))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            taps_out.append(taps)
        return torch.cat(logits), times

    full(images[0])                      # warm-up, not counted or timed
    eager(images[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()                # the main path starts here
    taps_full: list = []
    lf, ms_full = serve(full, taps_full)
    counts = launch_counts()             # ... and ends here
    peak_full = torch.cuda.max_memory_allocated()
    taps_eager: list = []
    le, ms_eager = serve(eager, taps_eager)

    per_forward = {"lif_soma_fwd": 3 * depth,
                   "neuron_layer_eval": 4 + 4 * depth,
                   "spike_matmul_packed": 2 * depth,
                   "spike_matmul_packed_batched": depth}
    want = {k: v * requests for k, v in per_forward.items()}
    if counts != want:
        fail(f"launch counts {counts} != {want} for {requests} forwards")
    if lf.shape != (requests * batch, cfg.num_classes) or \
            not bool(torch.isfinite(lf).all()):
        fail(f"logits of shape {tuple(lf.shape)} or not finite")
    logit_err = float((lf - le).abs().max())
    agree = int((lf.argmax(-1) == le.argmax(-1)).sum())

    lif_cfg = cfg.lif
    free, forced, rates = [], [], []
    block_cfg = full.cfg.block
    params, state = full.params, full.state
    for tf, te in zip(taps_full, taps_eager):
        row = [float((tf[0] != te[0]).float().mean())]
        row += [spike_mismatch(a, b, lif_cfg) for a, b in zip(tf[1:], te[1:])]
        free.append(row)
        rates.append([float(te[0].mean()),
                      float(_lif_scan_eager(te[-1], lif_cfg, "").mean())])
        # each block alone, fed the eager policy's input to that block: what
        # one block's kernels flip, without what earlier flips cascade into
        row = []
        with torch.no_grad():
            for i in range(depth):
                out, _ = block_apply(_index_tree(params["blocks"], i),
                                     _index_tree(state["blocks"], i), te[i],
                                     block_cfg, train=False)
                row.append(spike_mismatch(out, te[i + 1], lif_cfg))
        forced.append(row)
    worst_forced = max(max(r) for r in forced)
    worst_tok = max(r[0] for r in free)
    if weights == "dyadic":
        tolerance = ("every sum is exact in fp32: logits, and the spikes "
                     "after the tokenizer and after every block, equal the "
                     "eager policy's bit for bit")
        ok = logit_err == 0.0 and max(max(r) for r in free) == 0.0
    else:
        tolerance = ("the tokenizer's spikes, and every block's on the eager "
                     "policy's input to it, differ from the eager policy's "
                     "(fp32, TF32 off) in <= 1e-3 of the elements; the "
                     "free-running rows and logits are reported, not held: "
                     "one flipped spike spreads through attention")
        ok = worst_forced <= 1e-3 and worst_tok <= 1e-3
    emit("model", weights=weights, preset=f"{PRESET}@cuda-full", depth=depth,
         dtype="float32", requests=requests, batch=batch, plan=plan,
         logits_shape=list(lf.shape), logits_std=float(le.std()),
         max_abs_logit_err=logit_err,
         argmax_agree=f"{agree}/{requests * batch}",
         spike_rate_tokenizer_and_last_block=rates,
         spike_mismatch_free_running=free,
         spike_mismatch_per_block_same_input=forced,
         ms_per_request_cuda_full=ms_full, ms_per_request_eager=ms_eager,
         peak_memory_bytes_cuda_full=peak_full,
         launches=counts, launches_per_forward=per_forward,
         tolerance=tolerance)
    if not ok:
        fail(f"model ({weights} weights): logits differ by {logit_err}, "
             f"argmax agrees on {agree}, worst per-block mismatch on the "
             f"same input {worst_forced}, tokenizer {worst_tok}, "
             f"free-running {max(max(r) for r in free)}")
    return counts


def model_phase(seed: int, depth: int, requests: int, batch: int):
    """The exact weights show that the two policies compute one function,
    end to end; the Gaussian weights show each block's kernels against the
    eager policy at ordinary values, and give the times."""
    run_model(seed, depth, requests, batch, "dyadic")
    return run_model(seed, depth, requests, batch, "gaussian")


# ---------------------------------------------------------------------------

def summarise(cases: dict[str, list[dict]], counts: dict[str, int]) -> dict:
    """One entry per kernel. Where a kernel serves several sites, the entry
    carries the numbers of its first case (a site of the main path) and the
    largest error of all cases; ``cases`` keeps every site's numbers."""
    kernels = []
    for name, info in KERNELS.items():
        rows = cases[name]
        first = rows[0]
        kernels.append({
            "name": name, "route": "cuda", "source": info["source"],
            "replaces": info["replaces"], "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "case": first["case"],
            "cases": rows})
    return {"kernels": kernels}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--depth", type=int, default=8,
                    help="transformer blocks (the preset has 8)")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print ptxas' registers / shared memory / spills")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    # The yardsticks are full fp32: cuDNN's fp32 convolution is TF32 by
    # default, the matmul is not; state both.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = repro_torch.probe()
    if not info["nvidia_smi"]:
        fail("nvidia-smi gave no name and power limit for the card")
    smi = info["nvidia_smi"].splitlines()[0]
    emit("device", name=info["device_name"], nvidia_smi=smi,
         torch=info["torch"], cuda=info["cuda_runtime"],
         count=info["device_count"])

    t0 = time.perf_counter()
    build.load(verbose=args.verbose_build)
    emit("build", seconds=time.perf_counter() - t0,
         nvcc=info["nvcc_release"],
         sources=[s.name for s in build.sources()])

    cases = kernel_phase(args.seed, BATCH)
    emit("kernels", cases=cases)

    counts = model_phase(args.seed, args.depth, REQUESTS, BATCH)

    print(json.dumps(summarise(cases, counts)), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
