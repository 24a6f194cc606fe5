"""Spiking Transformer building blocks (Spikingformer, E2ATST Fig. 1-2).

The counterpart of ``repro.core.spiking_layers``, eval and train arms.

Conventions
-----------
* Activations carry a leading time axis: ``x: (T, B, N, D)``. Matrix ops fold
  (T, B, N) into the paper's sequence length S = BS x T x P^2 (Table III).
* Every layer is a pair of plain functions ``init_*(generator, ...) ->
  (params, state)`` and ``*_apply(params, state, x, ...) -> (y, new_state)``
  over nested dicts with the reference pytree's keys; ``state`` holds BN
  running statistics only. Linear weights are (C_in, C_out).
* ``Conv1D == MM`` (paper §III-A): the Q/K/V/Z/A/B "Conv1DBN" layers are plain
  linear transforms followed by BatchNorm.
* Execution dispatches through the :mod:`repro_torch.core.policy` kernel
  registry: each ``*_apply`` resolves its implementation from an
  :class:`~repro_torch.core.policy.ExecutionPolicy` and a ``site`` name
  (``"pssa.qkv"``, ``"smlp.a"``, ``"attn_qk"``, ...).
* ``train=True`` computes batch statistics and returns the blended running
  statistics (momentum 0.9) as the new state, under every implementation;
  gradients flow through autograd (the kernel ops are
  ``torch.autograd.Function``s, ``repro_torch.kernels.ops``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core.backend import fold_rows, fold_time_major
from repro_torch.core.lif import LIFConfig, lif_scan
from repro_torch.core.policy import (ExecutionPolicy, FUSED_EPILOGUE_IMPLS,
                                     dispatch_kernel, dispatch_site,
                                     fused_epilogue_fallback,
                                     get_kernel, register_kernel,
                                     runtime_fallback)
from repro_torch.launch.mesh import (AllReduceSum, batch_group,
                                     copy_to_model, model_coord,
                                     model_group, reduce_from_model)
from repro_torch.tune.table import lookup as tuned_lookup
from repro_torch.tune.table import lookup_tile

Params = dict[str, Any]
State = dict[str, Any]


def _normal(generator: torch.Generator | None, shape, dtype, device, scale):
    # Drawn on the CPU so that one seed gives the same weights on any device
    # (on the meta device, shapes only: nothing is drawn).
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=generator, dtype=torch.float32) * scale
    return w.to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# BatchNorm (paper eq. 13-18 forward)
# ---------------------------------------------------------------------------

def init_bn(dim: int, dtype=torch.float32, device="cpu") -> tuple[Params, State]:
    params = {"gamma": torch.ones(dim, dtype=dtype, device=device),
              "beta": torch.zeros(dim, dtype=dtype, device=device)}
    state = {"mean": torch.zeros(dim, dtype=torch.float32, device=device),
             "var": torch.ones(dim, dtype=torch.float32, device=device)}
    return params, state


@register_kernel("bn", "eager")
def _bn_eager(params, state, x, train, momentum, eps, policy, site):
    """Plain BatchNorm, the paper's E[x^2] - mu^2 formulation (eq. 13-18);
    statistics in fp32. Also the eval path for every implementation. Under
    a mesh (``launch.mesh.batch_group``) the training statistics are those
    of the global batch, through a differentiable all-reduce of the sums."""
    axes = tuple(range(x.ndim - 1))
    if train:
        xf = x.float()
        group = batch_group()
        if group is None:
            mu = xf.mean(dim=axes)
            ex2 = xf.square().mean(dim=axes)                    # eq. 14
        else:   # the global batch: sums and row count over the ranks
            d = xf.shape[-1]
            sums = AllReduceSum.apply(torch.cat(
                [xf.sum(dim=axes), xf.square().sum(dim=axes),
                 xf.new_full((1,), xf.numel() // d)]).double(), group)
            mu, ex2 = ((sums[i * d:(i + 1) * d] / sums[-1]).float()
                       for i in range(2))
        var = torch.clamp(ex2 - mu.square(), min=0.0)           # eq. 15
        new_state = {
            "mean": (momentum * state["mean"] + (1 - momentum) * mu).detach(),
            "var": (momentum * state["var"] + (1 - momentum) * var).detach()}
    else:
        mu, var = state["mean"], state["var"]
        new_state = state
    sqrt_d = torch.sqrt(var + eps)                              # eq. 16
    y = (x - mu.to(x.dtype)) / sqrt_d.to(x.dtype)               # eq. 17
    y = params["gamma"] * y + params["beta"]                    # eq. 18
    return y, new_state


@register_kernel("bn", "cuda")
def _bn_cuda(params, state, x, train, momentum, eps, policy, site):
    """The BN kernel pair (``ops.bn_train_op``, eq. 13-23): the batch
    statistics the forward kernel computes anyway are blended into the
    running ones (no second pass over x). Eval always uses the running-stat
    plain path, as in the reference."""
    if not train:
        return _bn_eager(params, state, x, train, momentum, eps, policy, site)
    from repro_torch.kernels import ops

    x2, shape = fold_rows(x)
    y, mu, var = ops.bn_train_op(x2.contiguous(), params["gamma"],
                                 params["beta"], eps, batch_group())
    var = torch.clamp(var, min=0.0)   # sqrt_d^2 - eps can round below zero
    new_state = {"mean": momentum * state["mean"] + (1 - momentum) * mu,
                 "var": momentum * state["var"] + (1 - momentum) * var}
    return y.reshape(shape), new_state


def bn_apply(params: Params, state: State, x: torch.Tensor, *, train: bool,
             momentum: float = 0.9, eps: float = 1e-5,
             policy: ExecutionPolicy | None = None, site: str = "bn"):
    """BatchNorm over all axes but the last (features d), resolved through
    the kernel registry from ``policy`` and ``site``."""
    policy = policy if policy is not None else ExecutionPolicy()
    impl = policy.resolve(site, "bn")
    return dispatch_kernel(site, "bn", impl, params, state, x, train,
                           momentum, eps, policy, site)


# ---------------------------------------------------------------------------
# Linear (+ BN) layers
# ---------------------------------------------------------------------------

def init_linear(generator, d_in: int, d_out: int, dtype=torch.float32,
                device="cpu", scale: float | None = None) -> Params:
    scale = scale if scale is not None else d_in ** -0.5
    return {"w": _normal(generator, (d_in, d_out), dtype, device, scale)}


def linear_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"].to(x.dtype)


#: The row-parallel Conv1DBN sites of the reference's plan (Megatron's
#: convention): their input features and weight rows are split over
#: "model", so each rank's product is a partial sum, added over the model
#: group (``reduce_from_model``) before BN normalises the whole D.
ROW_PARALLEL_SITES = ("pssa.proj", "smlp.b")


def _row_sum(y: torch.Tensor, site: str) -> torch.Tensor:
    """``y`` summed over the model group at a row-parallel site; ``y``
    itself elsewhere, and everywhere without a model group."""
    return reduce_from_model(y) if site in ROW_PARALLEL_SITES else y


def check_model_split(what: str, m: int, **dims: int) -> int:
    """``m``, where a model axis of ``m`` ranks splits each of ``dims``
    (the heads and the plan's column and row splits) evenly; else
    raises."""
    bad = {k: v for k, v in dims.items() if v % m}
    if bad:
        raise ValueError(f"{what}: a model axis of {m} does not split "
                         f"{bad} evenly")
    return m


def init_linear_bn(generator, d_in: int, d_out: int, dtype=torch.float32,
                   device="cpu"):
    params = init_linear(generator, d_in, d_out, dtype, device)
    bn_p, bn_s = init_bn(d_out, dtype, device)
    return {"linear": params, "bn": bn_p}, {"bn": bn_s}


@register_kernel("linear_bn", "eager")
def _linear_bn_eager(params, state, x, train, policy, site):
    """Dense matmul + plain BatchNorm."""
    y = _row_sum(linear_apply(params["linear"], x), site)
    y, bn_s = _bn_eager(params["bn"], state["bn"], y, train, 0.9, 1e-5,
                        policy, site)
    return y, {"bn": bn_s}


@register_kernel("linear_bn", "cuda")
def _linear_bn_cuda(params, state, x, train, policy, site):
    """Dense matmul + the ``cuda`` BatchNorm (the BN kernels in train,
    plain in eval)."""
    y = _row_sum(linear_apply(params["linear"], x), site)
    y, bn_s = _bn_cuda(params["bn"], state["bn"], y, train, 0.9, 1e-5,
                       policy, site)
    return y, {"bn": bn_s}


@register_kernel("linear_bn", "cuda+spike_mm")
def _linear_bn_spike_mm(params, state, x, train, policy, site, tile=None):
    """Bit-packed spike matmul kernel + BatchNorm.

    Inputs must be {0,1} spikes — true at every Conv1DBN site in PSSA/SMLP,
    which all consume LIF outputs. The packing constraint (contraction dim
    % 8 == 0) is resolved per site at policy-validation time
    (:func:`repro_torch.core.policy.plan_sites`); if a direct call still
    violates it, the dense path is used and the demotion is *logged*.
    ``tile`` forces the spike matmul's tile; ``None`` takes the active
    tuned table's entry for this site, or ``spike_matmul.default_tile``.
    """
    w = params["linear"]["w"]
    if x.shape[-1] % 8 == 0:
        from repro_torch.kernels import ops

        x2, shape = fold_rows(x)
        if tile is None:
            tile = lookup_tile(site, "linear_bn", "cuda+spike_mm",
                               (x2.shape[0], x2.shape[1], w.shape[-1]),
                               x.device)
        y = ops.spike_matmul_train_op(x2, w.to(x.dtype), tile)
        y = y.reshape(*shape[:-1], w.shape[-1])
    else:
        runtime_fallback(site, "cuda+spike_mm",
                         f"contraction dim {x.shape[-1]} % 8 != 0 -> dense")
        y = linear_apply(params["linear"], x)
    y = _row_sum(y, site)
    y, bn_s = _bn_cuda(params["bn"], state["bn"], y, train, 0.9, 1e-5,
                       policy, site)
    return y, {"bn": bn_s}


def _tuned_prefers_pipeline(site, op, impl, shape, packed, policy, device,
                            pipeline):
    """The active tuned table's entry for this fused-epilogue site when it
    *measured* the pipeline arm (``pipeline`` names it in the log) as
    faster than the single-launch neuron layer, else None. A site-level
    policy override pinning a fused impl wins over the table (explicit
    policy beats measurement); the demotion is logged as an expected,
    planned decision."""
    tb = tuned_lookup(site, op, impl, shape, packed, device)
    if tb is None or tb.arm != "pipeline":
        return None
    if dict(policy.overrides).get(site) in FUSED_EPILOGUE_IMPLS:
        return None
    runtime_fallback(site, impl, "tuned table prefers the pipeline arm -> "
                     f"{pipeline}", expected=True)
    return tb


def _neuron_layer_site(x3, w_mat, bn_p, bn_s, lif_cfg, train, packed):
    """Shared fused-epilogue core: ``x3 (T, M, C) @ w_mat (C, K)`` + BN +
    SOMA in ONE kernel call (``kernels/neuron_layer.py``). Train mode
    computes the batch statistics in the kernel and blends the running
    statistics (momentum 0.9, like ``_bn_cuda``); eval folds BN into the
    weights and a bias RTFormer-style, in fp32; the weights are then cast
    to ``x3.dtype`` and the bias stays fp32. Returns ``(spikes (T, M, K),
    new_bn_state)``."""
    from repro_torch.kernels import conv_spike, ops  # deferred

    lif = lif_cfg
    if train:
        spikes, mu, var = ops.neuron_layer_train_op(
            x3.contiguous(), w_mat.to(x3.dtype), bn_p["gamma"], bn_p["beta"],
            lif.alpha, lif.th_fire, lif.th_lo, lif.th_hi, lif.grad_scale,
            1e-5, packed, batch_group())
        new_bn = {"mean": 0.9 * bn_s["mean"] + 0.1 * mu,
                  "var": 0.9 * bn_s["var"] + 0.1 * var}
        return spikes, new_bn
    w_fold, bias = conv_spike.fold_bn(w_mat, bn_p["gamma"], bn_p["beta"],
                                      bn_s["mean"], bn_s["var"])
    spikes = ops.neuron_layer_eval_op(
        x3, w_fold.to(x3.dtype), bias, lif.alpha, lif.th_fire, lif.th_lo,
        lif.th_hi, lif.grad_scale, packed)
    return spikes, bn_s


@register_kernel("linear_bn", "fused_epilogue")
def _linear_bn_fused_epilogue(params, state, x, lif_cfg, train, policy, site):
    """Single-launch neuron layer: bit-packed (or dense) spike matmul +
    BatchNorm + SOMA in ONE kernel — the (T, M, K) pre-activation never
    exists in device memory.

    Extended signature (takes the LIF config of the SN it absorbs); only
    dispatched via :func:`linear_bn_lif_apply` at trailing-LIF sites. A
    ragged contraction (% 8 != 0) keeps the single launch on the dense arm,
    logged. The train arm runs at every such site: the reference demotes it
    to the pipeline on a TPU when all T*M rows of a feature block outgrow
    VMEM, a rule with no meaning on this card, whose kernel splits the
    statistics over row tiles.
    """
    x3, shape = fold_time_major(x)
    packed = x3.shape[-1] % 8 == 0
    if not packed:
        runtime_fallback(site, "fused_epilogue",
                         f"contraction dim {x3.shape[-1]} % 8 != 0 -> "
                         f"dense arm (still fused)")
    w = params["linear"]["w"]
    spikes, bn_s = _neuron_layer_site(x3, w, params["bn"], state["bn"],
                                      lif_cfg, train, packed)
    return spikes.reshape(*shape[:-1], w.shape[-1]), {"bn": bn_s}


def linear_bn_apply(params: Params, state: State, x: torch.Tensor, *,
                    train: bool, policy: ExecutionPolicy | None = None,
                    site: str = "linear_bn"):
    """The paper's Conv1DBN: spike (or real) input -> MM -> BN.

    Registered implementations: ``"eager"`` (dense + plain BN), ``"cuda"``
    (dense + BN), ``"cuda+spike_mm"`` (bit-packed spike matmul + BN). A
    ``"fused_epilogue"`` resolution cannot be honoured here — this entry
    point returns the pre-activation and there is no SN to fuse — so it
    demotes (logged as the plan predicted) to its pipeline fallback; the
    fused path lives in :func:`linear_bn_lif_apply`.

    At a row-parallel site (:data:`ROW_PARALLEL_SITES`) the product is
    summed over the model group before BN; a fused neuron layer there
    would normalise a partial sum, so a policy override pinning one at
    such a site raises on a model axis.
    """
    policy = policy if policy is not None else ExecutionPolicy()
    impl = policy.resolve(site, "linear_bn")
    if site in ROW_PARALLEL_SITES and model_group() is not None and \
            dict(policy.overrides).get(site) in FUSED_EPILOGUE_IMPLS:
        raise ValueError(
            f"site {site} is row-parallel on the model axis: a fused neuron "
            f"layer would normalise each rank's partial sum; the override "
            f"{dict(policy.overrides)[site]!r} cannot run there")
    if impl in FUSED_EPILOGUE_IMPLS:
        fb = fused_epilogue_fallback("linear_bn", impl)
        runtime_fallback(site, impl, f"no trailing LIF at this site -> {fb}",
                         expected=True)
        impl = fb
    return dispatch_kernel(site, "linear_bn", impl, params, state, x, train,
                           policy, site)


def linear_bn_lif_apply(params: Params, state: State, x: torch.Tensor,
                        lif_cfg: LIFConfig, *, train: bool,
                        policy: ExecutionPolicy | None = None,
                        site: str = "linear_bn", lif_site: str = "lif"):
    """The Conv1DBN -> SN pair (the model's "neuron layer"): matmul + BN at
    ``site`` followed by the LIF scan at ``lif_site``.

    When the policy resolves ``site`` to a fused-epilogue implementation,
    the whole pair runs as ONE launch and ``lif_site`` never dispatches —
    3 launches collapse to 1 — unless, in train mode, the active tuned
    table measured the pipeline arm as faster there. Otherwise this is the
    pipeline: ``linear_bn`` dispatch, then ``lif_scan``.

    Every arm dispatches behind the circuit breaker
    (:func:`~repro_torch.core.policy.dispatch_site`). A tripped
    fused-epilogue site falls back to the eager *pipeline*: eager
    ``linear_bn``, then ``lif_scan`` at ``lif_site`` under the policy (the
    reference's ``_pipeline("jnp")``).
    """
    policy = policy if policy is not None else ExecutionPolicy()
    impl = policy.resolve(site, "linear_bn")
    args = (params, state, x, train, policy, site)

    def pipeline(pipe_impl):
        y, st = dispatch_kernel(site, "linear_bn", pipe_impl, *args)
        return lif_scan(y, lif_cfg, site=lif_site), st

    if impl in FUSED_EPILOGUE_IMPLS and train:
        # the tuner measures the train arms: a table entry may prefer the
        # pipeline, whose spike matmul then runs the entry's tile
        fb = fused_epilogue_fallback("linear_bn", impl)
        k = params["linear"]["w"].shape[-1]
        tb = _tuned_prefers_pipeline(
            site, "linear_bn", impl,
            (x.shape[0], math.prod(x.shape[1:-1]), x.shape[-1], k),
            x.shape[-1] % 8 == 0, policy, x.device, fb)
        if tb is not None:
            y, st = dispatch_site(
                site, "linear_bn", fb,
                lambda: get_kernel("linear_bn", fb)(*args, tb.tile()),
                fallback_impl="eager",
                fallback_invoke=lambda: get_kernel("linear_bn", "eager")(
                    *args))
            return lif_scan(y, lif_cfg, site=lif_site), st
    if impl in FUSED_EPILOGUE_IMPLS:
        return dispatch_site(
            site, "linear_bn", impl,
            lambda: get_kernel("linear_bn", impl)(params, state, x, lif_cfg,
                                                  train, policy, site),
            fallback_impl="eager", fallback_invoke=lambda: pipeline("eager"))
    return pipeline(impl)


# ---------------------------------------------------------------------------
# Attention einsums (the PSSA (QK^T)V path), registry ops attn_qk / attn_av
# ---------------------------------------------------------------------------

@register_kernel("attn_qk", "eager")
def _attn_qk_eager(q, k, policy, site):
    """Spike-count scores: (T,B,h,N,dh) x (T,B,h,M,dh) -> (T,B,h,N,M)."""
    return torch.einsum("tbhnd,tbhmd->tbhnm", q, k)


def _fold_tb(x: torch.Tensor) -> torch.Tensor:
    """(T, B, h, ...) -> (T*B, h, ...) as a view where the layout allows
    (it does for the per-head views ``_split_heads`` returns), leaving the
    heads as a second batch level for the batched kernel."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


@register_kernel("attn_qk", "cuda_packed")
def _attn_qk_packed(q, k, policy, site):
    """Packed Q K^T: Q crosses device memory at 1 bit/element.

    Both operands are {0,1} LIF outputs; (T, B) and the heads form the two
    batch levels of the batched spike kernel, with K^T as the dense-side
    operand — a transposed *view*: the kernel takes its strides, nothing is
    materialised. The packing constraint is the head dim (contraction) % 8.
    """
    t, b, h, n, dh = q.shape
    m = k.shape[3]
    if dh % 8 != 0:
        runtime_fallback(site, "cuda_packed",
                         f"head dim {dh} % 8 != 0 -> eager einsum")
        return _attn_qk_eager(q, k, policy, site)
    from repro_torch.kernels import ops

    tile = lookup_tile(site, "attn_qk", "cuda_packed", (t * b * h, n, dh, m),
                       q.device)
    out = ops.spike_bmm_train_op(_fold_tb(q), _fold_tb(k).transpose(-1, -2),
                                 tile)
    return out.reshape(t, b, h, n, m)


@register_kernel("attn_av", "eager")
def _attn_av_eager(attn, v, policy, site):
    """(T,B,h,N,M) scores x (T,B,h,M,dh) spike values -> (T,B,h,N,dh)."""
    return torch.einsum("tbhnm,tbhmd->tbhnd", attn, v)


@register_kernel("attn_av", "cuda_packed")
def _attn_av_packed(attn, v, policy, site):
    """Packed (attn) V via the transpose trick.

    The spike operand here is V, which sits on the *right* of the matmul;
    the kernel packs its left operand, so compute out^T = V^T attn^T with
    V^T (dh, M) as the packed {0,1} side. The transposes are views whose
    strides the kernel takes. The packing constraint is the token count M
    (contraction) % 8.
    """
    t, b, h, n, m = attn.shape
    dh = v.shape[-1]
    if m % 8 != 0:
        runtime_fallback(site, "cuda_packed",
                         f"token count {m} % 8 != 0 -> eager einsum")
        return _attn_av_eager(attn, v, policy, site)
    from repro_torch.kernels import ops

    vt = _fold_tb(v).transpose(-1, -2)        # (TB, h, dh, M) {0,1}
    at = _fold_tb(attn).transpose(-1, -2)     # (TB, h, M, N)
    tile = lookup_tile(site, "attn_av", "cuda_packed", (t * b * h, dh, m, n),
                       v.device)
    out_t = ops.spike_bmm_train_op(vt, at, tile)    # (TB, h, dh, N)
    return out_t.transpose(-1, -2).reshape(t, b, h, n, dh)


# ---------------------------------------------------------------------------
# PSSA: Pre-activation Spiking Self-Attention (eq. 8-10)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PSSAConfig:
    d_model: int
    n_heads: int
    lif: LIFConfig = LIFConfig()
    # QK^T V scaling factor s (Spikformer uses 0.125)
    scale: float = 0.125
    # True: (Q K^T) V as in the paper's energy model (2 S^2 d_h term).
    # False: Q (K^T V) — algebraically identical (no softmax!), O(S d^2).
    qk_first: bool = True
    policy: ExecutionPolicy = ExecutionPolicy()

    @property
    def lif_cfg(self) -> LIFConfig:
        """The LIF config with this layer's policy injected (single switch)."""
        return dataclasses.replace(self.lif, policy=self.policy)


def init_pssa(generator, cfg: PSSAConfig, dtype=torch.float32, device="cpu"):
    d = cfg.d_model
    ps, ss = {}, {}
    for name in ("q", "k", "v", "z"):
        ps[name], ss[name] = init_linear_bn(generator, d, d, dtype, device)
    return ps, ss


def _split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    t, b, n, d = x.shape
    return x.reshape(t, b, n, h, d // h).permute(0, 1, 3, 2, 4)  # (T,B,h,N,dh)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    t, b, h, n, dh = x.shape
    return x.permute(0, 1, 3, 2, 4).reshape(t, b, n, h * dh)


def pssa_apply(params: Params, state: State, x: torch.Tensor, cfg: PSSAConfig,
               *, train: bool):
    """x: (T,B,N,D) real-valued features -> (T,B,N,D); residual added by
    caller.

    On a model axis of M (the ambient mesh), Megatron's attention: Q, K, V
    column-parallel (the rank's D/M output columns with their BN), the
    rank's h/M heads, the projection Z row-parallel (its partial product
    summed over the group before BN, which runs on the whole D)."""
    pol = cfg.policy
    m = check_model_split("PSSA", model_coord()[1], d_model=cfg.d_model,
                          n_heads=cfg.n_heads)
    xs = lif_scan(x, cfg.lif_cfg, site="pssa.lif")              # eq. 8
    xs = copy_to_model(xs)
    # eq. 9: each Conv1DBN -> SN pair is one "neuron layer" — under a
    # fused-epilogue policy the matmul+BN+SOMA run as a single launch.
    qs, s_q = linear_bn_lif_apply(params["q"], state["q"], xs, cfg.lif_cfg,
                                  train=train, policy=pol, site="pssa.qkv",
                                  lif_site="pssa.lif")
    ks, s_k = linear_bn_lif_apply(params["k"], state["k"], xs, cfg.lif_cfg,
                                  train=train, policy=pol, site="pssa.qkv",
                                  lif_site="pssa.lif")
    vs, s_v = linear_bn_lif_apply(params["v"], state["v"], xs, cfg.lif_cfg,
                                  train=train, policy=pol, site="pssa.qkv",
                                  lif_site="pssa.lif")

    qh, kh, vh = (_split_heads(a, cfg.n_heads // m) for a in (qs, ks, vs))
    if cfg.qk_first:
        attn = dispatch_kernel("attn_qk", "attn_qk",
                               pol.resolve("attn_qk", "attn_qk"),
                               qh, kh, pol, "attn_qk")           # spike counts
        out = dispatch_kernel("attn_av", "attn_av",
                              pol.resolve("attn_av", "attn_av"),
                              attn, vh, pol, "attn_av")
    else:  # exact reassociation (no softmax): K^T V first — kv is dense
        kv = torch.einsum("tbhmd,tbhme->tbhde", kh, vh)
        out = torch.einsum("tbhnd,tbhde->tbhne", qh, kv)
    out = _merge_heads(out) * cfg.scale                          # eq. 10
    out_s = lif_scan(out, cfg.lif_cfg, site="pssa.lif")          # SN(...)
    z, s_z = linear_bn_apply(params["z"], state["z"], out_s, train=train,
                             policy=pol, site="pssa.proj")
    return z, {"q": s_q, "k": s_k, "v": s_v, "z": s_z}


# ---------------------------------------------------------------------------
# Spiking MLP (Fig. 2: Linear A -> BN -> SN -> Linear B -> BN)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SMLPConfig:
    d_model: int
    d_ff: int
    lif: LIFConfig = LIFConfig()
    policy: ExecutionPolicy = ExecutionPolicy()

    @property
    def lif_cfg(self) -> LIFConfig:
        return dataclasses.replace(self.lif, policy=self.policy)


def init_smlp(generator, cfg: SMLPConfig, dtype=torch.float32, device="cpu"):
    pa, sa = init_linear_bn(generator, cfg.d_model, cfg.d_ff, dtype, device)
    pb, sb = init_linear_bn(generator, cfg.d_ff, cfg.d_model, dtype, device)
    return {"a": pa, "b": pb}, {"a": sa, "b": sb}


def smlp_apply(params: Params, state: State, x: torch.Tensor, cfg: SMLPConfig,
               *, train: bool):
    """On a model axis: A column-parallel (d_ff/M hidden features), B
    row-parallel (summed over the group before its BN)."""
    pol = cfg.policy
    check_model_split("SMLP", model_coord()[1], d_ff=cfg.d_ff)
    xs = copy_to_model(lif_scan(x, cfg.lif_cfg, site="smlp.lif"))
    hs, s_a = linear_bn_lif_apply(params["a"], state["a"], xs, cfg.lif_cfg,
                                  train=train, policy=pol, site="smlp.a",
                                  lif_site="smlp.lif")
    y, s_b = linear_bn_apply(params["b"], state["b"], hs, train=train,
                             policy=pol, site="smlp.b")
    return y, {"a": s_a, "b": s_b}


# ---------------------------------------------------------------------------
# Spiking Transformer block (eq. 5-6, MS residual adds)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockConfig:
    d_model: int
    n_heads: int
    d_ff: int
    lif: LIFConfig = LIFConfig()
    qk_first: bool = True
    attn_scale: float = 0.125
    policy: ExecutionPolicy = ExecutionPolicy()   # one switch for the block

    @property
    def pssa(self) -> PSSAConfig:
        return PSSAConfig(self.d_model, self.n_heads, self.lif,
                          self.attn_scale, self.qk_first, policy=self.policy)

    @property
    def smlp(self) -> SMLPConfig:
        return SMLPConfig(self.d_model, self.d_ff, self.lif,
                          policy=self.policy)


def init_block(generator, cfg: BlockConfig, dtype=torch.float32,
               device="cpu"):
    p_attn, s_attn = init_pssa(generator, cfg.pssa, dtype, device)
    p_mlp, s_mlp = init_smlp(generator, cfg.smlp, dtype, device)
    return {"pssa": p_attn, "smlp": p_mlp}, {"pssa": s_attn, "smlp": s_mlp}


def block_apply(params: Params, state: State, x: torch.Tensor,
                cfg: BlockConfig, *, train: bool):
    a, s_attn = pssa_apply(params["pssa"], state["pssa"], x, cfg.pssa,
                           train=train)
    x = x + a                                        # eq. 5 (RES, MS Add)
    m, s_mlp = smlp_apply(params["smlp"], state["smlp"], x, cfg.smlp,
                          train=train)
    x = x + m                                        # eq. 6 (RES)
    return x, {"pssa": s_attn, "smlp": s_mlp}
