"""LIF spiking neuron with surrogate-gradient BPTT (E2ATST eq. 1-3, 11-12).

Forward dynamics (hard reset, as in the paper's eq. 11):

    U_t = alpha * U_{t-1} * (1 - S_{t-1}) + X_t
    S_t = Heaviside(U_t - th_f)

Backward (eq. 12) falls out of autograd through the loop over T once the
non-differentiable Heaviside is given a rectangular surrogate (:func:`fire`):

    fire'(U) = grad_scale  if th_lo < U < th_hi,  0 otherwise

The reset path stays attached (``s_prev`` is never detached), so the
-alpha*U_t term of the paper's grad-S_t recursion is in the gradient.

``LIFConfig.policy`` selects the execution path for ``lif_scan`` through the
kernel registry: the ``"eager"`` implementation is a Python loop over T in
plain tensor code; ``"cuda"`` runs the SOMA/GRAD kernel pair
(``repro_torch.kernels.ops.lif_soma_op``), whose backward *is* eq. 12, on
the (T, M, D) input as it is (folded where it is not 3-D). The
state-carrying ``lif_state`` op (temporal tiling, streaming, decode) starts
the SOMA kernel from the carried state and seeds the GRAD kernel with the
carry's cotangent.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from repro_torch.core.policy import (ExecutionPolicy, dispatch_kernel,
                                     register_kernel, runtime_fallback)


@dataclasses.dataclass(frozen=True)
class LIFConfig:
    """LIF neuron hyper-parameters (paper defaults) + execution policy."""

    alpha: float = 0.5          # leakage factor (1 - 1/tau with tau=2)
    th_fire: float = 1.0        # firing threshold th_f
    th_lo: float = 0.0          # surrogate window lower bound
    th_hi: float = 2.0          # surrogate window upper bound
    grad_scale: float = 1.0     # surrogate magnitude inside the window
    # Temporal tiling: split the T axis into chunks of this length, carrying
    # (U, S) across chunk boundaries. None/0 = single-shot scan.
    time_chunk: int | None = None
    policy: ExecutionPolicy = ExecutionPolicy()

    def with_policy(self, policy: ExecutionPolicy) -> "LIFConfig":
        return dataclasses.replace(self, policy=policy)


class _Fire(torch.autograd.Function):
    """Heaviside forward, rectangular surrogate backward."""

    @staticmethod
    def forward(ctx, u, th_fire, th_lo, th_hi, grad_scale):
        if ctx.needs_input_grad[0]:     # no mask to keep in eval
            ctx.save_for_backward(((u > th_lo) & (u < th_hi)).to(u.dtype)
                                  * grad_scale)
        return (u >= th_fire).to(u.dtype)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return g * mask, None, None, None, None


def fire(u: torch.Tensor, th_fire: float, th_lo: float, th_hi: float,
         grad_scale: float) -> torch.Tensor:
    """Heaviside spike with rectangular surrogate gradient.

    Returns S = 1[u >= th_fire] in u.dtype; the backward multiplies the
    cotangent by the spike-gradient mask  grad_scale * 1[th_lo < u < th_hi].
    """
    return _Fire.apply(u, th_fire, th_lo, th_hi, grad_scale)


def spike_grad_mask(u: torch.Tensor, cfg: LIFConfig) -> torch.Tensor:
    """The paper's \\nabla\\tilde{S}: 1 inside the surrogate window (stored
    by the SOMA unit during FP, consumed by GRAD during BP)."""
    return ((u > cfg.th_lo) & (u < cfg.th_hi)).to(u.dtype)


def lif_step(u_prev: torch.Tensor, s_prev: torch.Tensor, x: torch.Tensor,
             cfg: LIFConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """One SOMA step (eq. 11): returns (U_t, S_t)."""
    u = cfg.alpha * u_prev * (1.0 - s_prev) + x
    s = fire(u, cfg.th_fire, cfg.th_lo, cfg.th_hi, cfg.grad_scale)
    return u, s


@register_kernel("lif", "eager")
def _lif_scan_eager(x_seq: torch.Tensor, cfg: LIFConfig,
                    site: str) -> torch.Tensor:
    """Reference implementation: a loop over the leading time axis, with
    the surrogate gradient through autograd."""
    u = torch.zeros_like(x_seq[0])
    s = torch.zeros_like(x_seq[0])
    spikes = []
    for t in range(x_seq.shape[0]):
        u, s = lif_step(u, s, x_seq[t], cfg)
        spikes.append(s)
    return torch.stack(spikes)


@register_kernel("lif", "cuda")
def _lif_scan_cuda(x_seq: torch.Tensor, cfg: LIFConfig,
                   site: str) -> torch.Tensor:
    """Kernel dispatch: run the SOMA op (GRAD kernel in its backward) on
    the (T, M, D) input (:func:`_time_major_3d`), and unfold. LIF is
    elementwise over the folded axes so the reshape is exact."""
    from repro_torch.kernels import ops  # deferred: eager stays import-light

    if x_seq.ndim < 2:   # the kernel needs a (T, M, D)-foldable input
        runtime_fallback(site, "cuda",
                         f"input ndim {x_seq.ndim} < 2 -> eager scan")
        return _lif_scan_eager(x_seq, cfg, site)
    x3, shape = _time_major_3d(x_seq)
    s = ops.lif_soma_op(x3, cfg.alpha, cfg.th_fire, cfg.th_lo, cfg.th_hi,
                        cfg.grad_scale)
    return s.reshape(shape)


def _time_major_3d(x_seq: torch.Tensor):
    """The kernels' (T, M, D) operand and ``x_seq``'s shape. A 3-D input
    whose last axis has unit stride goes as it is, in any layout of T and
    M (the LM's (S, B, D) view of its (B, S, D) branch output is read in
    place, and the spikes come back in that layout); anything else is
    folded (``fold_time_major``), and copied explicitly where the fold
    leaves D strided."""
    from repro_torch.core.backend import fold_time_major
    from repro_torch.kernels.lif_soma import unit_d

    x3, shape = (x_seq, tuple(x_seq.shape)) if x_seq.ndim == 3 else \
        fold_time_major(x_seq)
    return (x3 if unit_d(x3) else x3.contiguous()), shape


@register_kernel("lif_state", "eager")
def _lif_state_eager(x_seq: torch.Tensor, u0: torch.Tensor, s0: torch.Tensor,
                     cfg: LIFConfig, site: str):
    """Reference stateful scan: carries (U, S) in and out."""
    u, s = u0, s0
    spikes = []
    for t in range(x_seq.shape[0]):
        u, s = lif_step(u, s, x_seq[t], cfg)
        spikes.append(s)
    return torch.stack(spikes), (u, s)


@register_kernel("lif_state", "cuda")
def _lif_state_cuda(x_seq: torch.Tensor, u0: torch.Tensor, s0: torch.Tensor,
                    cfg: LIFConfig, site: str):
    """Stateful SOMA on the kernel: one launch starts from the carried
    state and writes the final one; the GRAD kernel is seeded with the
    carry's cotangent. The input goes as :func:`_time_major_3d` says."""
    from repro_torch.kernels import ops

    if x_seq.ndim < 2:
        runtime_fallback(site, "cuda",
                         f"input ndim {x_seq.ndim} < 2 -> eager stateful scan")
        return _lif_state_eager(x_seq, u0, s0, cfg, site)
    x3, shape = _time_major_3d(x_seq)
    state_fold = x3.shape[1:]
    s, u_last, s_last = ops.lif_soma_carry_op(
        x3, u0.reshape(state_fold), s0.reshape(state_fold), cfg.alpha,
        cfg.th_fire, cfg.th_lo, cfg.th_hi, cfg.grad_scale)
    return s.reshape(shape), (u_last.reshape(shape[1:]),
                              s_last.reshape(shape[1:]))


def lif_scan_with_state(x_seq: torch.Tensor, u0: torch.Tensor,
                        s0: torch.Tensor, cfg: LIFConfig, site: str = "lif"):
    """Stateful variant for streaming and temporal tiling: carries (U, S)
    across calls through the ``lif_state`` registry row; chunk-by-chunk
    application matches a single :func:`lif_scan` exactly, gradients
    included."""
    impl = cfg.policy.resolve(site, "lif_state")
    return dispatch_kernel(site, "lif_state", impl, x_seq, u0, s0, cfg, site)


def lif_decode_step(x: torch.Tensor, u0: torch.Tensor, s0: torch.Tensor,
                    cfg: LIFConfig, site: str = "lif"):
    """Single-token serving step: one eq. 11 SOMA update from carried (U, S).

    The T=1 twin of :func:`lif_scan_with_state`, used by the LM decode path:
    ``x`` is this step's membrane input (any shape), ``u0``/``s0`` the state
    persisted in the serving engine's slot cache. Returns
    ``(spikes, (u_next, s_next))``. Dispatch follows the site's
    ``lif_state`` resolution: ``"cuda"`` runs the stateful SOMA kernel
    (:func:`repro_torch.kernels.ops.lif_soma_step_op`) on ``x`` folded to
    (-1, D), whatever its rank (a 0-D input has no feature axis and
    raises); anything else runs the plain :func:`lif_step`. Step-by-step
    application is exactly the stateful scan, so decode continues the
    full-sequence forward token for token.
    """
    impl = cfg.policy.resolve(site, "lif_state")
    if impl == "cuda":
        if x.ndim == 0:
            raise ValueError(f"lif_decode_step at {site!r}: a 0-D input has "
                             "no feature axis to fold to (M, D)")
        from repro_torch.kernels import ops
        x2 = x.reshape(-1, x.shape[-1])
        s, u_next, s_next = ops.lif_soma_step_op(
            x2, u0.reshape(x2.shape), s0.reshape(x2.shape), cfg.alpha,
            cfg.th_fire, cfg.th_lo, cfg.th_hi, cfg.grad_scale)
        return s.reshape(x.shape), (u_next.reshape(x.shape),
                                    s_next.reshape(x.shape))
    u, s = lif_step(u0, s0, x, cfg)
    return s, (u, s)


def _lif_scan_chunked(x_seq: torch.Tensor, cfg: LIFConfig,
                      site: str) -> torch.Tensor:
    """Temporally-tiled BPTT scan: a loop over T/time_chunk chunks, each
    running the stateful op with the carried (U, S) under
    ``torch.utils.checkpoint``.

    The checkpoint drops the per-step residuals inside a chunk (they are
    recomputed during the backward), so what is kept between forward and
    backward is the (U, S) carry at the chunk boundaries — the paper's
    temporal-blocking memory profile — while the gradients stay exact.
    """
    tc = cfg.time_chunk
    u = s = torch.zeros_like(x_seq[0])
    out = []
    for i in range(0, x_seq.shape[0], tc):
        chunk = x_seq[i:i + tc]
        if torch.is_grad_enabled():
            spikes, (u, s) = torch.utils.checkpoint.checkpoint(
                lif_scan_with_state, chunk, u, s, cfg, site,
                use_reentrant=False)
        else:
            spikes, (u, s) = lif_scan_with_state(chunk, u, s, cfg, site)
        out.append(spikes)
    return torch.cat(out)


def lif_scan(x_seq: torch.Tensor, cfg: LIFConfig,
             site: str = "lif") -> torch.Tensor:
    """Multi-step LIF over the leading time axis.

    x_seq: (T, ...) membrane input currents (post-BN, per eq. 11). Returns
    spikes (T, ...) with the same dtype. State starts at rest (0). This is
    the BPTT-differentiable SOMA module: autograd through it is the GRAD
    recursion of eq. 12 (under a ``"cuda"`` policy, the GRAD kernel).
    ``site`` names this call site for per-site policy overrides (the model
    passes ``"tokenizer.lif"``/``"pssa.lif"``/``"smlp.lif"``). Under a
    ``"fused_epilogue"`` policy the matmul-fed SN sites never reach this
    function: their SOMA runs inside the neuron-layer kernel.

    With ``cfg.time_chunk`` set (and < T, dividing T), the scan is
    temporally tiled (:func:`_lif_scan_chunked`); outputs and gradients
    equal the single-shot scan's.
    """
    tc = cfg.time_chunk
    t = x_seq.shape[0]
    if tc and 0 < tc < t:
        if t % tc == 0:
            # The tiled path dispatches the state-carrying twin op, as the
            # plan reports for the lif sites under tiling.
            return _lif_scan_chunked(x_seq, cfg, site)
        runtime_fallback(site, "lif_state",
                         f"T={t} % time_chunk={tc} != 0 -> single-shot scan")
    return dispatch_kernel(site, "lif", cfg.policy.resolve(site, "lif"),
                           x_seq, cfg, site)


def lif_reference_manual_grad(x_seq: torch.Tensor, g_seq: torch.Tensor,
                              cfg: LIFConfig) -> torch.Tensor:
    """Hand-rolled eq. 12 BPTT for testing: given upstream dL/dS_t (g_seq),
    return dL/dX_t. Mirrors the hardware GRAD unit:

        grad_S_t = g_t - alpha * U_t * grad_U_{t+1}
        grad_U_t = grad_U_{t+1} * alpha * (1 - S_t) + grad_S_t * fire'(U_t)
        dL/dX_t  = grad_U_t           (since dU_t/dX_t = 1)
    """
    T = x_seq.shape[0]
    us, ss = [], []
    u = torch.zeros_like(x_seq[0])
    s = torch.zeros_like(x_seq[0])
    for t in range(T):
        u = cfg.alpha * u * (1.0 - s) + x_seq[t]
        s = (u >= cfg.th_fire).to(u.dtype)
        us.append(u)
        ss.append(s)
    grads = [None] * T
    grad_u_next = torch.zeros_like(x_seq[0])
    for t in reversed(range(T)):
        mask = spike_grad_mask(us[t], cfg) * cfg.grad_scale
        grad_s = g_seq[t] - cfg.alpha * us[t] * grad_u_next
        grad_u = grad_u_next * cfg.alpha * (1.0 - ss[t]) + grad_s * mask
        grads[t] = grad_u
        grad_u_next = grad_u
    return torch.stack(grads)
