"""LIF spiking neuron, forward (E2ATST eq. 1-3, 11).

Forward dynamics (hard reset, as in the paper's eq. 11):

    U_t = alpha * U_{t-1} * (1 - S_{t-1}) + X_t
    S_t = Heaviside(U_t - th_f)

``LIFConfig.policy`` selects the execution path for ``lif_scan`` through the
kernel registry: the ``"eager"`` implementation is a Python loop over T in
plain tensor code; ``"cuda"`` folds the input to (T, M, D) and runs the
SOMA kernel (``repro_torch.kernels.ops.lif_soma_op``).

Forward only: the surrogate gradient (``fire``'s rectangular window, eq. 12)
arrives with the training slice. ``th_lo``/``th_hi``/``grad_scale`` are kept
in the config so that parameters and plans stay comparable. The
state-carrying ``lif_state`` op (temporal tiling, streaming) has its forward
here too: it folds the carried state into the first step and reuses the
SOMA kernel.
"""
from __future__ import annotations

import dataclasses

import torch

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


def lif_step(u_prev: torch.Tensor, s_prev: torch.Tensor, x: torch.Tensor,
             cfg: LIFConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """One SOMA step (eq. 11): returns (U_t, S_t)."""
    u = cfg.alpha * u_prev * (1.0 - s_prev) + x
    s = (u >= cfg.th_fire).to(u.dtype)
    return u, s


@register_kernel("lif", "eager")
def _lif_scan_eager(x_seq: torch.Tensor, cfg: LIFConfig,
                    site: str) -> torch.Tensor:
    """Reference implementation: a loop over the leading time axis."""
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
    """Kernel dispatch: fold (T, ..., D) -> (T, M, D), run the SOMA op, and
    unfold. LIF is elementwise over the folded axes so the reshape is
    exact."""
    from repro_torch.core.backend import fold_time_major
    from repro_torch.kernels import ops  # deferred: eager stays import-light

    if x_seq.ndim < 2:   # the kernel needs a (T, M, D)-foldable input
        runtime_fallback(site, "cuda",
                         f"input ndim {x_seq.ndim} < 2 -> eager scan")
        return _lif_scan_eager(x_seq, cfg, site)
    x3, shape = fold_time_major(x_seq.contiguous())
    s = ops.lif_soma_op(x3, cfg.alpha, cfg.th_fire, cfg.th_lo, cfg.th_hi,
                        cfg.grad_scale)
    return s.reshape(shape)


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
    """Stateful SOMA on the kernel: the carried state folds into the first
    input step, so the SOMA kernel itself is unchanged."""
    from repro_torch.core.backend import fold_time_major
    from repro_torch.kernels import ops

    if x_seq.ndim < 2:
        runtime_fallback(site, "cuda",
                         f"input ndim {x_seq.ndim} < 2 -> eager stateful scan")
        return _lif_state_eager(x_seq, u0, s0, cfg, site)
    x3, shape = fold_time_major(x_seq.contiguous())
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
    application matches a single :func:`lif_scan` exactly."""
    impl = cfg.policy.resolve(site, "lif_state")
    return dispatch_kernel(site, "lif_state", impl, x_seq, u0, s0, cfg, site)


def lif_scan(x_seq: torch.Tensor, cfg: LIFConfig,
             site: str = "lif") -> torch.Tensor:
    """Multi-step LIF over the leading time axis.

    x_seq: (T, ...) membrane input currents (post-BN, per eq. 11). Returns
    spikes (T, ...) with the same dtype. State starts at rest (0). ``site``
    names this call site for per-site policy overrides (the model passes
    ``"tokenizer.lif"``/``"pssa.lif"``/``"smlp.lif"``). Under a
    ``"fused_epilogue"`` policy the matmul-fed SN sites never reach this
    function: their SOMA runs inside the neuron-layer kernel.
    """
    tc = cfg.time_chunk
    t = x_seq.shape[0]
    if tc and 0 < tc < t:
        if t % tc == 0:
            # The tiled path dispatches the state-carrying twin op, as the
            # plan reports for the lif sites under tiling. Forward only:
            # the values equal the single-shot scan's.
            u = s = torch.zeros_like(x_seq[0])
            out = []
            for i in range(0, t, tc):
                spikes, (u, s) = lif_scan_with_state(x_seq[i:i + tc], u, s,
                                                     cfg, site)
                out.append(spikes)
            return torch.cat(out)
        runtime_fallback(site, "lif_state",
                         f"T={t} % time_chunk={tc} != 0 -> single-shot scan")
    return dispatch_kernel(site, "lif", cfg.policy.resolve(site, "lif"),
                           x_seq, cfg, site)
