"""LIF SOMA/GRAD kernels (E2ATST Fig. 4, eq. 11-12) for Hopper.

``lif_soma_fwd`` replaces ``repro.kernels.lif_soma.lif_soma_fwd``
(``_lif_fwd_kernel``): the membrane potential stays in registers across all
T steps of one launch, and only the input currents and the persisted signals
(spikes S, potentials U, surrogate mask) cross device memory.

``lif_soma_bwd`` replaces ``repro.kernels.lif_soma.lif_soma_bwd``
(``_lif_bwd_kernel``, and ``_lif_bwd_carry_kernel`` when ``gu_last`` is
given): the eq. 12 recursion walks T in reverse with dL/dU_{t+1} in
registers, reading g, U, S and the mask once and writing dL/dX once. The
carry variant is the same kernel with a nullable pointer: ``gu_last`` is
added to dL/dU at t = T-1.

Bound on this card: bytes, for both. The forward reads one and writes three
(T, M, D) fp32 tensors, the backward reads four (five with ``gu_last``'s
one step) and writes one, at about six operations per element. The design
is one thread per four neighbouring elements with 16-byte accesses
(``csrc/lif_soma.cu``); a scalar kernel serves shapes where ``M * D`` is not
a multiple of four. The arithmetic uses the round-to-nearest intrinsics, so
each kernel equals its plain version bit for bit.

The plain PyTorch versions, :func:`lif_soma_fwd_plain` and
:func:`lif_soma_bwd_plain`, are the same recursions as Python loops over T.
The wrappers use them for a CPU tensor and never for a CUDA tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def lif_soma_fwd_plain(x: torch.Tensor, *, alpha: float = 0.5,
                       th_fire: float = 1.0, th_lo: float = 0.0,
                       th_hi: float = 2.0):
    """x: (T, ...) -> (spikes, U_seq, grad_mask), eq. 11, plain tensor code."""
    u = torch.zeros_like(x[0])
    s = torch.zeros_like(x[0])
    ss, us, ms = [], [], []
    for t in range(x.shape[0]):
        u = alpha * u * (1.0 - s) + x[t]
        s = (u >= th_fire).to(x.dtype)
        ss.append(s)
        us.append(u)
        ms.append(((u > th_lo) & (u < th_hi)).to(x.dtype))
    return torch.stack(ss), torch.stack(us), torch.stack(ms)


def lif_soma_bwd_plain(g: torch.Tensor, u_seq: torch.Tensor,
                       spikes: torch.Tensor, mask: torch.Tensor,
                       gu_last: torch.Tensor | None = None, *,
                       alpha: float = 0.5, grad_scale: float = 1.0):
    """GRAD (eq. 12), plain tensor code: upstream dL/dS (T, ...) and the
    persisted (U, S, mask) -> dL/dX. ``gu_last`` (...), when given, is a
    direct cotangent on the final membrane U_{T-1}, added at t = T-1."""
    grad_u_next = torch.zeros_like(g[0])
    dx = [None] * g.shape[0]
    for t in reversed(range(g.shape[0])):
        grad_s = g[t] - alpha * u_seq[t] * grad_u_next
        grad_u = (grad_u_next * alpha * (1.0 - spikes[t])
                  + grad_s * mask[t] * grad_scale)
        if gu_last is not None and t == g.shape[0] - 1:
            grad_u = grad_u + gu_last
        dx[t] = grad_u
        grad_u_next = grad_u
    return torch.stack(dx)


def _launch_lif_soma_fwd(x, alpha, th_fire, th_lo, th_hi, stream=0):
    s, u, mask = (torch.empty_like(x) for _ in range(3))
    t = x.shape[0]
    code = build.load().e2a_lif_soma_fwd(
        x.data_ptr(), s.data_ptr(), u.data_ptr(), mask.data_ptr(),
        x.numel() // max(t, 1), t, alpha, th_fire, th_lo, th_hi, stream)
    build.check_launch(code, "lif_soma_fwd")
    return s, u, mask


def lif_soma_fwd(x: torch.Tensor, *, alpha: float = 0.5, th_fire: float = 1.0,
                 th_lo: float = 0.0, th_hi: float = 2.0):
    """x: (T, M, D) input currents -> (spikes, U_seq, grad_mask), all
    (T, M, D) in ``x.dtype``. A CUDA tensor launches the kernel (fp32,
    contiguous; anything else raises); a CPU tensor takes the plain version.
    """
    if x.ndim != 3:
        raise ValueError(f"lif_soma_fwd expects (T, M, D), got {tuple(x.shape)}")
    if not x.is_cuda:
        return lif_soma_fwd_plain(x, alpha=alpha, th_fire=th_fire,
                                  th_lo=th_lo, th_hi=th_hi)
    if x.dtype != torch.float32:
        raise TypeError(f"lif_soma_fwd kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("lif_soma_fwd kernel takes a contiguous tensor")
    with torch.cuda.device(x.device):
        out = _launch_lif_soma_fwd(
            x, alpha, th_fire, th_lo, th_hi,
            torch.cuda.current_stream().cuda_stream)
    lif_soma_fwd.launches += 1
    return out


def lif_soma_bwd(g: torch.Tensor, u_seq: torch.Tensor, spikes: torch.Tensor,
                 mask: torch.Tensor, gu_last: torch.Tensor | None = None, *,
                 alpha: float = 0.5, grad_scale: float = 1.0) -> torch.Tensor:
    """GRAD: upstream dL/dS (T, M, D) + persisted (U, S, mask) -> dL/dX
    (T, M, D). ``gu_last`` (M, D), when given, is the direct cotangent on
    the final membrane U_{T-1} (the carry handed back by the next temporal
    tile's backward). A CUDA tensor launches the kernel (fp32, contiguous;
    anything else raises); a CPU tensor takes the plain version."""
    if g.ndim != 3:
        raise ValueError(f"lif_soma_bwd expects (T, M, D), got {tuple(g.shape)}")
    signals = (u_seq, spikes, mask)
    if any(a.shape != g.shape for a in signals):
        raise ValueError("lif_soma_bwd: g, U, S and mask differ in shape")
    if gu_last is not None and gu_last.shape != g.shape[1:]:
        raise ValueError(f"gu_last shape {tuple(gu_last.shape)} != "
                         f"{tuple(g.shape[1:])}")
    if not g.is_cuda:
        return lif_soma_bwd_plain(g, u_seq, spikes, mask, gu_last,
                                  alpha=alpha, grad_scale=grad_scale)
    operands = (g,) + signals + ((gu_last,) if gu_last is not None else ())
    if any(a.dtype != torch.float32 for a in operands):
        raise TypeError("lif_soma_bwd kernel takes float32 operands")
    if any(not a.is_contiguous() or a.device != g.device for a in operands):
        raise ValueError("lif_soma_bwd kernel takes contiguous operands on "
                         "one device")
    dx = torch.empty_like(g)
    with torch.cuda.device(g.device):
        code = build.load().e2a_lif_soma_bwd(
            g.data_ptr(), u_seq.data_ptr(), spikes.data_ptr(),
            mask.data_ptr(), gu_last.data_ptr() if gu_last is not None
            else None, dx.data_ptr(), g.numel() // max(g.shape[0], 1),
            g.shape[0], alpha, grad_scale,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, "lif_soma_bwd")
    lif_soma_bwd.launches += 1
    return dx


#: Kernel launches since the count was last set to 0 (plain-version calls do
#: not count).
lif_soma_fwd.launches = 0
lif_soma_bwd.launches = 0
