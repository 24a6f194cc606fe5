"""LIF SOMA forward kernel (E2ATST Fig. 4, eq. 11) for Hopper.

Replaces ``repro.kernels.lif_soma.lif_soma_fwd`` (``_lif_fwd_kernel``): the
membrane potential stays in registers across all T steps of one launch, and
only the input currents and the persisted signals (spikes S, potentials U,
surrogate mask) cross device memory.

Bound on this card: bytes. One read and three writes of (T, M, D) fp32 and
about six operations per element, so the design is one thread per four
neighbouring elements with 16-byte accesses (``csrc/lif_soma.cu``); a scalar
kernel serves shapes where ``M * D`` is not a multiple of four.

The plain PyTorch version, :func:`lif_soma_fwd_plain`, is the same
recursion as a Python loop over T. The wrapper uses it for a CPU tensor and
never for a CUDA tensor.
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


#: Kernel launches since the count was last set to 0 (plain-version calls do
#: not count).
lif_soma_fwd.launches = 0
