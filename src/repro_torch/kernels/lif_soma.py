"""LIF SOMA/GRAD kernels (E2ATST Fig. 4, eq. 11-12) for Hopper.

``lif_soma_fwd`` replaces ``repro.kernels.lif_soma.lif_soma_fwd``
(``_lif_fwd_kernel``): the membrane potential stays in registers across all
T steps of one launch, and only the input currents and the persisted signals
(spikes S, potentials U, surrogate mask) cross device memory. Given a
carried state ``(u0, s0)`` it starts from it instead of rest and also
writes the final ``(u_last, s_last)``: the stateful op (temporal tiling,
the LM's decode step) is one launch.

``lif_soma_bwd`` replaces ``repro.kernels.lif_soma.lif_soma_bwd``
(``_lif_bwd_kernel``, and ``_lif_bwd_carry_kernel`` when ``gu_last`` is
given): the eq. 12 recursion walks T in reverse with dL/dU_{t+1} in
registers, reading g, U, S and the mask once and writing dL/dX once. The
carry variant is the same kernel with a nullable pointer: ``gu_last`` is
added to dL/dU at t = T-1.

Two arms (``csrc/lif_soma.cu``; :func:`choose_arm` chooses). The ring arm, one
thread per element with each thread's input steps staged through a
``cp.async`` ring of time chunks in shared memory, serves long T at few
elements (the spiking LM's (S, B, 1024), bound by the T steps of the serial
recursion), a carried state, and every layout with unit stride on D: a
(S, B, D) view of a (B, S, D) tensor is read in place, and S, U, mask and dx
come back in their input's layout (``torch.empty_like``). The flat arm, a
thread per four elements with 16-byte accesses, serves few steps or many
elements on contiguous operands (the Spikingformer's (4, 196 * B, 512),
bound by bytes). The arithmetic uses the round-to-nearest intrinsics, so each
kernel equals its plain version bit for bit.

The plain PyTorch versions, :func:`lif_soma_fwd_plain` and
:func:`lif_soma_bwd_plain`, are the same recursions as Python loops over T,
with the same optional state and the same output layouts. The wrappers use
them for a CPU tensor and never for a CUDA tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: The flat arm serves contiguous calls without a carried state of at most
#: FLAT_MAX_T steps or of at least FLAT_MIN_N = M * D elements; the ring arm
#: every other call. Measured on the H100 (``bench_lif_kernels.py``,
#: PERF.md): the flat arm is as fast or faster at T = 1 (the ring adds a
#: trip through shared memory to the one step's load), at T = 4 with the L2
#: warm, and, at T = 1 .. 128, from 262,144 elements up (bound by bytes
#: once its 4-element threads fill the SMs); the ring arm faster at 65,536
#: elements from T = 16 (bound by the serial walk), and from T = 4 with
#: the L2 cold. The Spikingformer's T = 4 calls keep the flat arm: below
#: 262,144 elements (under three images) their input comes warm in L2 from
#: the kernel that wrote it.
FLAT_MAX_T = 4
FLAT_MIN_N = 1 << 18
_ARM_CODE = {"flat": 1, "ring": 2}


def choose_arm(t: int, n: int, contiguous: bool, carry: bool = False) -> str:
    """The arm a call of T = ``t`` steps over ``n`` = M * D elements takes:
    ``"flat"`` for few steps or many elements on contiguous operands
    without a carried state, else ``"ring"``."""
    if contiguous and not carry and (t <= FLAT_MAX_T or n >= FLAT_MIN_N):
        return "flat"
    return "ring"


def strides(a: torch.Tensor) -> tuple[int, int]:
    """(stride_t, stride_m) of a (T, M, D) operand, in elements; 0 for an
    axis of one element, which the kernel never steps over."""
    return tuple(st if size > 1 else 0
                 for size, st in zip(a.shape[:2], a.stride()[:2]))


def unit_d(a: torch.Tensor) -> bool:
    """Whether D, the last axis, has unit stride (the kernels' one rule)."""
    return a.shape[2] <= 1 or a.stride(2) == 1


def same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two (T, M, D) operands share one layout the kernels take."""
    return (a.shape == b.shape and strides(a) == strides(b) and unit_d(a)
            and unit_d(b))


def lif_soma_fwd_plain(x: torch.Tensor, u0: torch.Tensor | None = None,
                       s0: torch.Tensor | None = None, *, alpha: float = 0.5,
                       th_fire: float = 1.0, th_lo: float = 0.0,
                       th_hi: float = 2.0):
    """x: (T, ...) -> (spikes, U_seq, grad_mask), eq. 11, plain tensor code,
    each in ``x``'s layout (``torch.empty_like``). With a carried state
    ``u0``, ``s0`` (each ``x.shape[1:]``) the walk starts from it, step 0
    as ``alpha * u0 * (1 - s0) + x[0]``, and the final ``(u_last, s_last)``
    follow the three sequences."""
    if (u0 is None) != (s0 is None):
        raise ValueError("lif_soma_fwd: give both u0 and s0, or neither")
    carry = u0 is not None
    u = u0 if carry else torch.zeros_like(x[0])
    s = s0 if carry else torch.zeros_like(x[0])
    ss, us, ms = (torch.empty_like(x) for _ in range(3))
    for t in range(x.shape[0]):
        u = alpha * u * (1.0 - s) + x[t]
        s = (u >= th_fire).to(x.dtype)
        ss[t] = s
        us[t] = u
        ms[t] = ((u > th_lo) & (u < th_hi)).to(x.dtype)
    return (ss, us, ms) + ((u, s) if carry else ())


def lif_soma_bwd_plain(g: torch.Tensor, u_seq: torch.Tensor,
                       spikes: torch.Tensor, mask: torch.Tensor,
                       gu_last: torch.Tensor | None = None, *,
                       alpha: float = 0.5, grad_scale: float = 1.0):
    """GRAD (eq. 12), plain tensor code: upstream dL/dS (T, ...) and the
    persisted (U, S, mask) -> dL/dX in ``g``'s layout. ``gu_last`` (...),
    when given, is a direct cotangent on the final membrane U_{T-1}, added
    at t = T-1."""
    grad_u_next = torch.zeros_like(g[0])
    dx = torch.empty_like(g)
    for t in reversed(range(g.shape[0])):
        grad_s = g[t] - alpha * u_seq[t] * grad_u_next
        grad_u = (grad_u_next * alpha * (1.0 - spikes[t])
                  + grad_s * mask[t] * grad_scale)
        if gu_last is not None and t == g.shape[0] - 1:
            grad_u = grad_u + gu_last
        dx[t] = grad_u
        grad_u_next = grad_u
    return dx


def _check_state(name: str, a: torch.Tensor, x: torch.Tensor) -> None:
    """An (M, D) state operand of the kernel: fp32, contiguous, on x's
    device."""
    if a.shape != x.shape[1:]:
        raise ValueError(f"{name} shape {tuple(a.shape)} != "
                         f"{tuple(x.shape[1:])}")
    if a.is_cuda and (a.dtype != torch.float32 or not a.is_contiguous()
                      or a.device != x.device):
        raise ValueError(f"lif_soma kernels take {name} as a contiguous "
                         f"float32 (M, D) tensor on the operands' device")


def _launch_fwd(x, u0, s0, which, params, stream):
    """Allocate the outputs in ``x``'s layout and launch the forward's arm
    ``which`` (``"flat"`` / ``"ring"``; the flat arm's entry refuses what it
    does not take) on ``stream``: (S, U, mask), and (u_last, s_last) with a
    carried state. The wrappers' launch; the benches and card tests call it
    to run one arm."""
    s, u, mask = (torch.empty_like(x) for _ in range(3))
    last = (torch.empty_like(u0), torch.empty_like(s0)) if u0 is not None \
        else ()
    state = [a.data_ptr() for a in (u0, s0) + last] if last else [None] * 4
    t, m, d = x.shape
    code = build.load().e2a_lif_soma_fwd(
        x.data_ptr(), s.data_ptr(), u.data_ptr(), mask.data_ptr(), *state,
        m, d, t, *strides(x), *strides(s), *params, _ARM_CODE[which], stream)
    build.check_launch(code, "lif_soma_fwd")
    return (s, u, mask) + last


def _launch_bwd(g, u_seq, spikes, mask, gu_last, which, params, stream):
    """Allocate dx in ``g``'s layout and launch the backward's arm
    ``which`` on ``stream``."""
    dx = torch.empty_like(g)
    t, m, d = g.shape
    code = build.load().e2a_lif_soma_bwd(
        g.data_ptr(), u_seq.data_ptr(), spikes.data_ptr(), mask.data_ptr(),
        gu_last.data_ptr() if gu_last is not None else None, dx.data_ptr(),
        m, d, t, *strides(g), *strides(dx), *params, _ARM_CODE[which],
        stream)
    build.check_launch(code, "lif_soma_bwd")
    return dx


def lif_soma_fwd(x: torch.Tensor, u0: torch.Tensor | None = None,
                 s0: torch.Tensor | None = None, *, alpha: float = 0.5,
                 th_fire: float = 1.0, th_lo: float = 0.0,
                 th_hi: float = 2.0):
    """x: (T, M, D) input currents -> (spikes, U_seq, grad_mask), all
    (T, M, D) in ``x.dtype`` and in ``x``'s layout. With a carried state
    ``u0``, ``s0`` (each (M, D), contiguous) the walk starts from it and
    ``(u_last, s_last)``, each (M, D), follow: step 0 is
    ``alpha * u0 * (1 - s0) + x[0]``, bit for bit ``core.lif.lif_step``.
    (The reference's kernel path folds that term into x[0] and walks from
    rest; its U can differ from this one only in the sign of a zero, and
    spikes and mask not at all.)

    A CUDA tensor launches the kernel (fp32 with unit stride on D, any
    stride on T and M; anything else raises) on the arm :func:`choose_arm`
    chooses; a CPU tensor takes the plain version.
    """
    if x.ndim != 3:
        raise ValueError(f"lif_soma_fwd expects (T, M, D), got {tuple(x.shape)}")
    if (u0 is None) != (s0 is None):
        raise ValueError("lif_soma_fwd: give both u0 and s0, or neither")
    carry = u0 is not None
    if carry:
        _check_state("u0", u0, x)
        _check_state("s0", s0, x)
    if not x.is_cuda:
        return lif_soma_fwd_plain(x, u0, s0, alpha=alpha, th_fire=th_fire,
                                  th_lo=th_lo, th_hi=th_hi)
    if x.dtype != torch.float32:
        raise TypeError(f"lif_soma_fwd kernel takes float32, got {x.dtype}")
    if not unit_d(x):
        raise ValueError("lif_soma_fwd kernel takes a tensor whose last axis "
                         "has unit stride")
    t, m, d = x.shape
    with torch.cuda.device(x.device):
        out = _launch_fwd(x, u0, s0,
                          choose_arm(t, m * d, x.is_contiguous(), carry),
                          (alpha, th_fire, th_lo, th_hi),
                          torch.cuda.current_stream().cuda_stream)
    lif_soma_fwd.launches += 1
    return out


def lif_soma_bwd(g: torch.Tensor, u_seq: torch.Tensor, spikes: torch.Tensor,
                 mask: torch.Tensor, gu_last: torch.Tensor | None = None, *,
                 alpha: float = 0.5, grad_scale: float = 1.0) -> torch.Tensor:
    """GRAD: upstream dL/dS (T, M, D) + persisted (U, S, mask) -> dL/dX
    (T, M, D), in ``g``'s layout. ``gu_last`` (M, D), when given, is the
    direct cotangent on the final membrane U_{T-1} (the carry handed back by
    the next temporal tile's backward). A CUDA tensor launches the kernel
    (fp32; g, U, S and mask in one layout with unit stride on D, which
    ``ops`` copies g into where autograd hands it another; ``gu_last``
    contiguous; anything else raises) on the arm :func:`choose_arm`
    chooses; a CPU tensor takes the plain version."""
    if g.ndim != 3:
        raise ValueError(f"lif_soma_bwd expects (T, M, D), got {tuple(g.shape)}")
    signals = (u_seq, spikes, mask)
    if any(a.shape != g.shape for a in signals):
        raise ValueError("lif_soma_bwd: g, U, S and mask differ in shape")
    if gu_last is not None:
        _check_state("gu_last", gu_last, g)
    if not g.is_cuda:
        return lif_soma_bwd_plain(g, u_seq, spikes, mask, gu_last,
                                  alpha=alpha, grad_scale=grad_scale)
    operands = (g,) + signals
    if any(a.dtype != torch.float32 for a in operands):
        raise TypeError("lif_soma_bwd kernel takes float32 operands")
    if any(not same_layout(a, g) or a.device != g.device for a in operands):
        raise ValueError("lif_soma_bwd kernel takes g, U, S and mask in one "
                         "layout with unit stride on D, on one device")
    t, m, d = g.shape
    with torch.cuda.device(g.device):
        dx = _launch_bwd(g, u_seq, spikes, mask, gu_last,
                         choose_arm(t, m * d, g.is_contiguous()),
                         (alpha, grad_scale),
                         torch.cuda.current_stream().cuda_stream)
    lif_soma_bwd.launches += 1
    return dx


#: Kernel launches since the count was last set to 0 (plain-version calls do
#: not count).
lif_soma_fwd.launches = 0
lif_soma_bwd.launches = 0


# ---------------------------------------------------------------------------
# Kernel-contract declarations (repro_torch.analysis.contracts). The
# backward also runs in the neuron layer's backward, at its (T, M, K).
# ---------------------------------------------------------------------------

from repro_torch.kernels import ref as _ref  # noqa: E402
from repro_torch.kernels.contract import (KernelContract,  # noqa: E402
                                          declare_contract, meta)


def _build_lif_fwd(case):
    return (meta(case.t, case.m, case.k, dtype=case.torch_dtype),), {}, {}


def _build_lif_bwd(case):
    args = tuple(meta(case.t, case.m, case.k, dtype=case.torch_dtype)
                 for _ in range(4))
    kw = {"alpha": 0.5, "grad_scale": 1.0}
    return args, kw, kw


def _build_lif_bwd_carry(case):
    args, kw, _ = _build_lif_bwd(case)
    return args + (meta(case.m, case.k, dtype=case.torch_dtype),), kw, kw


declare_contract(KernelContract(
    name="lif_soma_fwd", kernel="lif_soma_fwd", fn=lif_soma_fwd,
    build=_build_lif_fwd, ref=_ref.lif_soma_fwd_ref,
    serves=(("lif", "cuda"), ("lif_state", "cuda"))))

declare_contract(KernelContract(
    name="lif_soma_bwd", kernel="lif_soma_bwd", fn=lif_soma_bwd,
    build=_build_lif_bwd, ref=_ref.lif_soma_bwd_ref,
    serves=(("lif", "cuda"), ("linear_bn", "fused_epilogue"),
            ("conv", "fused_epilogue"))))

declare_contract(KernelContract(
    name="lif_soma_bwd_carry", kernel="lif_soma_bwd", fn=lif_soma_bwd,
    build=_build_lif_bwd_carry, ref=_ref.lif_soma_bwd_carry_ref,
    serves=(("lif_state", "cuda"),)))
