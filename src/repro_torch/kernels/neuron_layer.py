"""Single-launch neuron layer, eval arm: matmul + bias + SOMA in one kernel.

Replaces ``repro.kernels.neuron_layer.neuron_layer_eval``
(``_nl_eval_kernel`` with ``_accumulate`` and ``_soma``): a whole "neuron
layer" (the Conv1DBN -> SN pair, or one im2col'd eq. 4 tokenizer stage)
with BN folded into ``(w, bias)`` by the caller. The weight tile is fetched
once per block and reused by all T steps, the membrane update runs in the
epilogue with (U, S) in registers, and only spikes leave the kernel: the
(T, M, K) pre-activation never exists in device memory.

The TPU kernel accumulated into a scratch tile revisited across a
sequential contraction grid axis and snapped its contraction block to a
divisor of C; here each block loops over C itself, keeps T accumulators per
thread in registers and masks its own tails, so any C works (the dense arm
takes the first tokenizer stage's C = 27).

Bound on this card: the packed arm by fp32 operations outside the tensor
cores (spikes make every product exact), the dense arm at the first stage
by bytes. The design is ``csrc/neuron_layer.cu``: a 64 x 64 tile, 4 x 4 x T
accumulators per thread, 64-bit offsets.

The train arm (batch statistics in-kernel) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lif_soma import lif_soma_fwd_plain
from repro_torch.kernels.spike_matmul import spike_pack

#: Time steps the kernel is instantiated for (T accumulators per thread).
MAX_TIME_STEPS = 8


def neuron_layer_eval_plain(x: torch.Tensor, w: torch.Tensor,
                            bias: torch.Tensor, *, alpha: float = 0.5,
                            th_fire: float = 1.0) -> torch.Tensor:
    """Plain version: dense matmul, bias, then the LIF recursion. ``x`` is
    the unpacked (T, M, C) input for both arms."""
    acc = torch.matmul(x.to(w.dtype), w).float() + bias.float().reshape(1, 1, -1)
    s, _, _ = lif_soma_fwd_plain(acc, alpha=alpha, th_fire=th_fire)
    return s.to(x.dtype)


def _launch_neuron_layer_eval(xin, w, bias, t, m, c, k, packed, alpha,
                              th_fire, stream=0):
    s = torch.empty((t, m, k), dtype=torch.float32, device=xin.device)
    code = build.load().e2a_neuron_layer_eval(
        xin.data_ptr(), w.data_ptr(), bias.data_ptr(), s.data_ptr(), t, m, c,
        k, int(packed), alpha, th_fire, stream)
    build.check_launch(code, "neuron_layer_eval")
    return s


def neuron_layer_eval(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
                      alpha: float = 0.5, th_fire: float = 1.0,
                      packed: bool = False) -> torch.Tensor:
    """Eval-mode neuron layer: x (T, M, C) @ w (C, K) + bias -> SOMA, one
    launch. Returns spikes (T, M, K) in ``x.dtype``.

    ``packed=True`` bit-packs the {0,1} ``x`` along C (8 spikes/byte, plain
    tensor code) so that it crosses device memory at 1 bit/element and is
    expanded inside the kernel; C must then be a multiple of 8.
    """
    if x.ndim != 3 or w.ndim != 2:
        raise ValueError(f"neuron_layer_eval expects x (T, M, C) and w (C, K),"
                         f" got {tuple(x.shape)} and {tuple(w.shape)}")
    t, m, c = x.shape
    cw, k = w.shape
    if cw != c:
        raise ValueError(f"weight contraction {cw} != input {c}")
    if bias.shape != (k,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({k},)")
    if packed and c % 8 != 0:
        raise ValueError(f"packed contraction dim {c} must be a multiple of 8")
    if not x.is_cuda:
        return neuron_layer_eval_plain(x, w, bias, alpha=alpha,
                                       th_fire=th_fire)
    if not 1 <= t <= MAX_TIME_STEPS:
        raise ValueError(f"neuron_layer_eval kernel supports 1..{MAX_TIME_STEPS}"
                         f" time steps, got {t}")
    if x.dtype != torch.float32 or w.dtype != torch.float32 \
            or bias.dtype != torch.float32:
        raise TypeError(f"neuron_layer_eval kernel takes float32, got x "
                        f"{x.dtype}, w {w.dtype}, bias {bias.dtype}")
    if w.device != x.device or bias.device != x.device:
        raise ValueError("neuron_layer_eval: operands on different devices")
    xin = spike_pack(x) if packed else x
    if not (xin.is_contiguous() and w.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("neuron_layer_eval kernel takes contiguous operands")
    with torch.cuda.device(x.device):
        s = _launch_neuron_layer_eval(
            xin, w, bias, t, m, c, k, packed, alpha, th_fire,
            torch.cuda.current_stream().cuda_stream)
    neuron_layer_eval.launches += 1
    return s


#: Kernel launches since the count was last set to 0.
neuron_layer_eval.launches = 0
