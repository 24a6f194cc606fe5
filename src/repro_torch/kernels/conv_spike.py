"""im2col lowering for the spiking tokenizer convs (E2ATST eq. 4).

The counterpart of ``repro.kernels.conv_spike``: every tokenizer stage is a
k3/s2 SAME conv, lowered to a matmul whose contraction axis is
``k*k*c_in`` so that it can ride the spike kernels. Plain tensor code,
except :func:`spike_patch_matmul`, which launches the batched spike matmul
kernel with the time axis as the batch axis.

Padding is XLA's "SAME": for k3/s2 on an even size it is one-sided
(lo, hi) = (0, 1), unlike ``F.conv2d(padding=1)``, which pads both sides
and shifts every window by one pixel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.spike_matmul import (spike_matmul_packed_batched,
                                              spike_pack)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA "SAME" (lo, hi) padding for one spatial dim."""
    out = -(-size // stride)                       # ceil
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, *, kernel: int = 3,
             stride: int = 2) -> torch.Tensor:
    """Zero-pad the H and W dims of an NHWC tensor the way XLA's "SAME"
    does."""
    (plo_h, phi_h), (plo_w, phi_w) = (same_padding(x.shape[1], kernel, stride),
                                      same_padding(x.shape[2], kernel, stride))
    # F.pad lists pads from the last dim backwards: C, then W, then H.
    return F.pad(x, (0, 0, plo_w, phi_w, plo_h, phi_h))


def im2col(x: torch.Tensor, *, kernel: int = 3, stride: int = 2) -> torch.Tensor:
    """(N, H, W, C) -> (N, Ho, Wo, kernel*kernel*C) SAME-padded patches.

    Feature order is offset-major, channel-minor — patch feature
    ``(dy*kernel + dx) * C + c`` holds input pixel ``(dy, dx, c)`` of the
    window — matching ``conv_w_matrix``'s reshape of HWIO weights, so
    ``im2col(x) @ conv_w_matrix(w)`` equals the stride-``stride`` SAME conv.
    Zero padding keeps {0,1} spike inputs binary.
    """
    _, h, w, _ = x.shape
    ho, wo = -(-h // stride), -(-w // stride)
    xp = pad_same(x, kernel=kernel, stride=stride)
    cols = [xp[:, dy: dy + stride * (ho - 1) + 1: stride,
               dx: dx + stride * (wo - 1) + 1: stride, :]
            for dy in range(kernel) for dx in range(kernel)]
    return torch.cat(cols, dim=-1)


def conv_w_matrix(w: torch.Tensor) -> torch.Tensor:
    """HWIO conv weights (k, k, C_in, C_out) -> (k*k*C_in, C_out)."""
    kh, kw, ci, co = w.shape
    return w.reshape(kh * kw * ci, co)


def fold_bn(w_mat: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            mean: torch.Tensor, var: torch.Tensor,
            eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold BN scale/shift into the conv matmul (RTFormer re-param).

    ``BN(x @ w) == x @ (w * s) + (beta - mean * s)`` with
    ``s = gamma / sqrt(var + eps)``. Exact for *fixed* statistics (eval
    mode). Statistics stay fp32; the fold result is cast by the caller.
    """
    scale = gamma.float() / torch.sqrt(var.float() + eps)
    w_folded = w_mat.float() * scale[None, :]
    bias = beta.float() - mean.float() * scale
    return w_folded, bias


def spike_patch_matmul(patches: torch.Tensor, w: torch.Tensor, *,
                       tile: int = 0) -> torch.Tensor:
    """Bit-packed spike-conv matmul: (T, M, C) {0,1} x (C, K) -> (T, M, K).

    Packs the im2col patch rows to 1 bit/element and runs the batched
    kernel with the time axis as the batch axis. The shared weight is
    handed over as an ``expand``-ed view — a zero batch stride, no copy —
    and the output stays time-major. C (= k*k*c_in) must be a multiple of 8.
    ``tile`` forces the kernel's tile (``spike_matmul.TILES``; 0: the rule,
    ``spike_matmul.default_tile``).
    """
    t = patches.shape[0]
    return spike_matmul_packed_batched(spike_pack(patches),
                                       w.unsqueeze(0).expand(t, *w.shape),
                                       tile=tile)


# ---------------------------------------------------------------------------
# Kernel-contract declarations (repro_torch.analysis.contracts).
# ---------------------------------------------------------------------------

from repro_torch.kernels import ref as _ref  # noqa: E402
from repro_torch.kernels.contract import (KernelContract,  # noqa: E402
                                          SkipCase, declare_contract, meta)


def _build_spike_patch_matmul(case):
    if case.c % 8 != 0:
        raise SkipCase(f"im2col dim {case.c} % 8 != 0 -> dense arm")
    args = (meta(case.t, case.m, case.c, dtype=case.torch_dtype),
            meta(case.c, case.k, dtype=case.torch_dtype))
    return args, {}, {}


declare_contract(KernelContract(
    name="spike_patch_matmul", kernel="spike_matmul_packed_batched",
    fn=spike_patch_matmul, build=_build_spike_patch_matmul,
    ref=_ref.spike_patch_matmul_ref, serves=(("conv", "cuda_packed"),)))
