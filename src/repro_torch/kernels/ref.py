"""Pure PyTorch oracles for every kernel of the port (the allclose
references), the counterparts of ``repro.kernels.ref``.

Each is the reference's formula written again in plain tensor code: the
scans as Python loops over T in the reference's order of operations, the
products as ``matmul`` / ``einsum``. They import nothing from the kernel
modules, so a fault shared by a kernel and the plain version beside its
wrapper (one hand wrote both) shows against them. They run on any device;
on the card they are what ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold every kernel against.

Divisions by a row count divide by a 0-d tensor on the operand's device: a
CUDA division by a host scalar multiplies by its rounded reciprocal, which
is not the correctly rounded quotient the kernels form.

At bf16 each oracle computes as the reference's Pallas kernel does, which
is not always what ``repro.kernels.ref`` writes: the LIF recursions round
every operation to the input's dtype (bf16 tensor ops do), BN works in
fp32 and stores y and dx in the input's dtype, and every product
accumulates in fp32 (``preferred_element_type``) and rounds to the
output's dtype once. The neuron layers' BN or bias and SOMA run on that
fp32 accumulator, as the Pallas kernel's epilogue does; the reference's
``neuron_layer_eval_ref`` rounds the accumulator to ``x.dtype`` before its
SOMA and the train oracle its product to ``w.dtype``, which its kernel
does not (ROADMAP, Queue C). At fp32 every such cast is the identity.
"""
from __future__ import annotations

import torch

__all__ = ["bn_bwd_ref", "bn_fwd_ref", "lif_soma_bwd_carry_ref",
           "lif_soma_bwd_ref", "lif_soma_fwd_ref", "neuron_layer_eval_ref",
           "neuron_layer_train_ref", "spike_matmul_batched_ref",
           "spike_matmul_ref", "spike_pack_ref", "spike_patch_matmul_ref"]


def _rows(x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(x.shape[0]), dtype=torch.float32,
                        device=x.device)


def lif_soma_fwd_ref(x: torch.Tensor, *, alpha: float = 0.5,
                     th_fire: float = 1.0, th_lo: float = 0.0,
                     th_hi: float = 2.0):
    """x: (T, M, D) -> (spikes, U_seq, grad_mask), eq. 11."""
    u = torch.zeros_like(x[0])
    s = torch.zeros_like(x[0])
    ss, us, ms = [], [], []
    for t in range(x.shape[0]):
        u = alpha * u * (1.0 - s) + x[t]
        s = (u >= th_fire).to(u.dtype)
        ss.append(s)
        us.append(u)
        ms.append(((u > th_lo) & (u < th_hi)).to(u.dtype))
    return torch.stack(ss), torch.stack(us), torch.stack(ms)


def lif_soma_bwd_ref(g: torch.Tensor, u_seq: torch.Tensor,
                     spikes: torch.Tensor, mask: torch.Tensor, *,
                     alpha: float = 0.5, grad_scale: float = 1.0):
    """eq. 12 reverse-time recursion -> dL/dX."""
    grad_u = torch.zeros_like(g[0])
    dx = [None] * g.shape[0]
    for t in reversed(range(g.shape[0])):
        grad_s = g[t] - alpha * u_seq[t] * grad_u
        grad_u = grad_u * alpha * (1.0 - spikes[t]) \
            + grad_s * mask[t] * grad_scale
        dx[t] = grad_u
    return torch.stack(dx)


def lif_soma_bwd_carry_ref(g: torch.Tensor, u_seq: torch.Tensor,
                           spikes: torch.Tensor, mask: torch.Tensor,
                           gu_last: torch.Tensor, *, alpha: float = 0.5,
                           grad_scale: float = 1.0):
    """Temporally tiled GRAD: the next tile's carry cotangent ``gu_last``
    (M, D) seeds the reverse recursion additively at t = T-1 (after the
    step's own surrogate term), then eq. 12 runs as usual. Every step adds
    its seed, zero but at t = T-1, as the reference's scan does."""
    seeds = torch.zeros_like(g)
    seeds[-1] = gu_last.to(g.dtype)
    grad_u = torch.zeros_like(g[0])
    dx = [None] * g.shape[0]
    for t in reversed(range(g.shape[0])):
        grad_s = g[t] - alpha * u_seq[t] * grad_u
        grad_u = (grad_u * alpha * (1.0 - spikes[t])
                  + grad_s * mask[t] * grad_scale + seeds[t])
        dx[t] = grad_u
    return torch.stack(dx)


def spike_pack_ref(spikes: torch.Tensor) -> torch.Tensor:
    """(..., C) {0,1} -> (..., C//8) uint8, LSB-first along C, as the
    reference's ``jnp`` sum forms it: each spike cast to uint8, times its
    bit's weight, the eight summed in uint8."""
    *lead, c = spikes.shape
    bits = spikes.reshape(*lead, c // 8, 8).to(torch.uint8)
    weights = torch.tensor([1 << b for b in range(8)], dtype=torch.uint8,
                           device=spikes.device)
    return (bits * weights).sum(-1, dtype=torch.uint8)


def spike_matmul_ref(spikes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, C) {0,1} x (C, K), accumulated in fp32, in ``w.dtype``."""
    return (spikes.float() @ w.float()).to(w.dtype)


def spike_matmul_batched_ref(spikes: torch.Tensor,
                             w: torch.Tensor) -> torch.Tensor:
    """(G, M, C) {0,1} x (G, C, K) per-group matmul, accumulated in fp32,
    in ``w.dtype``."""
    return torch.einsum("gmc,gck->gmk", spikes.float(),
                        w.float()).to(w.dtype)


def spike_patch_matmul_ref(patches: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    """(T, M, C) {0,1} im2col patches x shared (C, K) weight, accumulated
    in fp32, in ``w.dtype``."""
    return torch.einsum("tmc,ck->tmk", patches.float(),
                        w.float()).to(w.dtype)


def neuron_layer_train_ref(x: torch.Tensor, w: torch.Tensor,
                           gamma: torch.Tensor, beta: torch.Tensor, *,
                           alpha: float = 0.5, th_fire: float = 1.0,
                           eps: float = 1e-5):
    """Train-mode neuron layer: x (T, M, C) @ w (C, K) -> BN over all T*M
    rows (batch statistics) -> SOMA, all on the fp32 accumulator. Returns
    ``(spikes (T, M, K) in x.dtype, mu (1, K), var (1, K))``."""
    t, m, _ = x.shape
    k = w.shape[-1]
    acc = torch.einsum("tmc,ck->tmk", x.float(), w.float())
    y, mu, sqrt_d = bn_fwd_ref(acc.reshape(t * m, k), gamma, beta, eps)
    var = sqrt_d * sqrt_d - eps
    s, _, _ = lif_soma_fwd_ref(y.reshape(t, m, k), alpha=alpha,
                               th_fire=th_fire)
    return s.to(x.dtype), mu, var


def neuron_layer_eval_ref(x: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor, *, alpha: float = 0.5,
                          th_fire: float = 1.0):
    """Eval-mode neuron layer: BN already folded into (w, bias); the bias
    and SOMA on the fp32 accumulator; returns spikes (T, M, K) in
    ``x.dtype``."""
    acc = torch.einsum("tmc,ck->tmk", x.float(), w.float())
    acc = acc + bias.reshape(1, 1, -1).float()
    s, _, _ = lif_soma_fwd_ref(acc, alpha=alpha, th_fire=th_fire)
    return s.to(x.dtype)


def bn_fwd_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5):
    """eq. 13-18 over (M, D); returns (y, mu (1, D), sqrt_d (1, D))."""
    xf = x.float()
    m = _rows(xf)
    mu = xf.sum(0, keepdim=True) / m
    var = torch.clamp((xf * xf).sum(0, keepdim=True) / m - mu * mu, min=0.0)
    sqrt_d = torch.sqrt(var + eps)
    y = gamma.reshape(1, -1) * (xf - mu) / sqrt_d + beta.reshape(1, -1)
    return y.to(x.dtype), mu, sqrt_d


def bn_bwd_ref(g: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
               mu: torch.Tensor, sqrt_d: torch.Tensor):
    """eq. 19-23 verbatim; returns (dx (M, D), dgamma (1, D), dbeta
    (1, D))."""
    m = _rows(x)
    gf = g.float()
    xf = x.float()
    gm = gamma.reshape(1, -1).float()
    mi = gm * gf / sqrt_d
    n = xf - mu
    s_n = n.sum(0, keepdim=True)
    s_m = mi.sum(0, keepdim=True)
    s_mn = (mi * n).sum(0, keepdim=True)
    dgamma = s_mn / gm
    dbeta = gf.sum(0, keepdim=True)
    sq2 = sqrt_d * sqrt_d
    dx = mi - n * s_mn / (m * sq2) + s_n * s_mn / (sq2 * m * m) - s_m / m
    return dx.to(g.dtype), dgamma, dbeta
