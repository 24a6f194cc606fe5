"""Forward wrappers of the kernels, under the reference's op names.

The counterpart of ``repro.kernels.ops``. There each op is a ``custom_vjp``
pairing a forward kernel with its backward; here only the forward halves
exist so far. The ``torch.autograd.Function`` bodies (GRAD kernel, dense
matmul VJPs, replay for the neuron layer) arrive with the training slice.
Until then a call that would need a gradient — an input that requires grad
while grad mode is on — raises ``NotImplementedError`` instead of returning
a tensor that silently carries no gradient.

Launch counts live on the kernel wrappers these ops call
(``repro_torch.kernels.launch_counts``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import conv_spike, lif_soma, neuron_layer, \
    spike_matmul


def _forward_only(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the backward pass is not ported yet (it arrives with "
            f"the training slice: the autograd.Function bodies and the "
            f"lif_soma_bwd / bn / neuron_layer_train kernels); call under "
            f"torch.no_grad() or with inputs that do not require grad")


def lif_soma_op(x: torch.Tensor, alpha: float = 0.5, th_fire: float = 1.0,
                th_lo: float = 0.0, th_hi: float = 2.0,
                grad_scale: float = 1.0) -> torch.Tensor:
    """Fused LIF over (T, M, D); returns spikes."""
    _forward_only("lif_soma_op", x)
    s, _, _ = lif_soma.lif_soma_fwd(x, alpha=alpha, th_fire=th_fire,
                                    th_lo=th_lo, th_hi=th_hi)
    return s


def lif_soma_carry_op(x: torch.Tensor, u0: torch.Tensor, s0: torch.Tensor,
                      alpha: float = 0.5, th_fire: float = 1.0,
                      th_lo: float = 0.0, th_hi: float = 2.0,
                      grad_scale: float = 1.0):
    """State-carrying fused LIF over (T, M, D): starts from the carried
    ``(u0, s0)`` (each (M, D)) instead of rest and returns ``(spikes,
    u_last, s_last)``. The initial state folds into the first input step
    (eq. 11: U_1 = alpha * u0 * (1 - s0) + X_1), so the SOMA kernel itself
    is unchanged."""
    _forward_only("lif_soma_carry_op", x, u0, s0)
    x = x.clone()
    x[0] += alpha * u0 * (1.0 - s0)
    s, u, _ = lif_soma.lif_soma_fwd(x, alpha=alpha, th_fire=th_fire,
                                    th_lo=th_lo, th_hi=th_hi)
    return s, u[-1], s[-1]


def spike_matmul_train_op(spikes: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """Bit-packed spike matmul: (M, C) {0,1} x (C, K). C % 8 == 0."""
    _forward_only("spike_matmul_train_op", spikes, w)
    return spike_matmul.spike_matmul(spikes, w)


def spike_bmm_train_op(spikes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched bit-packed spike matmul: (G, M, C) {0,1} x (G, C, K) ->
    (G, M, K), or the same with two batch dims. C % 8 == 0."""
    _forward_only("spike_bmm_train_op", spikes, w)
    return spike_matmul.spike_matmul_batched(spikes, w)


def spike_patch_mm_train_op(patches: torch.Tensor,
                            w: torch.Tensor) -> torch.Tensor:
    """Time-major im2col spike-conv matmul: (T, M, C) {0,1} patches x
    (C, K) shared weight -> (T, M, K). C (= k*k*c_in) % 8 == 0."""
    _forward_only("spike_patch_mm_train_op", patches, w)
    return conv_spike.spike_patch_matmul(patches, w)


def neuron_layer_eval_op(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                         alpha: float = 0.5, th_fire: float = 1.0,
                         th_lo: float = 0.0, th_hi: float = 2.0,
                         grad_scale: float = 1.0,
                         packed: bool = False) -> torch.Tensor:
    """Single-launch neuron layer, eval mode: BN already folded into
    ``(w, bias)``, so the kernel is matmul + bias + SOMA. Returns spikes
    (T, M, K)."""
    _forward_only("neuron_layer_eval_op", x, w, bias)
    return neuron_layer.neuron_layer_eval(x, w, bias, alpha=alpha,
                                          th_fire=th_fire, packed=packed)
