"""Differentiable kernel ops, under the reference's op names.

The counterpart of ``repro.kernels.ops``: each of the reference's
``custom_vjp`` ops is a ``torch.autograd.Function`` here, pairing a forward
kernel with its backward, as in the E2ATST reuse framework (Fig. 4):

* ``lif_soma_op`` / ``lif_soma_carry_op`` / ``lif_soma_step_op``: SOMA
  forward, GRAD (``lif_soma_bwd``) backward (eq. 11-12);
* ``bn_train_op``: the BN forward and backward kernels (eq. 13-23);
* ``spike_matmul_train_op`` / ``spike_bmm_train_op`` /
  ``spike_patch_mm_train_op``: the bit-packed spike matmul forward, the
  dense matmul VJP backward (the weight gradient needs the real spike
  values, as in the reference, which computes it outside any kernel);
* ``neuron_layer_train_op`` / ``neuron_layer_eval_op``: the neuron-layer
  kernel forward; a backward that stores no per-step residuals but replays
  the pre-activation, bit for bit the forward's, through SOMA, GRAD and
  (train) the BN backward, then the dense matmul VJP.

Under data parallelism the BN ops take ``group``, the process group over
the batch axes: the forward's statistics and the backward's eq. 23 sums are
those of every rank's rows (the kernels' split path); the group is kept on
the op for its backward.

Launch counts live on the kernel wrappers these ops call
(``repro_torch.kernels.launch_counts``). On CPU tensors every wrapper takes
its plain version, so these ops are also what the CPU tests differentiate.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import conv_spike, fused_bn, lif_soma, \
    neuron_layer, spike_matmul


def _in_layout_of(g: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``g`` itself where it already has ``ref``'s layout (the GRAD kernel
    takes g, U, S and mask in one layout), else an explicit copy of ``g``
    into that layout."""
    if lif_soma.same_layout(g, ref):
        return g
    return torch.empty_like(ref).copy_(g)


class _LifSoma(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha, th_fire, th_lo, th_hi, grad_scale):
        s, u, mask = lif_soma.lif_soma_fwd(x, alpha=alpha, th_fire=th_fire,
                                           th_lo=th_lo, th_hi=th_hi)
        ctx.save_for_backward(u, s, mask)
        ctx.lif = (alpha, grad_scale)
        return s

    @staticmethod
    def backward(ctx, g):
        u, s, mask = ctx.saved_tensors
        alpha, grad_scale = ctx.lif
        dx = lif_soma.lif_soma_bwd(_in_layout_of(g, u), u, s, mask,
                                   alpha=alpha, grad_scale=grad_scale)
        return dx, None, None, None, None, None


def lif_soma_op(x: torch.Tensor, alpha: float = 0.5, th_fire: float = 1.0,
                th_lo: float = 0.0, th_hi: float = 2.0,
                grad_scale: float = 1.0) -> torch.Tensor:
    """Differentiable fused LIF over (T, M, D); returns spikes (in ``x``'s
    layout, as every tensor the kernels return)."""
    return _LifSoma.apply(x, alpha, th_fire, th_lo, th_hi, grad_scale)


class _LifSomaCarry(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, u0, s0, alpha, th_fire, th_lo, th_hi, grad_scale):
        # the kernel takes the (M, D) state contiguous: a no-op for the
        # state the callers carry (the kernel's own u_last / s_last, a
        # serving cache row, zeros)
        u0, s0 = u0.contiguous(), s0.contiguous()
        s, u, mask, u_last, s_last = lif_soma.lif_soma_fwd(
            x, u0, s0, alpha=alpha, th_fire=th_fire, th_lo=th_lo,
            th_hi=th_hi)
        ctx.save_for_backward(u, s, mask, u0, s0)
        ctx.lif = (alpha, grad_scale)
        ctx.set_materialize_grads(False)   # an unused output's grad: None
        return s, u_last, s_last

    @staticmethod
    def backward(ctx, g_s, g_u_last, g_s_last):
        u, s, mask, u0, s0 = ctx.saved_tensors
        alpha, grad_scale = ctx.lif
        # s_last IS spikes[-1]: its cotangent joins the per-step one, in a
        # buffer of U's layout (autograd's g_s is never written to)
        if g_s is None:
            g_eff = torch.zeros_like(u)
        elif g_s_last is not None:
            g_eff = torch.empty_like(u).copy_(g_s)
        else:
            g_eff = _in_layout_of(g_s, u)
        if g_s_last is not None:
            g_eff[-1] += g_s_last
        dx = lif_soma.lif_soma_bwd(
            g_eff, u, s, mask,
            g_u_last.contiguous() if g_u_last is not None else None,
            alpha=alpha, grad_scale=grad_scale)
        # U_1 = alpha * u0 * (1 - s0) + X_1 and dU_1/dX_1 = 1, so dL/dU_1 =
        # dx[0]; the reset path stays attached (the eager scan's gradient).
        g_u0 = dx[0] * alpha * (1.0 - s0)
        g_s0 = -dx[0] * alpha * u0
        return dx, g_u0, g_s0, None, None, None, None, None


def lif_soma_carry_op(x: torch.Tensor, u0: torch.Tensor, s0: torch.Tensor,
                      alpha: float = 0.5, th_fire: float = 1.0,
                      th_lo: float = 0.0, th_hi: float = 2.0,
                      grad_scale: float = 1.0):
    """State-carrying fused LIF over (T, M, D): starts from the carried
    ``(u0, s0)`` (each (M, D)) instead of rest and returns ``(spikes,
    u_last, s_last)``, all from one SOMA launch: the kernel computes step 0
    as alpha * u0 * (1 - s0) + X_1 (eq. 11, ``core.lif.lif_step``'s order)
    and writes the final state. The backward seeds the GRAD kernel with the
    incoming dL/du_last and returns exact (du0, ds0)."""
    return _LifSomaCarry.apply(x, u0, s0, alpha, th_fire, th_lo, th_hi,
                               grad_scale)


def lif_soma_step_op(x: torch.Tensor, u0: torch.Tensor, s0: torch.Tensor,
                     alpha: float = 0.5, th_fire: float = 1.0,
                     th_lo: float = 0.0, th_hi: float = 2.0,
                     grad_scale: float = 1.0):
    """Single-token step of the stateful fused SOMA: the T=1 case of
    :func:`lif_soma_carry_op`. ``x``/``u0``/``s0`` are (M, D); returns
    ``(spikes, u_next, s_next)``, each (M, D)."""
    s, u_next, s_next = lif_soma_carry_op(x[None], u0, s0, alpha, th_fire,
                                          th_lo, th_hi, grad_scale)
    return s[0], u_next, s_next


class _BnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, group):
        y, mu, sqrt_d = fused_bn.bn_fwd(x, gamma, beta, eps=eps, group=group)
        ctx.save_for_backward(x, gamma, mu, sqrt_d)
        ctx.group = group
        mu_out, var = mu.reshape(-1), sqrt_d.square().reshape(-1) - eps
        ctx.mark_non_differentiable(mu_out, var)
        return y, mu_out, var

    @staticmethod
    def backward(ctx, gy, _g_mu, _g_var):
        # mu/var cotangents: the running stats sit outside the loss graph
        x, gamma, mu, sqrt_d = ctx.saved_tensors
        dx, dgamma, dbeta = fused_bn.bn_bwd(gy.contiguous(), x, gamma, mu,
                                            sqrt_d, ctx.group)
        # fp32 statistics rows, cast back to the parameter's dtype
        return (dx, dgamma.reshape(gamma.shape).to(gamma.dtype),
                dbeta.reshape(gamma.shape).to(gamma.dtype), None, None)


def bn_train_op(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                eps: float = 1e-5, group=None):
    """Differentiable training BatchNorm over (M, D). Returns ``(y, mu,
    var)``: the kernel computes the batch statistics anyway, so they are
    handed out (fp32, (D,)) for the caller's running-stat blend, ``var`` as
    ``sqrt_d^2 - eps`` (it can round below zero: the caller clamps). Only
    ``y`` carries gradients. ``group``: statistics over every rank's rows."""
    return _BnTrain.apply(x, gamma, beta, eps, group)


class _SpikeMatmul(torch.autograd.Function):
    """``forward_fn(spikes, w)`` on the kernel; the dense VJP backward:
    dS = g W^T, dW = S^T g (batched over leading dims; a weight shared by
    every batch reduces over them)."""

    @staticmethod
    def forward(ctx, spikes, w, forward_fn, shared_w):
        ctx.save_for_backward(spikes, w)
        ctx.shared_w = shared_w
        return forward_fn(spikes, w)

    @staticmethod
    def backward(ctx, g):
        spikes, w = ctx.saved_tensors
        d_spikes = torch.matmul(g, w.to(g.dtype).transpose(-1, -2))
        if ctx.shared_w:
            d_w = torch.matmul(spikes.reshape(-1, spikes.shape[-1]).to(
                g.dtype).t(), g.reshape(-1, g.shape[-1]))
        else:
            d_w = torch.matmul(spikes.to(g.dtype).transpose(-1, -2), g)
        return d_spikes.to(spikes.dtype), d_w.to(w.dtype), None, None


def spike_matmul_train_op(spikes: torch.Tensor, w: torch.Tensor,
                          tile: int = 0) -> torch.Tensor:
    """Differentiable bit-packed spike matmul: (M, C) {0,1} x (C, K).
    C % 8 == 0. ``tile`` forces the kernel's tile (``spike_matmul.TILES``,
    at bf16 also ``WGMMA`` or ``HEADS``; 0 takes ``spike_matmul.
    resolve_tile``)."""
    return _SpikeMatmul.apply(
        spikes, w, functools.partial(spike_matmul.spike_matmul, tile=tile),
        False)


def spike_bmm_train_op(spikes: torch.Tensor, w: torch.Tensor,
                       tile: int = 0) -> torch.Tensor:
    """Differentiable batched bit-packed spike matmul: (G, M, C) {0,1} x
    (G, C, K) -> (G, M, K), or the same with two batch dims. C % 8 == 0.
    Either operand may be a view; its gradient comes back in its shape.
    ``tile`` as in :func:`spike_matmul_train_op`."""
    return _SpikeMatmul.apply(
        spikes, w,
        functools.partial(spike_matmul.spike_matmul_batched, tile=tile),
        False)


def spike_patch_mm_train_op(patches: torch.Tensor, w: torch.Tensor,
                            tile: int = 0) -> torch.Tensor:
    """Differentiable time-major im2col spike-conv matmul: (T, M, C) {0,1}
    patches x (C, K) shared weight -> (T, M, K); dW reduces over T and M.
    C (= k*k*c_in) % 8 == 0. ``tile`` as in :func:`spike_matmul_train_op`."""
    return _SpikeMatmul.apply(
        patches, w,
        functools.partial(conv_spike.spike_patch_matmul, tile=tile), True)


def _replay_soma(y, g_s, alpha, th_fire, th_lo, th_hi, grad_scale):
    """Rebuild (U, S, mask) from the recomputed input currents ``y`` with
    the SOMA kernel and run the GRAD kernel on them: dL/dy."""
    s, u, mask = lif_soma.lif_soma_fwd(y, alpha=alpha, th_fire=th_fire,
                                       th_lo=th_lo, th_hi=th_hi)
    return lif_soma.lif_soma_bwd(_in_layout_of(g_s.to(y.dtype), u), u, s,
                                 mask, alpha=alpha, grad_scale=grad_scale)


def _matmul_vjp(x, w, dz):
    """dx = dz W^T, dW = X^T dz over all (T, M) rows."""
    dx = torch.matmul(dz, w.to(dz.dtype).t()).to(x.dtype)
    dw = torch.matmul(x.reshape(-1, x.shape[-1]).to(dz.dtype).t(),
                      dz.reshape(-1, dz.shape[-1])).to(w.dtype)
    return dx, dw


def replay_train_pre_activation(x, xin, w, gamma, beta, mu, sqrt_d,
                                packed):
    """The train forward's z and y = BN(z), recomputed bit for bit: z by
    the kernel's own first pass (``neuron_layer_train_z``, on the packed
    input the forward made), y with the forward's statistics in the SOMA
    pass's order, ``(gamma * (z - mu)) / sqrt_d + beta``, each operation
    rounded once. Returns ``(z, y)``."""
    z = neuron_layer.neuron_layer_train_z(x, w, packed=packed, xin=xin)
    return z, gamma.float() * (z - mu) / sqrt_d + beta.float()


def replay_eval_pre_activation(x, w, bias, packed):
    """The eval forward's y = x @ w + bias, bit for bit: the same product
    (the train arm's first pass runs the eval kernel's MMAs in the same
    order), then the bias added once, rounded to nearest."""
    return neuron_layer.neuron_layer_train_z(x, w, packed=packed) + \
        bias.float()


class _NeuronLayerTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, gamma, beta, alpha, th_fire, th_lo, th_hi,
                grad_scale, eps, packed, group):
        s, mu, var, sqrt_d, xin = neuron_layer.neuron_layer_train_fwd(
            x, w, gamma, beta, alpha=alpha, th_fire=th_fire,
            eps=eps, packed=packed, group=group)
        ctx.save_for_backward(x, xin, w, gamma, beta, mu, sqrt_d)
        ctx.lif = (alpha, th_fire, th_lo, th_hi, grad_scale)
        ctx.packed = packed
        ctx.group = group
        mu_out, var_out = mu.reshape(-1), var.reshape(-1)
        ctx.mark_non_differentiable(mu_out, var_out)
        return s, mu_out, var_out

    @staticmethod
    def backward(ctx, g_s, _g_mu, _g_var):
        x, xin, w, gamma, beta, mu, sqrt_d = ctx.saved_tensors
        t, m, _ = x.shape
        # Replay: recompute the pre-activation exactly as the forward formed
        # it (with the forward's statistics, the global ones under data
        # parallelism) and regenerate the (U, S, mask) GRAD consumes.
        z, y = replay_train_pre_activation(x, xin, w, gamma, beta, mu,
                                           sqrt_d, ctx.packed)
        dy = _replay_soma(y, g_s, *ctx.lif)
        k = z.shape[-1]
        dz, dgamma, dbeta = fused_bn.bn_bwd(dy.reshape(t * m, k),
                                            z.reshape(t * m, k),
                                            gamma.float(), mu, sqrt_d,
                                            ctx.group)
        dx, dw = _matmul_vjp(x, w, dz.reshape(t, m, k))
        return (dx, dw, dgamma.reshape(gamma.shape).to(gamma.dtype),
                dbeta.reshape(beta.shape).to(beta.dtype),
                None, None, None, None, None, None, None, None)


def neuron_layer_train_op(x: torch.Tensor, w: torch.Tensor,
                          gamma: torch.Tensor, beta: torch.Tensor,
                          alpha: float = 0.5, th_fire: float = 1.0,
                          th_lo: float = 0.0, th_hi: float = 2.0,
                          grad_scale: float = 1.0, eps: float = 1e-5,
                          packed: bool = False, group=None):
    """Differentiable neuron layer, train mode: ``x (T, M, C) @ w (C, K)``
    -> BatchNorm with batch statistics over T*M -> SOMA (eq. 11), one
    kernel call. Returns ``(spikes, mu, var)``, the statistics fp32 (K,)
    for the caller's running-stat blend; only ``spikes`` carries gradients.
    ``packed=True`` bit-packs the {0,1} input along C (C % 8 == 0).

    The backward stores no per-step residuals: it replays the recomputed
    pre-activation through the SOMA/GRAD kernel pair (eq. 12) and the BN
    backward kernel (eq. 19-23), then closes with the dense matmul VJP. It
    keeps the bit-packed input the forward made (1 bit an element) beside
    x and recomputes z with the forward kernel's own first pass and y in
    the forward's order of operations, so the replay runs the spike
    trajectory the forward emitted, bit for bit (the reference's replay, a
    separate fp32 product, may part from it near a threshold). ``group``:
    the statistics, and eq. 23's sums, over every rank's rows.
    """
    return _NeuronLayerTrain.apply(x, w, gamma, beta, alpha, th_fire, th_lo,
                                   th_hi, grad_scale, eps, packed, group)


class _NeuronLayerEval(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, alpha, th_fire, th_lo, th_hi, grad_scale,
                packed):
        ctx.save_for_backward(x, w, bias)
        ctx.lif = (alpha, th_fire, th_lo, th_hi, grad_scale)
        ctx.packed = packed
        return neuron_layer.neuron_layer_eval(x, w, bias,
                                              alpha=alpha, th_fire=th_fire,
                                              packed=packed)

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        y = replay_eval_pre_activation(x, w, bias, ctx.packed)
        dy = _replay_soma(y, g, *ctx.lif)
        dx, dw = _matmul_vjp(x, w, dy)
        dbias = dy.sum(dim=(0, 1)).reshape(bias.shape).to(bias.dtype)
        return dx, dw, dbias, None, None, None, None, None, None


def neuron_layer_eval_op(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                         alpha: float = 0.5, th_fire: float = 1.0,
                         th_lo: float = 0.0, th_hi: float = 2.0,
                         grad_scale: float = 1.0,
                         packed: bool = False) -> torch.Tensor:
    """Differentiable neuron layer, eval mode: BN already folded into
    ``(w, bias)``, so the kernel is matmul + bias + SOMA. Returns spikes
    (T, M, K). The backward replays the pre-activation, bit for bit the
    forward's, through the GRAD kernel, like the train op (gradients reach
    x, w and bias; BN parameters get theirs through the caller's
    differentiable fold)."""
    return _NeuronLayerEval.apply(x, w, bias, alpha, th_fire, th_lo, th_hi,
                                  grad_scale, packed)
