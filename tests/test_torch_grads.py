"""Gradients of the port against the JAX package, op by op, on the CPU.

The same numpy-made inputs and cotangents go through each of the port's
``torch.autograd.Function`` ops and the reference's ``custom_vjp`` op of the
same name; the JAX side runs its Pallas kernels in interpret mode, the port
its kernels' plain versions. Also the plain versions of the four training
kernels (``lif_soma_bwd``, ``bn_fwd``, ``bn_bwd``, ``neuron_layer_train``)
against the Pallas kernels they replace, and the surrogate gradient of the
eager LIF against ``jax.grad`` of the reference's scan.

Tolerances: the LIF forward compares bitwise. The GRAD recursion is
bitwise against a strict-order float32 recursion in numpy (each operation
rounded once, as the CUDA kernel does) and within 1e-6 absolute of the
Pallas kernel: XLA on the CPU fuses ``g - alpha * U * gu`` into one FMA, a
different rounding of one term. BN and matmul gradients compare scale-aware
at 1e-5, the reference's own convention (``tests/test_neuron_layer.py``):
max|a - b| <= 1e-5 * max(1, max|b|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import single_thread

from repro.core import lif as jlif_core
from repro.kernels import fused_bn as jbn
from repro.kernels import lif_soma as jlif
from repro.kernels import neuron_layer as jnl
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import lif as tlif
from repro_torch.core.policy import named_policy
from repro_torch.kernels import fused_bn, lif_soma, neuron_layer, ops

single_thread()


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _eq(got, want):
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def _near(got, want):
    """The GRAD recursion against XLA's: 1e-6 absolute (one FMA)."""
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)


def _strict_grad(g, u, s, m, gu_last, alpha, grad_scale):
    """eq. 12 in numpy float32, every operation rounded once, left to
    right: the order of the plain version and of the CUDA kernel."""
    f = np.float32
    gu, dx = np.zeros_like(g[0]), np.zeros_like(g)
    for t in reversed(range(g.shape[0])):
        gs = g[t] - f(alpha) * u[t] * gu
        gu = gu * f(alpha) * (f(1) - s[t]) + gs * m[t] * f(grad_scale)
        if gu_last is not None and t == g.shape[0] - 1:
            gu = gu + gu_last
        dx[t] = gu
    return dx


def _close(got, want, atol=1e-5):
    """Scale-aware: max|got - want| <= atol * max(1, max|want|)."""
    got, want = np.asarray(got.detach().numpy()), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


def _spikes(rng, shape, rate=0.3):
    return (rng.random(shape) < rate).astype(np.float32)


def _lif_signals(rng, shape, lif):
    """(g, U, S, mask) of a real forward pass, so the mask and the resets
    are those a backward meets."""
    x = rng.normal(0.3, 1.2, shape).astype(np.float32)
    s, u, m = jref.lif_soma_fwd_ref(jnp.asarray(x), alpha=lif["alpha"],
                                    th_fire=lif["th_fire"],
                                    th_lo=lif["th_lo"], th_hi=lif["th_hi"])
    g = rng.normal(0, 1, shape).astype(np.float32)
    return x, g, np.asarray(u), np.asarray(s), np.asarray(m)


LIFS = [dict(alpha=0.5, th_fire=1.0, th_lo=0.0, th_hi=2.0, grad_scale=1.0),
        dict(alpha=0.3, th_fire=0.7, th_lo=-0.2, th_hi=1.1, grad_scale=0.5)]


# ---------------------------------------------------------------------------
# R1: the eager LIF's gradient is the reference's surrogate gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lif", LIFS)
@pytest.mark.parametrize("time_chunk", [None, 1, 2])
def test_eager_lif_scan_gradient_matches_jax_surrogate(lif, time_chunk):
    rng = np.random.default_rng(0)
    x, g, *_ = _lif_signals(rng, (4, 3, 7, 8), lif)
    jcfg = jlif_core.LIFConfig(**lif, time_chunk=time_chunk)
    tcfg = tlif.LIFConfig(**lif, time_chunk=time_chunk)
    want = jax.grad(lambda a: jnp.sum(jlif_core.lif_scan(a, jcfg)
                                      * jnp.asarray(g)))(jnp.asarray(x))
    xt = _t(x, grad=True)
    s = tlif.lif_scan(xt, tcfg)
    assert s.requires_grad and s.grad_fn is not None
    (got,) = torch.autograd.grad(s, xt, _t(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    assert float(np.abs(np.asarray(want)).max()) > 0.1   # not all masked
    # both against the hand-rolled eq. 12 recursion
    manual = tlif.lif_reference_manual_grad(_t(x), _t(g), tcfg)
    _eq(manual, jlif_core.lif_reference_manual_grad(
        jnp.asarray(x), jnp.asarray(g), jcfg))
    np.testing.assert_allclose(got.numpy(), manual.numpy(), atol=1e-6,
                               rtol=0)


def test_fire_and_spike_grad_mask():
    u = _t(np.array([-0.5, 0.0, 0.5, 1.0, 1.5, 2.0, 2.5], np.float32), True)
    cfg = tlif.LIFConfig(grad_scale=0.5)
    s = tlif.fire(u, cfg.th_fire, cfg.th_lo, cfg.th_hi, cfg.grad_scale)
    assert s.tolist() == [0, 0, 0, 1, 1, 1, 1]
    (g,) = torch.autograd.grad(s.sum(), u)
    assert g.tolist() == [0, 0, 0.5, 0.5, 0.5, 0, 0]
    _eq(tlif.spike_grad_mask(u.detach(), cfg),
        jlif_core.spike_grad_mask(jnp.asarray(u.detach().numpy()),
                                  jlif_core.LIFConfig(grad_scale=0.5)))


@pytest.mark.parametrize("port_policy", ["eager", "cuda"])
def test_lif_state_gradients_flow_through_the_carry(port_policy):
    """Two chunks through ``lif_scan_with_state`` give the single-shot
    scan's gradient, the carry's cotangents (u, s) included."""
    rng = np.random.default_rng(1)
    x, g, *_ = _lif_signals(rng, (4, 5, 8), LIFS[0])
    cfg = tlif.LIFConfig(policy=named_policy(port_policy))
    xt = _t(x, grad=True)
    zero = torch.zeros(5, 8)
    s1, (u, s) = tlif.lif_scan_with_state(xt[:2], zero, zero, cfg)
    s2, _ = tlif.lif_scan_with_state(xt[2:], u, s, cfg)
    (got,) = torch.autograd.grad(torch.cat([s1, s2]), xt, _t(g))
    want = jax.grad(lambda a: jnp.sum(jlif_core.lif_scan(
        a, jlif_core.LIFConfig()) * jnp.asarray(g)))(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


# ---------------------------------------------------------------------------
# K1 lif_soma_bwd and the three LIF ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16, 64), (4, 9, 13), (1, 5, 8)])
@pytest.mark.parametrize("lif", LIFS)
@pytest.mark.parametrize("carry", [False, True])
def test_lif_soma_bwd_matches_kernel(shape, lif, carry):
    rng = np.random.default_rng(sum(shape))
    _, g, u, s, m = _lif_signals(rng, shape, lif)
    gu = rng.normal(0, 1, shape[1:]).astype(np.float32) if carry else None
    kw = dict(alpha=lif["alpha"], grad_scale=lif["grad_scale"])
    got = lif_soma.lif_soma_bwd(_t(g), _t(u), _t(s), _t(m),
                                _t(gu) if carry else None, **kw)
    jargs = tuple(map(jnp.asarray, (g, u, s, m)))
    kernel = jlif.lif_soma_bwd(*jargs, jnp.asarray(gu) if carry else None,
                               interpret=True, **kw)
    oracle = (jref.lif_soma_bwd_carry_ref(*jargs, jnp.asarray(gu), **kw)
              if carry else jref.lif_soma_bwd_ref(*jargs, **kw))
    _eq(got, _strict_grad(g, u, s, m, gu, **kw))
    _near(got, kernel)
    _near(got, oracle)


def test_lif_soma_bwd_checks():
    a = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match=r"\(T, M, D\)"):
        lif_soma.lif_soma_bwd(a[0], a[0], a[0], a[0])
    with pytest.raises(ValueError, match="differ in shape"):
        lif_soma.lif_soma_bwd(a, a, a, a[:, :2])
    with pytest.raises(ValueError, match="gu_last shape"):
        lif_soma.lif_soma_bwd(a, a, a, a, torch.zeros(4, 7))


@pytest.mark.parametrize("lif", LIFS)
def test_lif_soma_op_grad_matches_custom_vjp(lif):
    rng = np.random.default_rng(2)
    x, g, *_ = _lif_signals(rng, (4, 12, 16), lif)
    args = (lif["alpha"], lif["th_fire"], lif["th_lo"], lif["th_hi"],
            lif["grad_scale"])
    want = jax.grad(lambda a: jnp.sum(jops.lif_soma_op(a, *args, True)
                                      * jnp.asarray(g)))(jnp.asarray(x))
    xt = _t(x, grad=True)
    (got,) = torch.autograd.grad(ops.lif_soma_op(xt, *args), xt, _t(g))
    _near(got, want)


@pytest.mark.parametrize("lif", LIFS)
def test_lif_soma_carry_op_grads_match_custom_vjp(lif):
    """Cotangents on all three outputs (spikes, u_last, s_last), gradients
    to all three inputs (x, u0, s0)."""
    rng = np.random.default_rng(3)
    x, g, *_ = _lif_signals(rng, (3, 10, 8), lif)
    u0 = rng.normal(0.5, 0.5, (10, 8)).astype(np.float32)
    s0 = _spikes(rng, (10, 8), 0.4)
    gu, gs = (rng.normal(0, 1, (10, 8)).astype(np.float32) for _ in range(2))
    args = (lif["alpha"], lif["th_fire"], lif["th_lo"], lif["th_hi"],
            lif["grad_scale"])

    def jloss(a, b, c):
        s, ul, sl = jops.lif_soma_carry_op(a, b, c, *args, True)
        return jnp.sum(s * g) + jnp.sum(ul * gu) + jnp.sum(sl * gs)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, u0, s0)))
    xt, ut, st = (_t(a, grad=True) for a in (x, u0, s0))
    s, ul, sl = ops.lif_soma_carry_op(xt, ut, st, *args)
    sw, uw, slw = jops.lif_soma_carry_op(*map(jnp.asarray, (x, u0, s0)),
                                         *args, True)
    for a, b in ((s, sw), (ul, uw), (sl, slw)):
        _eq(a, b)
    loss = (s * _t(g)).sum() + (ul * _t(gu)).sum() + (sl * _t(gs)).sum()
    got = torch.autograd.grad(loss, (xt, ut, st))
    for a, b in zip(got, want):
        _near(a, b)


def test_lif_soma_step_op_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(0.5, 1.0, (6, 8)).astype(np.float32)
    u0 = rng.normal(0.5, 0.5, (6, 8)).astype(np.float32)
    s0 = _spikes(rng, (6, 8), 0.4)
    g = rng.normal(0, 1, (6, 8)).astype(np.float32)
    got = ops.lif_soma_step_op(*(_t(a) for a in (x, u0, s0)))
    want = jops.lif_soma_step_op(*map(jnp.asarray, (x, u0, s0)),
                                 interpret=True)
    for a, b in zip(got, want):
        _eq(a, b)
    xt = _t(x, grad=True)
    (gx,) = torch.autograd.grad(
        (ops.lif_soma_step_op(xt, _t(u0), _t(s0))[0] * _t(g)).sum(), xt)
    wx = jax.grad(lambda a: jnp.sum(jops.lif_soma_step_op(
        a, jnp.asarray(u0), jnp.asarray(s0), interpret=True)[0] * g))(
        jnp.asarray(x))
    _near(gx, wx)


# ---------------------------------------------------------------------------
# K2 bn_fwd, K3 bn_bwd, bn_train_op
# ---------------------------------------------------------------------------

def _bn_inputs(rng, m, d, mean_over_std=None):
    """x N(1, 2); or, with ``mean_over_std``, columns of mean 500-2000 and
    that ratio of mean to standard deviation, where E[x^2] - mu^2 cancels
    all but about log2(mean_over_std^2) of E[x^2]'s 24 bits."""
    if mean_over_std is None:
        x = rng.normal(1.0, 2.0, (m, d)).astype(np.float32)
    else:
        mean = rng.uniform(500.0, 2000.0, d)
        x = (mean + rng.normal(size=(m, d)) * mean / mean_over_std).astype(
            np.float32)
    gamma = rng.uniform(0.5, 1.5, (d,)).astype(np.float32)
    beta = rng.normal(0, 0.3, (d,)).astype(np.float32)
    return x, gamma, beta


#: BN cases: (m, d, mean / std of the columns, None for N(1, 2)); the old
#: cases keep their ids.
BN_CASES = dict(argnames="m,d,mean_over_std",
                argvalues=[(64, 16, None), (300, 24, None), (7, 5, None),
                           (300, 24, 1e3)],
                ids=["64-16", "300-24", "7-5", "300-24-mean-over-std-1e3"])

#: Where mean / std ~ 1e3, var is about 16 ulps of E[x^2]: the port and the
#: reference each sum m fp32 terms of E[x^2] in their own order (a few ulps
#: apart), and XLA may fuse E[x^2] - mu * mu into one FMA, so var is held
#: to 16 ulps of E[x^2], the reference's own formula kept (the port must
#: not compute var another way).
VAR_ULPS = 16


@pytest.mark.parametrize(**BN_CASES)
def test_bn_fwd_plain_matches_kernel(m, d, mean_over_std):
    rng = np.random.default_rng(m + d)
    x, gamma, beta = _bn_inputs(rng, m, d, mean_over_std)
    got = fused_bn.bn_fwd(_t(x), _t(gamma), _t(beta))
    want = jbn.bn_fwd(*map(jnp.asarray, (x, gamma, beta)), interpret=True)
    for a, b in zip(got, want):          # y, mu (1, D), sqrt_d (1, D)
        assert tuple(a.shape) == b.shape
    if mean_over_std is None:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=1e-6)
        return
    y, mu, sd = (a.numpy().astype(np.float64) for a in got)
    wy, wmu, wsd = (np.asarray(b, np.float64) for b in want)
    np.testing.assert_allclose(mu, wmu, rtol=1e-6, atol=0)
    ulp = np.spacing((x.astype(np.float64) ** 2).mean(0).astype(np.float32))
    var_diff = np.abs(sd * sd - wsd * wsd) / ulp
    assert var_diff.max() <= VAR_ULPS, var_diff.max()
    # y moves with 1 / sqrt_d and mu: no more than their differences allow
    g = gamma.astype(np.float64)
    allow = np.abs(g * (x - wmu)) * np.abs(1 / sd - 1 / wsd) \
        + np.abs(g * (mu - wmu) / wsd) + 1e-5 * (1 + np.abs(wy))
    assert (np.abs(y - wy) <= allow).all()


@pytest.mark.parametrize(**BN_CASES)
def test_bn_bwd_plain_matches_kernel(m, d, mean_over_std):
    rng = np.random.default_rng(m * d)
    x, gamma, beta = _bn_inputs(rng, m, d, mean_over_std)
    g = rng.normal(0, 1, (m, d)).astype(np.float32)
    _, mu, sqrt_d = jbn.bn_fwd(*map(jnp.asarray, (x, gamma, beta)),
                               interpret=True)
    got = fused_bn.bn_bwd(_t(g), _t(x), _t(gamma), _t(mu), _t(sqrt_d))
    want = jbn.bn_bwd(jnp.asarray(g), jnp.asarray(x), jnp.asarray(gamma),
                      mu, sqrt_d, interpret=True)
    for a, b in zip(got, want):          # dx, dgamma (1, D), dbeta (1, D)
        _close(a, b, 1e-6)


def test_bn_bwd_at_gamma_zero_behaves_like_the_reference():
    """``dgamma = s_mn / gamma``: where gamma is 0 the reference gives
    0/0 = nan, and so does the port, in the same places."""
    rng = np.random.default_rng(5)
    x, gamma, beta = _bn_inputs(rng, 32, 6)
    gamma[[1, 4]] = 0.0
    g = rng.normal(0, 1, (32, 6)).astype(np.float32)
    _, mu, sqrt_d = jbn.bn_fwd(*map(jnp.asarray, (x, gamma, beta)),
                               interpret=True)
    _, dgamma, dbeta = fused_bn.bn_bwd(_t(g), _t(x), _t(gamma), _t(mu),
                                       _t(sqrt_d))
    _, wgamma, wbeta = jbn.bn_bwd(jnp.asarray(g), jnp.asarray(x),
                                  jnp.asarray(gamma), mu, sqrt_d,
                                  interpret=True)
    np.testing.assert_array_equal(np.isnan(dgamma.numpy()),
                                  np.isnan(np.asarray(wgamma)))
    assert np.isnan(dgamma.numpy()[0, [1, 4]]).all()
    assert np.isfinite(dgamma.numpy()[0, [0, 2, 3, 5]]).all()
    _close(dbeta, wbeta, 1e-6)


def test_bn_train_op_outputs_and_grads_match_custom_vjp():
    rng = np.random.default_rng(6)
    x, gamma, beta = _bn_inputs(rng, 96, 12)
    gy = rng.normal(0, 1, (96, 12)).astype(np.float32)
    got = ops.bn_train_op(*(_t(a, True) for a in (x, gamma, beta)))
    want = jops.bn_train_op(*map(jnp.asarray, (x, gamma, beta)), 1e-5, True)
    for a, b in zip(got, want):          # y, mu (D,), var (D,)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-6, rtol=1e-6)
    assert not got[1].requires_grad and not got[2].requires_grad

    def jloss(a, b, c):
        return jnp.sum(jops.bn_train_op(a, b, c, 1e-5, True)[0] * gy)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                    (x, gamma, beta)))
    leaves = [_t(a, True) for a in (x, gamma, beta)]
    y = ops.bn_train_op(*leaves)[0]
    for a, b in zip(torch.autograd.grad((y * _t(gy)).sum(), leaves), want):
        _close(a, b)


# ---------------------------------------------------------------------------
# The spike matmul ops: packed forward, dense VJP
# ---------------------------------------------------------------------------

def test_spike_matmul_train_op_grads_match_custom_vjp():
    rng = np.random.default_rng(7)
    s = _spikes(rng, (40, 32))
    w = (rng.normal(size=(32, 24)) / 32 ** 0.5).astype(np.float32)
    g = rng.normal(0, 1, (40, 24)).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(jops.spike_matmul_train_op(
        a, b, True) * g), argnums=(0, 1))(jnp.asarray(s), jnp.asarray(w))
    st, wt = _t(s, True), _t(w, True)
    got = torch.autograd.grad((ops.spike_matmul_train_op(st, wt)
                               * _t(g)).sum(), (st, wt))
    for a, b in zip(got, want):
        _close(a, b)


def test_spike_bmm_train_op_grads_come_back_in_the_views_shape():
    """attn_qk as the model calls it: per-head views with two batch levels
    and K^T a transposed view; the gradients land on the views' bases."""
    rng = np.random.default_rng(8)
    tb, n, h, dh = 3, 12, 2, 8
    q, k = (_spikes(rng, (tb, n, h * dh)) for _ in range(2))
    g = rng.normal(0, 1, (tb, h, n, n)).astype(np.float32)
    qt, kt = _t(q, True), _t(k, True)
    qh, kh = (a.view(tb, n, h, dh).permute(0, 2, 1, 3) for a in (qt, kt))
    out = ops.spike_bmm_train_op(qh, kh.transpose(-1, -2))
    assert out.shape == (tb, h, n, n)
    gq, gk = torch.autograd.grad((out * _t(g)).sum(), (qt, kt))

    def jloss(a, b):
        ah = a.reshape(tb, n, h, dh).transpose(0, 2, 1, 3).reshape(-1, n, dh)
        bh = b.reshape(tb, n, h, dh).transpose(0, 2, 1, 3).reshape(-1, n, dh)
        o = jops.spike_bmm_train_op(ah, bh.transpose(0, 2, 1), True)
        return jnp.sum(o.reshape(tb, h, n, n) * g)

    wq, wk = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))
    _close(gq, wq)
    _close(gk, wk)


def test_spike_patch_mm_train_op_grads_match_custom_vjp():
    rng = np.random.default_rng(9)
    p = _spikes(rng, (3, 20, 24))
    w = (rng.normal(size=(24, 10)) / 24 ** 0.5).astype(np.float32)
    g = rng.normal(0, 1, (3, 20, 10)).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(jops.spike_patch_mm_train_op(
        a, b, True) * g), argnums=(0, 1))(jnp.asarray(p), jnp.asarray(w))
    pt, wt = _t(p, True), _t(w, True)
    got = torch.autograd.grad((ops.spike_patch_mm_train_op(pt, wt)
                               * _t(g)).sum(), (pt, wt))
    for a, b in zip(got, want):
        _close(a, b)


# ---------------------------------------------------------------------------
# K4 neuron_layer_train, the two neuron-layer ops
# ---------------------------------------------------------------------------

def _layer_inputs(rng, t, m, c, k, packed):
    x = _spikes(rng, (t, m, c)) if packed \
        else rng.normal(0.5, 1.0, (t, m, c)).astype(np.float32)
    w = (rng.normal(size=(c, k)) * 1.5 / c ** 0.5).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, (k,)).astype(np.float32)
    beta = rng.normal(0, 0.3, (k,)).astype(np.float32)
    return x, w, gamma, beta


def _margin(x, w, gamma, beta, alpha=0.5, th_fire=1.0):
    """The smallest |U - th_fire| of the reference's forward on these
    inputs: spikes compare exactly only where no membrane sits within
    rounding of the threshold."""
    _, u = _reference_u(x, w, gamma, beta, alpha)
    return float(np.min(np.abs(u - th_fire)))


def _reference_u(x, w, gamma, beta, alpha):
    t, m, _ = x.shape
    z = np.einsum("tmc,ck->tmk", x.astype(np.float64), w)
    zf = z.reshape(t * m, -1)
    mu = zf.mean(0)
    var = np.maximum((zf * zf).mean(0) - mu * mu, 0)
    y = gamma * (z - mu) / np.sqrt(var + 1e-5) + beta
    u, s, us = np.zeros_like(y[0]), np.zeros_like(y[0]), []
    for i in range(t):
        u = alpha * u * (1 - s) + y[i]
        s = (u >= 1.0).astype(np.float64)
        us.append(u)
    return y, np.stack(us)


@pytest.mark.parametrize("t,m,c,k,packed", [
    (2, 24, 40, 16, True), (4, 33, 72, 20, True), (2, 30, 27, 12, False),
    (3, 17, 20, 9, False), (1, 37, 27, 64, False), (8, 19, 27, 16, False)])
def test_neuron_layer_train_plain_matches_kernel(t, m, c, k, packed):
    rng = np.random.default_rng(t * m + c)
    x, w, gamma, beta = _layer_inputs(rng, t, m, c, k, packed)
    assert _margin(x, w, gamma, beta) > 1e-4
    s, mu, var = neuron_layer.neuron_layer_train(
        _t(x), _t(w), _t(gamma), _t(beta), packed=packed)
    ws, wmu, wvar = jnl.neuron_layer_train(
        *map(jnp.asarray, (x, w, gamma, beta)), packed=packed, interpret=True)
    _eq(s, ws)
    assert tuple(mu.shape) == wmu.shape and tuple(var.shape) == wvar.shape
    np.testing.assert_allclose(mu.numpy(), np.asarray(wmu), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(wvar), atol=1e-6,
                               rtol=1e-6)
    assert 0.02 < float(s.mean()) < 0.98


def test_neuron_layer_train_checks():
    x, w, v = torch.zeros(2, 4, 12), torch.zeros(12, 3), torch.zeros(3)
    with pytest.raises(ValueError, match="multiple of 8"):
        neuron_layer.neuron_layer_train(x, w, v, v, packed=True)
    with pytest.raises(ValueError, match="weight contraction"):
        neuron_layer.neuron_layer_train(x, torch.zeros(16, 3), v, v)
    with pytest.raises(ValueError, match="beta shape"):
        neuron_layer.neuron_layer_train(x, w, v, torch.zeros(4))


@pytest.mark.parametrize("packed", [False, True])
def test_neuron_layer_train_op_grads_match_custom_vjp(packed):
    """The replay backward (recomputed pre-activation -> SOMA -> GRAD -> BN
    backward -> dense matmul VJP) against the reference's, all four inputs;
    the cumsum makes the cotangent differ per time step."""
    rng = np.random.default_rng(10)
    x, w, gamma, beta = _layer_inputs(rng, 2, 20, 32, 24, packed)
    args = (0.5, 1.0, 0.0, 2.0, 1.0, 1e-5, packed)

    def jloss(*a):
        s = jops.neuron_layer_train_op(*a, *args, True)[0]
        return jnp.sum(jnp.cumsum(s, axis=0) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, w, gamma, beta)))
    leaves = [_t(a, True) for a in (x, w, gamma, beta)]
    s, mu, var = ops.neuron_layer_train_op(*leaves, *args)
    ws, wmu, wvar = jops.neuron_layer_train_op(
        *map(jnp.asarray, (x, w, gamma, beta)), *args, True)
    _eq(s, ws)
    assert mu.shape == (24,) and not mu.requires_grad
    np.testing.assert_allclose(var.numpy(), np.asarray(wvar), atol=1e-6,
                               rtol=1e-6)
    got = torch.autograd.grad((torch.cumsum(s, 0) ** 2).sum(), leaves)
    for a, b in zip(got, want):
        _close(a, b)


def test_neuron_layer_eval_op_grads_match_custom_vjp():
    rng = np.random.default_rng(11)
    x = _spikes(rng, (2, 16, 24), 0.4)
    w = (rng.normal(size=(24, 16)) * 1.5 / 24 ** 0.5).astype(np.float32)
    bias = rng.normal(0.3, 0.3, (16,)).astype(np.float32)
    g = rng.normal(0, 1, (2, 16, 16)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jops.neuron_layer_eval_op(
        *a, 0.5, 1.0, 0.0, 2.0, 1.0, True, True) * g), argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, w, bias)))
    leaves = [_t(a, True) for a in (x, w, bias)]
    s = ops.neuron_layer_eval_op(*leaves, 0.5, 1.0, 0.0, 2.0, 1.0, True)
    got = torch.autograd.grad((s * _t(g)).sum(), leaves)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("t,m,c,k,packed", [
    (2, 24, 40, 16, True), (4, 33, 72, 20, True), (2, 30, 27, 12, False),
    (3, 17, 20, 9, False)])
def test_replay_z_plain_matches_the_reference_replay(t, m, c, k, packed):
    """The train arm's first pass alone, the product both ops' backward
    replays, against the reference backward's einsum
    (``repro.kernels.ops._nl_train_bwd``): scale-aware 1e-6, the same fp32
    products summed by two libraries; the wrapper takes its plain version
    on the CPU, bit for bit."""
    rng = np.random.default_rng(t * m + k)
    x, w, _, _ = _layer_inputs(rng, t, m, c, k, packed)
    z = neuron_layer.neuron_layer_train_z(_t(x), _t(w), packed=packed)
    assert z.dtype == torch.float32 and z.shape == (t, m, k)
    assert torch.equal(z, neuron_layer.neuron_layer_train_z_plain(_t(x),
                                                                  _t(w)))
    want = jnp.einsum("tmc,ck->tmk", jnp.asarray(x, jnp.float32),
                      jnp.asarray(w, jnp.float32))
    _close(z, want, atol=1e-6)


def _near_threshold(x, w, gamma, beta):
    """Rescale beta so that the reference's membranes come close to the
    threshold: the replay must then reproduce membranes that any other
    rounding of z could move across it."""
    y, _ = _reference_u(x, w, gamma, beta, 0.5)
    beta = beta + (1.0 - np.median(y[0], axis=0)).astype(np.float32)
    return beta.astype(np.float32)


@pytest.mark.parametrize("op", ["train", "eval"])
@pytest.mark.parametrize("packed", [True, False])
def test_replay_reproduces_the_forward_spikes_bitwise(op, packed):
    """What the backward replays (z by the forward kernel's first pass, BN
    with the forward's own mu and sqrt_d, in its order; or z + bias) gives,
    through SOMA, the spikes the forward emitted, bit for bit, on Gaussian
    weights with membranes brought near the threshold."""
    rng = np.random.default_rng(12 + packed)
    x, w, gamma, beta = _layer_inputs(rng, 4, 48, 64 if packed else 27, 32,
                                      packed)
    beta = _near_threshold(x, w, gamma, beta)
    xt, wt = _t(x), _t(w)
    if op == "train":
        s, mu, var, sqrt_d, xin = neuron_layer.neuron_layer_train_fwd(
            xt, wt, _t(gamma), _t(beta), packed=packed)
        assert torch.equal(sqrt_d, torch.sqrt(var + 1e-5))
        _, y = ops.replay_train_pre_activation(
            xt, xin, wt, _t(gamma), _t(beta), mu, sqrt_d, packed)
        assert torch.equal(s, ops.neuron_layer_train_op(
            xt, wt, _t(gamma), _t(beta), 0.5, 1.0, 0.0, 2.0, 1.0, 1e-5,
            packed)[0])
    else:
        s = ops.neuron_layer_eval_op(xt, wt, _t(beta), 0.5, 1.0, 0.0, 2.0,
                                     1.0, packed)
        y = ops.replay_eval_pre_activation(xt, wt, _t(beta), packed)
    replayed, u, _ = lif_soma.lif_soma_fwd(y)
    assert torch.equal(replayed, s.detach())
    assert 0.05 < float(s.mean()) < 0.95
    assert float((u - 1.0).abs().min()) < 1e-3     # membranes at threshold
