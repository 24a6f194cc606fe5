"""The port's kernel oracles (``repro_torch.kernels.ref``) against the
reference's (``repro.kernels.ref``), and the plain version beside each
wrapper against the port's oracle.

The same numpy inputs, made from a seed, go through both. Tolerances: the
LIF forward scan is bitwise (the same fp32 operations in the same order);
the GRAD recursion is bitwise against eq. 12 in numpy float32, every
operation rounded once (the order of the port's oracle, its plain version
and its kernel), and within 1e-6 absolute of the reference's, whose XLA
scan contracts one multiply-add into an FMA (``test_torch_grads.py``'s
``_near``); products and reductions are within 1e-6 of their scale (the
same terms summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import single_thread

from repro.kernels import ref as jref
from repro_torch.kernels import (conv_spike, fused_bn, lif_soma,
                                 neuron_layer, spike_matmul)
from repro_torch.kernels import ref

single_thread()

LIFS = [dict(alpha=0.5, th_fire=1.0, th_lo=0.0, th_hi=2.0),
        dict(alpha=0.3, th_fire=0.7, th_lo=-0.2, th_hi=1.1)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _eq(got, want):
    for g, w in zip(_tuple(got), _tuple(want), strict=True):
        np.testing.assert_array_equal(_np(g), _np(w))


def _scaled(got, want, tol=1e-6):
    """Each output within ``tol`` of its scale (max |want|)."""
    for g, w in zip(_tuple(got), _tuple(want), strict=True):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale, \
            (float(np.abs(g - w).max()), scale)


def _spikes(rng, shape, rate=0.3):
    return (rng.random(shape) < rate).astype(np.float32)


def _strict_grad(g, u, s, m, gu_last, alpha, grad_scale):
    """eq. 12 in numpy float32, every operation rounded once, left to
    right; ``gu_last`` added at t = T-1 after the step's own terms."""
    f = np.float32
    gu, dx = np.zeros_like(g[0]), np.zeros_like(g)
    for t in reversed(range(g.shape[0])):
        gs = g[t] - f(alpha) * u[t] * gu
        gu = gu * f(alpha) * (f(1) - s[t]) + gs * m[t] * f(grad_scale)
        if gu_last is not None and t == g.shape[0] - 1:
            gu = gu + gu_last
        dx[t] = gu
    return dx


def _lif_signals(rng, shape, lif):
    x = rng.normal(0.3, 1.2, shape).astype(np.float32)
    s, u, m = (np.asarray(a) for a in jref.lif_soma_fwd_ref(
        jnp.asarray(x), **lif))
    g = rng.normal(0, 1, shape).astype(np.float32)
    return x, g, u, s, m


# ---------------------------------------------------------------------------
# The LIF scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 9, 13), (1, 5, 8), (6, 16, 64)])
@pytest.mark.parametrize("lif", LIFS)
def test_lif_soma_fwd_ref_bitwise(shape, lif):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(0.3, 1.2, shape).astype(np.float32)
    got = ref.lif_soma_fwd_ref(_t(x), **lif)
    _eq(got, jref.lif_soma_fwd_ref(jnp.asarray(x), **lif))
    _eq(lif_soma.lif_soma_fwd_plain(_t(x), **lif), got)


@pytest.mark.parametrize("shape", [(4, 9, 13), (1, 5, 8), (6, 16, 64)])
@pytest.mark.parametrize("lif", LIFS)
@pytest.mark.parametrize("carry", [False, True])
def test_lif_soma_bwd_refs(shape, lif, carry):
    rng = np.random.default_rng(sum(shape) + 7)
    _, g, u, s, m = _lif_signals(rng, shape, lif)
    gu = rng.normal(0, 1, shape[1:]).astype(np.float32) if carry else None
    kw = dict(alpha=lif["alpha"], grad_scale=0.8)
    args = (g, u, s, m) + ((gu,) if carry else ())
    mine = ref.lif_soma_bwd_carry_ref if carry else ref.lif_soma_bwd_ref
    theirs = jref.lif_soma_bwd_carry_ref if carry else jref.lif_soma_bwd_ref
    got = mine(*map(_t, args), **kw)
    _eq(got, _strict_grad(g, u, s, m, gu, **kw))
    np.testing.assert_allclose(_np(got), np.asarray(
        theirs(*map(jnp.asarray, args), **kw)), atol=1e-6, rtol=0)
    _eq(lif_soma.lif_soma_bwd_plain(*map(_t, args), **kw), got)


# ---------------------------------------------------------------------------
# The spike products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,c,k", [(24, 32, 16), (7, 72, 33)])
def test_spike_matmul_refs(m, c, k):
    rng = np.random.default_rng(m * c + k)
    s = _spikes(rng, (m, c))
    w = rng.normal(0, c ** -0.5, (c, k)).astype(np.float32)
    got = ref.spike_matmul_ref(_t(s), _t(w))
    _scaled(got, jref.spike_matmul_ref(jnp.asarray(s), jnp.asarray(w)))
    _scaled(spike_matmul.spike_matmul(_t(s), _t(w)), got)


@pytest.mark.parametrize("g,m,c,k", [(3, 16, 32, 12), (2, 5, 64, 7)])
def test_spike_matmul_batched_refs(g, m, c, k):
    rng = np.random.default_rng(g * m * c + k)
    s = _spikes(rng, (g, m, c))
    w = rng.normal(0, c ** -0.5, (g, c, k)).astype(np.float32)
    got = ref.spike_matmul_batched_ref(_t(s), _t(w))
    _scaled(got, jref.spike_matmul_batched_ref(jnp.asarray(s),
                                               jnp.asarray(w)))
    _scaled(spike_matmul.spike_matmul_batched(_t(s), _t(w)), got)


@pytest.mark.parametrize("t,m,c,k", [(4, 16, 72, 24), (2, 9, 144, 8)])
def test_spike_patch_matmul_refs(t, m, c, k):
    rng = np.random.default_rng(t * m * c + k)
    p = _spikes(rng, (t, m, c))
    w = rng.normal(0, c ** -0.5, (c, k)).astype(np.float32)
    got = ref.spike_patch_matmul_ref(_t(p), _t(w))
    _scaled(got, jref.spike_patch_matmul_ref(jnp.asarray(p), jnp.asarray(w)))
    _scaled(conv_spike.spike_patch_matmul(_t(p), _t(w)), got)


# ---------------------------------------------------------------------------
# BN and the neuron layer
# ---------------------------------------------------------------------------

def _bn_inputs(rng, m, d):
    x = rng.normal(0.5, 2.0, (m, d)).astype(np.float32)
    gamma = (rng.random(d) + 0.5).astype(np.float32)
    beta = rng.normal(0, 0.3, d).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("m,d", [(96, 16), (37, 5)])
def test_bn_fwd_refs(m, d):
    x, gamma, beta = _bn_inputs(np.random.default_rng(m + d), m, d)
    got = ref.bn_fwd_ref(_t(x), _t(gamma), _t(beta))
    _scaled(got, jref.bn_fwd_ref(*map(jnp.asarray, (x, gamma, beta))))
    _scaled(fused_bn.bn_fwd_plain(_t(x), _t(gamma), _t(beta)), got)


@pytest.mark.parametrize("m,d", [(96, 16), (37, 5)])
def test_bn_bwd_refs(m, d):
    rng = np.random.default_rng(m * d)
    x, gamma, _ = _bn_inputs(rng, m, d)
    g = rng.normal(0, 1, (m, d)).astype(np.float32)
    _, mu, sqrt_d = (np.asarray(a) for a in jref.bn_fwd_ref(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(gamma)))
    args = (g, x, gamma, mu, sqrt_d)
    got = ref.bn_bwd_ref(*map(_t, args))
    _scaled(got, jref.bn_bwd_ref(*map(jnp.asarray, args)), 1e-5)
    _scaled(fused_bn.bn_bwd_plain(*map(_t, args)), got, 1e-5)


def _layer_inputs(rng, t, m, c, k):
    x = _spikes(rng, (t, m, c))
    w = rng.normal(0, 2 * c ** -0.5, (c, k)).astype(np.float32)
    gamma = (rng.random(k) + 0.5).astype(np.float32)
    beta = rng.normal(0.5, 0.3, k).astype(np.float32)
    return x, w, gamma, beta


@pytest.mark.parametrize("t,m,c,k", [(4, 24, 32, 16), (2, 9, 72, 10)])
def test_neuron_layer_train_refs(t, m, c, k):
    """Spikes compared whole (the inputs keep every membrane clear of the
    threshold by more than the rounding of z), statistics to scale."""
    rng = np.random.default_rng(t * m * c * k)
    args = _layer_inputs(rng, t, m, c, k)
    got = ref.neuron_layer_train_ref(*map(_t, args))
    want = jref.neuron_layer_train_ref(*map(jnp.asarray, args))
    _eq(got[0], want[0])
    _scaled(got[1:], want[1:], 1e-5)
    plain = neuron_layer.neuron_layer_train_plain(*map(_t, args))
    _eq(plain[0], got[0])
    _scaled(plain[1:], got[1:], 1e-5)


@pytest.mark.parametrize("t,m,c,k", [(4, 24, 32, 16), (2, 9, 72, 10)])
def test_neuron_layer_eval_refs(t, m, c, k):
    rng = np.random.default_rng(t + m + c + k)
    x, w, _, bias = _layer_inputs(rng, t, m, c, k)
    got = ref.neuron_layer_eval_ref(_t(x), _t(w), _t(bias))
    _eq(got, jref.neuron_layer_eval_ref(*map(jnp.asarray, (x, w, bias))))
    _eq(neuron_layer.neuron_layer_eval_plain(_t(x), _t(w), _t(bias)), got)


def test_oracles_run_on_meta_tensors():
    """The contract verifier calls every oracle on meta operands."""
    from repro_torch.kernels.contract import KernelCase, kernel_contracts

    case = KernelCase(t=2, m=16, c=16, k=8)
    for decl in kernel_contracts().values():
        args, _, ref_kwargs = decl.build(case)
        outs = _tuple(decl.ref(*args, **ref_kwargs))
        assert all(o.device.type == "meta" for o in outs), decl.name


def test_oracles_import_no_kernel_module():
    """The oracles stand apart from the plain versions beside the
    wrappers: ``kernels/ref.py`` imports none of the kernel modules."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(ref))
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert names and all(not n.startswith("repro") for n in names), names
