"""bf16 through the port, against the JAX package at bf16 on the CPU.

The reference's kernels take bf16 (its own suite sweeps them at bf16,
``tests/test_kernels.py``), its LM configs default to bf16 and the
Spikingformer has a ``dtype``. Here:

* ``convert.from_jax`` / ``lm_from_jax`` / ``opt_state_from_jax`` carry the
  reference's bf16 leaves (``ml_dtypes.bfloat16``) bit for bit;
* every bf16 oracle of ``kernels/ref.py`` against the reference's Pallas
  kernel in interpret mode at bf16, at ``tests/test_kernels.py``'s shapes:
  bit for bit with exact operands (weights k/64, |k| <= 4), elsewhere
  within that file's bf16 tolerances (the LIF recursions and BN are bit for
  bit on Gaussian operands too: both round every operation as bf16 tensor
  ops do), and the plain versions the wrappers take on the CPU against the
  same oracles;
* the port's eager ops at bf16 against the reference's ``jnp`` ops;
* ``spikingformer-smoke`` at bf16: the loss, the new BN state and every
  gradient leaf against the reference's ``jnp``;
* reduced ``qwen3-0.6b`` + LIF at bf16: the loss and every gradient leaf,
  the prefill and 3 decode steps against the reference;
* every ``meta`` branch allocates bf16 outputs at bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (as_jax, both_policies, lm_cfgs, np_tree,
                         randomize_bn, single_thread)

from repro.configs.spikingformer import SPIKINGFORMER_PRESETS as JAX_PRESETS
from repro.core import spikingformer as jsf
from repro.core.lif import LIFConfig as JLIFConfig
from repro.core.lif import lif_scan as jlif_scan
from repro.core import spiking_layers as jsl
from repro.core.policy import named_policy as jax_named_policy
from repro.kernels import fused_bn as jbn
from repro.kernels import lif_soma as jlif
from repro.kernels import neuron_layer as jnl
from repro.kernels import spike_matmul as jsm
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro_torch.configs import SPIKINGFORMER_PRESETS
from repro_torch.convert import from_jax, lm_from_jax, opt_state_from_jax
from repro_torch.core import spiking_layers as tsl
from repro_torch.core import spikingformer as tsf
from repro_torch.core.lif import LIFConfig, lif_scan
from repro_torch.core.policy import named_policy
from repro_torch.core.spikingformer import tree_leaves, value_and_grad
from repro_torch.kernels import (fused_bn, lif_soma, neuron_layer, ref,
                                 spike_matmul)
from repro_torch.models import lm as tlm

single_thread()
KEY = jax.random.PRNGKey(42)
BF16 = torch.bfloat16


def t16(a) -> torch.Tensor:
    """A JAX or numpy bf16 array -> a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(BF16)


def bits(a) -> np.ndarray:
    """The 16-bit patterns of a bf16 array of either package."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def same_bits(got, want):
    """Both bf16 and equal element for element: the same bits, up to the
    sign of a zero (XLA and PyTorch may part there, as the fp32 LIF tests
    of ``test_torch_lif_layout.py`` found)."""
    assert got.dtype == BF16 and np.asarray(want).dtype.name == "bfloat16"
    np.testing.assert_array_equal(f32(got), f32(want))


def exact_w(key, shape, scale=64, span=4):
    """k / scale, |k| <= span: exact in bf16, and every fp32 sum of a few
    hundred of them (times spikes) exact too."""
    return (jax.random.randint(key, shape, -span, span + 1) / scale
            ).astype(jnp.bfloat16)


#: A gradient leaf computed in bf16 by both packages: the same ops, its
#: sums over thousands of bf16-rounded terms in other orders and at other
#: precisions (XLA's and PyTorch's bf16 products), so it parts by several
#: units of bf16's eighth significant bit. Measured on these models: up to
#: 4.8e-2 relative L2 and 5.2e-2 of the leaf's scale (spikingformer-smoke),
#: 8e-2 relative L2 on the LM's smallest leaves and 1e-2 of the scale.
BF16_GRAD_TOL = 0.1


def bf16_grads_close(got, want):
    """A bf16 gradient leaf against the reference's: within
    ``BF16_GRAD_TOL`` relative L2 and each element within
    ``BF16_GRAD_TOL`` of the leaf's scale, max(1, max|want|)."""
    a, b = f32(got), f32(want)
    assert np.linalg.norm(a - b) <= BF16_GRAD_TOL * max(np.linalg.norm(b),
                                                        1e-30)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a / scale, b / scale, atol=BF16_GRAD_TOL)


def spikes_of(key, shape, rate):
    return (jax.random.uniform(key, shape) < rate).astype(jnp.float32)


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------

def _tree_bits_equal(got, want):
    leaves = jax.tree.leaves(want)
    assert len(tree_leaves(got)) == len(leaves) > 0
    for a, b in zip(tree_leaves(got), leaves):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        if b.dtype.name == "bfloat16":
            assert a.dtype == BF16
            np.testing.assert_array_equal(bits(a), bits(b))
        else:
            assert str(a.dtype) == f"torch.{b.dtype}"
            np.testing.assert_array_equal(a.numpy(), b)


def test_from_jax_carries_the_vision_tree_in_bf16_bit_for_bit():
    jcfg = dataclasses.replace(JAX_PRESETS["spikingformer-smoke"],
                               dtype=jnp.bfloat16)
    p, s = jsf.init_spikingformer(KEY, jcfg)
    p, s = randomize_bn(np_tree(p), np_tree(s), np.random.default_rng(0))
    assert any(np.asarray(a).dtype.name == "bfloat16"
               for a in jax.tree.leaves(p))
    tp, ts = from_jax(p, s, device="cpu")
    _tree_bits_equal(tp, p)
    _tree_bits_equal(ts, s)


def test_lm_from_jax_and_opt_state_carry_qwen3_in_bf16_bit_for_bit():
    jcfg, _ = lm_cfgs("qwen3-0.6b", "jnp")
    jcfg = jcfg.replace(dtype=jnp.bfloat16)
    jp = np_tree(jcommon.split_tree(jlm.init_lm(KEY, jcfg))[0])
    assert all(a.dtype.name == "bfloat16" for a in jax.tree.leaves(jp)
               if a.ndim > 1)
    _tree_bits_equal(lm_from_jax(jp, device="cpu"), jp)
    state = np_tree(jopt.init_opt_state(as_jax(jp)))
    half = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a) + 0.3, jnp.bfloat16),
        state["m"])
    got = opt_state_from_jax({"m": half, "v": half, "step": state["step"],
                              "err": None}, device="cpu")
    _tree_bits_equal(got["m"], half)
    _tree_bits_equal(got["v"], half)


# ---------------------------------------------------------------------------
# The bf16 oracles (and the plain versions) against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 2, 4, 6])
def test_lif_oracles_equal_the_pallas_kernels_at_bf16(t):
    """SOMA and GRAD (plain and with the carry) on Gaussian currents, at
    ``test_kernels.py``'s (32, 64): U, S, the mask and dx bit for bit."""
    x = (jax.random.normal(KEY, (t, 32, 64)) * 2).astype(jnp.bfloat16)
    want = jlif.lif_soma_fwd(x, block_m=64, block_d=64)
    got = ref.lif_soma_fwd_ref(t16(x))
    plain = lif_soma.lif_soma_fwd_plain(t16(x))
    for a, b, c in zip(got, want, plain):
        same_bits(a, b)
        same_bits(c, b)
    s, u, m = want
    g = jax.random.normal(jax.random.PRNGKey(7), x.shape).astype(jnp.bfloat16)
    gu = jax.random.normal(jax.random.PRNGKey(8), x.shape[1:]).astype(
        jnp.bfloat16)
    ops = [t16(a) for a in (g, u, s, m)]
    for alpha in (0.25, 0.5):
        dx = jlif.lif_soma_bwd(g, u, s, m, alpha=alpha, block_m=32,
                               block_d=32)
        same_bits(ref.lif_soma_bwd_ref(*ops, alpha=alpha), dx)
        same_bits(lif_soma.lif_soma_bwd_plain(*ops, alpha=alpha), dx)
        dxc = jlif.lif_soma_bwd(g, u, s, m, gu, alpha=alpha, block_m=32,
                                block_d=32)
        same_bits(ref.lif_soma_bwd_carry_ref(*ops, t16(gu), alpha=alpha),
                  dxc)
        same_bits(lif_soma.lif_soma_bwd_plain(*ops, t16(gu), alpha=alpha),
                  dxc)


@pytest.mark.parametrize("m,c,k", [(64, 128, 64), (100, 256, 72),
                                   (256, 512, 256), (33, 64, 129)])
@pytest.mark.parametrize("rate", [0.0, 0.2, 1.0])
def test_spike_matmul_oracle_equals_the_pallas_kernel_at_bf16(m, c, k, rate):
    sp = spikes_of(KEY, (m, c), rate)
    w = exact_w(jax.random.PRNGKey(1), (c, k))
    want = jsm.spike_matmul(sp, w, block_m=64, block_k=64, block_c=64)
    assert want.dtype == jnp.bfloat16
    got = ref.spike_matmul_ref(torch.from_numpy(np.asarray(sp)), t16(w))
    same_bits(got, want)
    packed = spike_matmul.spike_pack(torch.from_numpy(np.asarray(sp)))
    same_bits(spike_matmul.spike_matmul_packed(packed, t16(w)), want)
    # Gaussian weights: the products are exact, the fp32 sums in another
    # order; within the reference's own bf16 tolerance
    wg = (jax.random.normal(jax.random.PRNGKey(1), (c, k)) / c ** 0.5
          ).astype(jnp.bfloat16)
    want = jsm.spike_matmul(sp, wg, block_m=64, block_k=64, block_c=64)
    got = ref.spike_matmul_ref(torch.from_numpy(np.asarray(sp)), t16(wg))
    np.testing.assert_allclose(f32(got), f32(want), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("g,m,c,k", [(2, 16, 16, 16), (6, 64, 32, 64),
                                     (3, 33, 40, 17)])
def test_spike_matmul_batched_oracle_equals_the_pallas_kernel_at_bf16(
        g, m, c, k):
    sp = spikes_of(KEY, (g, m, c), 0.3)
    w = exact_w(jax.random.PRNGKey(1), (g, c, k))
    want = jsm.spike_matmul_batched(sp, w, block_m=32, block_k=32,
                                    block_c=16)
    got = ref.spike_matmul_batched_ref(torch.from_numpy(np.asarray(sp)),
                                       t16(w))
    same_bits(got, want)
    packed = spike_matmul.spike_pack(torch.from_numpy(np.asarray(sp)))
    same_bits(spike_matmul.spike_matmul_packed_batched(packed, t16(w)), want)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("m,d", [(64, 64), (200, 96), (512, 512), (100, 40)])
def test_bn_oracles_equal_the_pallas_kernels_at_bf16(m, d, exact):
    """y bf16 bit for bit on exact inputs (x = k/16, every sum exact), else
    within ``test_kernels.py``'s bf16 tolerance (the statistics, summed in
    another order, may move a y by one unit in its last place); the fp32
    statistics, dx, dgamma and dbeta within that file's tolerances."""
    x = exact_w(KEY, (m, d), 16, 48) if exact else \
        (jax.random.normal(KEY, (m, d)) * 3 + 1).astype(jnp.bfloat16)
    gamma = jax.random.uniform(jax.random.PRNGKey(5), (d,)) + 0.5
    beta = jax.random.normal(jax.random.PRNGKey(6), (d,))
    y, mu, sq = jbn.bn_fwd(x, gamma, beta, block_d=32)
    args = (t16(x), torch.from_numpy(np.asarray(gamma)),
            torch.from_numpy(np.asarray(beta)))
    for got in (ref.bn_fwd_ref(*args), fused_bn.bn_fwd_plain(*args)):
        if exact:
            same_bits(got[0], y)
        else:
            assert got[0].dtype == BF16
            np.testing.assert_allclose(f32(got[0]), f32(y), atol=5e-2)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(mu), atol=1e-5)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(sq), atol=1e-5)
    g = jax.random.normal(jax.random.PRNGKey(7), (m, d)).astype(jnp.bfloat16)
    dx, dg, db = jbn.bn_bwd(g, x, gamma, mu, sq, block_d=32)
    assert dx.dtype == jnp.bfloat16
    targs = (t16(g), t16(x), args[1], torch.from_numpy(np.asarray(mu)),
             torch.from_numpy(np.asarray(sq)))
    for got in (ref.bn_bwd_ref(*targs), fused_bn.bn_bwd_plain(*targs)):
        np.testing.assert_allclose(f32(got[0]), f32(dx), atol=5e-2)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(dg),
                                   atol=1e-3, rtol=1e-5)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(db),
                                   atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("t,m,c,k", [(4, 33, 24, 20), (2, 64, 64, 48)])
def test_neuron_layer_oracles_equal_the_pallas_kernels_at_bf16(packed, t, m,
                                                               c, k):
    """The train and eval neuron layers at bf16: spikes (bf16) bit for bit
    with exact operands; the train statistics within 1e-5. The oracles
    (and the plain versions) follow the Pallas kernel, which fires on the
    fp32 accumulator."""
    x = spikes_of(KEY, (t, m, c), 0.3).astype(jnp.bfloat16) if packed \
        else exact_w(KEY, (t, m, c), 16, 16)
    w = exact_w(jax.random.PRNGKey(1), (c, k))
    gamma = (jax.random.uniform(jax.random.PRNGKey(2), (k,)) + 0.5
             ).astype(jnp.bfloat16)
    beta = (jax.random.normal(jax.random.PRNGKey(3), (k,)) * 0.3 + 0.5
            ).astype(jnp.bfloat16)
    s, mu, var = jnl.neuron_layer_train(x, w, gamma, beta, packed=packed)
    assert s.dtype == jnp.bfloat16
    targs = (t16(x), t16(w), t16(gamma), t16(beta))
    for got in (ref.neuron_layer_train_ref(*targs),
                neuron_layer.neuron_layer_train(*targs, packed=packed)):
        same_bits(got[0], s)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(mu), atol=1e-5)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(var), atol=1e-5)
    bias = jax.random.normal(jax.random.PRNGKey(4), (k,)) * 0.1 + 0.5
    se = jnl.neuron_layer_eval(x, w, bias, packed=packed)
    targs = (t16(x), t16(w), torch.from_numpy(np.asarray(bias)))
    same_bits(ref.neuron_layer_eval_ref(*targs), se)
    same_bits(neuron_layer.neuron_layer_eval(*targs, packed=packed), se)


# ---------------------------------------------------------------------------
# The port's eager ops at bf16 against the reference's jnp ops
# ---------------------------------------------------------------------------

def test_eager_lif_and_bn_ops_equal_the_reference_jnp_ops_at_bf16():
    """``lif_scan`` forward and gradient, and training BN's forward and
    gradient, under ``eager`` / ``jnp`` at bf16."""
    x = (jax.random.normal(KEY, (4, 6, 32)) * 1.5 + 0.4).astype(jnp.bfloat16)
    g = jax.random.normal(jax.random.PRNGKey(1), x.shape).astype(jnp.bfloat16)
    jcfg = JLIFConfig(policy=jax_named_policy("jnp"))
    js, vjp = jax.vjp(lambda a: jlif_scan(a, jcfg), x)
    xt = t16(x).requires_grad_(True)
    ts = lif_scan(xt, LIFConfig(policy=named_policy("eager")))
    same_bits(ts.detach(), js)
    (dx,) = torch.autograd.grad(ts, xt, t16(g))
    np.testing.assert_allclose(f32(dx), f32(vjp(g)[0]), atol=2e-2)

    xb = (jax.random.normal(KEY, (40, 24)) * 2 + 1).astype(jnp.bfloat16)
    gamma = (jax.random.uniform(jax.random.PRNGKey(2), (24,)) + 0.5
             ).astype(jnp.bfloat16)
    beta = jnp.zeros((24,), jnp.bfloat16) + 0.25
    params = {"gamma": gamma, "beta": beta}
    state = {"mean": jnp.zeros((24,)), "var": jnp.ones((24,))}
    (jy, jst), jvjp = jax.vjp(
        lambda a: jsl.bn_apply(params, state, a, train=True,
                               policy=jax_named_policy("jnp")), xb)
    xbt = t16(xb).requires_grad_(True)
    ty, tst = tsl.bn_apply({k: t16(v) for k, v in params.items()},
                           {k: torch.from_numpy(np.asarray(v))
                            for k, v in state.items()}, xbt, train=True,
                           policy=named_policy("eager"))
    assert ty.dtype == BF16
    np.testing.assert_allclose(f32(ty.detach()), f32(jy), atol=2e-2)
    for k in ("mean", "var"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   atol=1e-5)
    gy = jax.random.normal(jax.random.PRNGKey(3), jy.shape).astype(
        jnp.bfloat16)
    jdx = jvjp((gy, jax.tree_util.tree_map(jnp.zeros_like, jst)))[0]
    (tdx,) = torch.autograd.grad(ty, xbt, t16(gy))
    np.testing.assert_allclose(f32(tdx), f32(jdx), atol=5e-2)


# ---------------------------------------------------------------------------
# The two models at bf16
# ---------------------------------------------------------------------------

def test_spikingformer_smoke_at_bf16_matches_the_reference_jnp():
    """Loss, every gradient leaf and the new BN state of the BPTT step at
    bf16 under ``eager`` against the reference's ``jnp``, on bf16 images
    (so that every layer runs in bf16 and the LIF sees bf16 currents): the
    loss to 1e-6 (fp32 after the head), the gradients as
    :func:`bf16_grads_close`, the BN state within 1e-5."""
    jp_, tp_ = both_policies("jnp")
    jcfg = dataclasses.replace(JAX_PRESETS["spikingformer-smoke"],
                               policy=jp_, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(SPIKINGFORMER_PRESETS["spikingformer-smoke"],
                               policy=tp_, dtype=BF16)
    p, s = jsf.init_spikingformer(KEY, jcfg)
    p, s = randomize_bn(np_tree(p), np_tree(s), np.random.default_rng(11))
    tp, ts = from_jax(p, s, device="cpu")
    # bf16 images: every layer computes in bf16 (each casts its weight to
    # its input's dtype, in both packages)
    x = jnp.asarray(np.random.default_rng(12).random((2, 32, 32, 3)),
                    jnp.bfloat16)
    labels = np.array([1, 3], np.int32)
    (loss, (wstate, _)), wgrads = jax.value_and_grad(
        jsf.spikingformer_loss, has_aux=True)(
        as_jax(p), as_jax(s), x, jnp.asarray(labels), jcfg)
    seen = []
    real = lif_soma.lif_soma_fwd_plain

    def spy(x, *a, **k):
        seen.append(x.dtype)
        return real(x, *a, **k)
    lif_soma.lif_soma_fwd_plain = spy
    try:
        grads, state, metrics = tsf.spikingformer_grad_step(
            tp, ts, t16(x), torch.from_numpy(labels), tcfg)
    finally:
        lif_soma.lif_soma_fwd_plain = real
    assert seen == [] or set(seen) == {BF16}
    assert abs(float(metrics["loss"]) - float(loss)) <= 1e-6
    wleaves = jax.tree.leaves(wgrads)
    gleaves = tree_leaves(grads)
    assert len(gleaves) == len(wleaves)
    for a, b in zip(gleaves, wleaves):
        assert str(a.dtype) == f"torch.{np.asarray(b).dtype}"
        bf16_grads_close(a, b)
    for a, b in zip(tree_leaves(state), jax.tree.leaves(wstate)):
        np.testing.assert_allclose(f32(a), f32(b), atol=1e-5)


def _lm_bf16(policy):
    jcfg, tcfg = lm_cfgs("qwen3-0.6b", policy)
    return jcfg.replace(dtype=jnp.bfloat16), tcfg.replace(dtype=BF16)


@pytest.mark.parametrize("policy", ["jnp", "pallas"])
def test_spiking_qwen3_at_bf16_trains_and_decodes_as_the_reference(policy):
    """Reduced ``qwen3-0.6b`` + LIF at bf16, the reference under ``jnp`` /
    ``pallas`` and the port under their twins (plain versions on the CPU):
    loss and metrics to 1e-3 relative, every gradient leaf as
    :func:`bf16_grads_close`, the prefill's logits and 3 decode
    steps from a bf16 cache within 2e-2, the cache's KV leaves too and its
    LIF carry with at most 1 % of its elements apart (a spike flipped by a
    bf16 rounding of the product before it)."""
    jcfg, tcfg = _lm_bf16(policy)
    jp = jcommon.split_tree(jlm.init_lm(jax.random.PRNGKey(0), jcfg))[0]
    tp = lm_from_jax(np_tree(jp), device="cpu")
    toks = np.array([[3, 7, 11, 2, 5, 9, 300, 41],
                     [8, 8, 1, 0, 511, 17, 5, 6]], np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    (jl, jm), jg = jax.value_and_grad(jlm.lm_loss, has_aux=True)(
        jp, as_jax(batch), jcfg)
    (tl, tm), tg = value_and_grad(
        tlm.lm_loss, tp, {k: torch.from_numpy(v) for k, v in batch.items()},
        tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5,
                                   rtol=1e-3)
    for a, b in zip(tree_leaves(tg), jax.tree.leaves(jg)):
        assert str(a.dtype) == f"torch.{np.asarray(b).dtype}"
        bf16_grads_close(a, b)
    want = jlm.lm_prefill(jp, {"tokens": toks}, jcfg)
    got = tlm.lm_prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-2, rtol=2e-2)
    jc = jlm.init_cache(jcfg, 2, 16, jnp.bfloat16)
    tc = tlm.init_cache(tcfg, 2, 16, BF16, "cpu")
    pos = np.array([0, 2], np.int32)
    for t in range(3):
        tok = toks[:, t:t + 1]
        jlg, jc = jlm.lm_decode_step(jp, jc, jnp.asarray(tok),
                                     jnp.asarray(pos), jcfg)
        tlg, tc = tlm.lm_decode_step(tp, tc, torch.from_numpy(tok),
                                     torch.from_numpy(pos), tcfg)
        np.testing.assert_allclose(f32(tlg), f32(jlg), atol=2e-2, rtol=2e-2)
        paths = jax.tree_util.tree_flatten_with_path(jc)[0]
        for a, (path, b) in zip(tree_leaves(tc), paths):
            assert tuple(a.shape) == np.asarray(b).shape
            off = ~np.isclose(f32(a), f32(b), atol=2e-2, rtol=2e-2)
            # the (U, S) carry: a membrane within a bf16 rounding of the
            # threshold may fire in one package and not the other
            limit = 0.01 if "lif" in jax.tree_util.keystr(path) else 0.0
            assert off.mean() <= limit, (jax.tree_util.keystr(path),
                                         off.mean())
        pos = pos + 1


# ---------------------------------------------------------------------------
# The meta branches
# ---------------------------------------------------------------------------

def test_every_meta_branch_allocates_bf16_outputs_at_bf16():
    def m(*shape, dtype=BF16):
        return torch.empty(shape, dtype=dtype, device="meta")

    x = m(4, 20, 64)
    for out in lif_soma.lif_soma_fwd(x) + lif_soma.lif_soma_fwd(
            x, m(20, 64), m(20, 64)):
        assert out.dtype == BF16 and out.is_meta
    assert lif_soma.lif_soma_bwd(x, x, x, x, m(20, 64)).dtype == BF16
    packed = m(20, 8, dtype=torch.uint8)
    assert spike_matmul.spike_matmul_packed(packed, m(64, 16)).dtype == BF16
    assert spike_matmul.spike_matmul_packed_batched(
        m(3, 20, 8, dtype=torch.uint8), m(3, 64, 16)).dtype == BF16
    y, mu, sq = fused_bn.bn_fwd(m(80, 16), m(16), m(16))
    assert (y.dtype, mu.dtype, sq.dtype) == (BF16, torch.float32,
                                             torch.float32)
    dx, dg, db = fused_bn.bn_bwd(m(80, 16), m(80, 16), m(16),
                                 m(1, 16, dtype=torch.float32),
                                 m(1, 16, dtype=torch.float32))
    assert (dx.dtype, dg.dtype, db.dtype) == (BF16, torch.float32,
                                              torch.float32)
    for packed in (False, True):
        s, mu, var = neuron_layer.neuron_layer_train(
            x, m(64, 32), m(32), m(32), packed=packed)
        assert (s.dtype, mu.dtype, var.dtype) == (BF16, torch.float32,
                                                  torch.float32)
        assert neuron_layer.neuron_layer_eval(
            x, m(64, 32), m(32, dtype=torch.float32),
            packed=packed).dtype == BF16
        assert neuron_layer.neuron_layer_train_z(
            x, m(64, 32), packed=packed).dtype == torch.float32
