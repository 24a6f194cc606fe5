"""The arithmetic the tensor-core spike matmul relies on, on the CPU.

The CUDA kernel (``csrc/spike_matmul.cu``) splits every fp32 weight into
three bf16 planes and adds the products of each spike fragment into two
fp32 accumulators, hi in one and mid + lo in the other, added at the end.
``split_bf16x3`` is the plain version of that split.
These tests hold the split to exactness (``hi + mid + lo == w`` bitwise)
and the three-plane product to fp32 ``torch.matmul``: bitwise where every
partial sum is exact (integer and dyadic weights), rtol 1e-5 / atol 1e-4 on
Gaussian weights (the same products, summed in another order). The kernel
itself runs only on a card: ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import single_thread

from repro.kernels import spike_matmul as jsm
from repro_torch.configs import get_spikingformer_config
from repro_torch.core.spikingformer import init_spikingformer, tree_leaves
from repro_torch.kernels import spike_matmul
from repro_torch.kernels.spike_matmul import split_bf16x3

single_thread()


def _planes_sum(w):
    hi, mid, lo = split_bf16x3(w)
    return hi.float() + mid.float() + lo.float()


def _three_plane_matmul(s, w):
    """What the kernel computes: one product per bf16 plane, in fp32, the
    hi plane's apart from the sum of the other two."""
    hi, mid, lo = (torch.matmul(s, p.float()) for p in split_bf16x3(w))
    return hi + (mid + lo)


def _full_mantissas(rng, n, exponent):
    """n fp32 values of both signs with all 24 significant bits random,
    in [2^e, 2^(e+1))."""
    mant = rng.integers(2 ** 23, 2 ** 24, n).astype(np.float64)
    sign = rng.choice([-1.0, 1.0], n)
    return torch.from_numpy(
        (sign * np.ldexp(mant, exponent - 23)).astype(np.float32))


@pytest.mark.parametrize("exponent", [-110, -100, -64, -20, -8, -1, 0, 1, 8,
                                      20, 64, 100, 126])
def test_split_is_exact_across_exponents(exponent):
    w = _full_mantissas(np.random.default_rng(exponent + 200), 4096, exponent)
    assert torch.equal(_planes_sum(w), w)
    hi, mid, lo = split_bf16x3(w)
    # every plane carries bits: a 24-bit mantissa needs all three
    assert bool((mid != 0).any()) and bool((lo != 0).any())


def test_split_of_zeros_and_bf16_values_leaves_empty_planes():
    w = torch.tensor([0.0, -0.0, 1.0, -2.5, 0.15625, 3.0 * 2.0 ** 120],
                     dtype=torch.float32)
    hi, mid, lo = split_bf16x3(w)
    assert torch.equal(hi.float(), w)
    assert not bool(mid.float().any()) and not bool(lo.float().any())
    assert torch.equal(torch.signbit(hi.float()), torch.signbit(w))


@pytest.mark.parametrize("preset", ["spikingformer-smoke",
                                    "spikingformer-smoke-dvs"])
def test_split_is_exact_on_the_initialised_weights(preset):
    cfg = get_spikingformer_config(preset + "@eager")
    params, _ = init_spikingformer(torch.Generator().manual_seed(0), cfg,
                                   torch.device("cpu"))
    leaves = [w for w in tree_leaves(params) if w.dtype == torch.float32]
    assert leaves
    for w in leaves:
        assert torch.equal(_planes_sum(w), w)


def test_split_rejects_other_dtypes():
    with pytest.raises(TypeError, match="float32"):
        split_bf16x3(torch.zeros(3, dtype=torch.float64))


def _spikes(rng, shape, rate=0.3):
    return torch.from_numpy((rng.random(shape) < rate).astype(np.float32))


def _sparse_rows(rng, shape, ones):
    """{0,1} rows with exactly ``ones`` set bits each."""
    s = np.zeros(shape, np.float32)
    idx = rng.random(shape).argsort(-1)[..., :ones]
    np.put_along_axis(s, idx, 1.0, -1)
    return torch.from_numpy(s)


@pytest.mark.parametrize("m,c,k", [(52, 64, 52), (33, 136, 20), (7, 8, 5)])
@pytest.mark.parametrize("kind", ["integer", "dyadic", "21-bit"])
def test_three_plane_product_is_bitwise_on_exact_weights(m, c, k, kind):
    """Every partial sum is exact in fp32, so the three-plane product must
    equal fp32 ``torch.matmul`` and the reference's Pallas kernel bit for
    bit. The 21-bit integers need all three planes (a bf16 holds 8
    significant bits); at most 12 set bits per row keep their sums below
    2^24."""
    rng = np.random.default_rng(c * 1000 + m)
    if kind == "integer":
        s, w = _spikes(rng, (m, c)), rng.integers(-8, 9, (c, k))
    elif kind == "dyadic":
        s, w = _spikes(rng, (m, c)), rng.integers(-16, 16, (c, k)) / 64
    else:
        s = _sparse_rows(rng, (m, c), min(c, 12))
        w = rng.integers(-2 ** 20, 2 ** 20, (c, k))
    w = torch.from_numpy(np.asarray(w, np.float32))
    got = _three_plane_matmul(s, w)
    assert torch.equal(got, torch.matmul(s, w))
    want = jsm.spike_matmul(jnp.asarray(s.numpy()), jnp.asarray(w.numpy()),
                            interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if kind == "21-bit":
        assert bool(split_bf16x3(w)[2].float().any())


@pytest.mark.parametrize("preset", ["spikingformer-smoke",
                                    "spikingformer-smoke-dvs"])
def test_three_plane_product_on_gaussian_weights(preset):
    """At the smoke widths (d_model x d_ff), Gaussian weights: within
    rtol 1e-5 / atol 1e-4 of fp32 ``torch.matmul`` and of the port's plain
    version, the same products summed in another order."""
    cfg = get_spikingformer_config(preset)
    d, f = cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(d + f)
    for c, k in ((d, d), (f, d), (d, f)):
        s = _spikes(rng, (cfg.num_tokens * 4, c), 0.2)
        w = torch.from_numpy(
            (rng.normal(size=(c, k)) * c ** -0.5).astype(np.float32))
        got = _three_plane_matmul(s, w)
        torch.testing.assert_close(got, torch.matmul(s, w), rtol=1e-5,
                                   atol=1e-4)
        torch.testing.assert_close(
            got, spike_matmul.spike_matmul(s, w), rtol=1e-5, atol=1e-4)
