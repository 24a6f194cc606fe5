"""The port's kernel modules against the JAX package's kernels.

Inputs come from numpy seeds and go through both. The JAX side runs its
Pallas kernels in interpret mode (what ``interpret=None`` resolves to on a
CPU) and its ``repro.kernels.ref`` oracles; the port's wrappers take their
plain PyTorch versions here because the tensors lie on the CPU. The CUDA
kernels themselves run only on a card: ``python3 chip_smoke.py`` holds them
against the same plain versions there, and the ``cuda``-marked tests of
``test_torch_cuda.py`` do so at small shapes (the training kernels' CPU
parity is in ``test_torch_grads.py``).

Tolerances: elementwise recursions and products of {0,1} with integers or
dyadic weights are exact in fp32 in any order of summation, so those compare
bitwise; Gaussian-weight matmuls compare at 1e-5 (same products, another
order of summation).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import single_thread

from repro.kernels import conv_spike as jcs
from repro.kernels import lif_soma as jlif
from repro.kernels import neuron_layer as jnl
from repro.kernels import ref as jref
from repro.kernels import spike_matmul as jsm
from repro_torch.kernels import (KERNELS, conv_spike, launch_counts, lif_soma,
                                 neuron_layer, ops, reset_launch_counts,
                                 spike_matmul)

single_thread()


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _spikes(rng, shape, rate=0.3):
    return (rng.random(shape) < rate).astype(np.float32)


# ---------------------------------------------------------------------------
# lif_soma_fwd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16, 64), (4, 9, 13), (1, 5, 8),
                                   (3, 70, 33)])
@pytest.mark.parametrize("lif", [
    dict(alpha=0.5, th_fire=1.0, th_lo=0.0, th_hi=2.0),
    dict(alpha=0.3, th_fire=0.7, th_lo=-0.2, th_hi=1.1)])
def test_lif_soma_fwd_bitwise(shape, lif):
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(0.3, 1.2, shape)).astype(np.float32)
    got = lif_soma.lif_soma_fwd(_t(x), **lif)
    kernel = jlif.lif_soma_fwd(jnp.asarray(x), interpret=True, **lif)
    oracle = jref.lif_soma_fwd_ref(jnp.asarray(x), **lif)
    for g, k, o in zip(got, kernel, oracle):     # S, U, mask
        _eq(g, k)
        _eq(g, o)
    assert 0.05 < float(got[0].mean()) < 0.95    # the case does fire


def test_lif_soma_fwd_rejects_bad_rank():
    with pytest.raises(ValueError, match=r"\(T, M, D\)"):
        lif_soma.lif_soma_fwd(torch.zeros(4, 8))


# ---------------------------------------------------------------------------
# spike_pack / spike_unpack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 8), (3, 7, 64), (2, 3, 4, 24)])
def test_spike_pack_unpack_bitwise(shape):
    rng = np.random.default_rng(1)
    s = _spikes(rng, shape, 0.5)
    packed = spike_matmul.spike_pack(_t(s))
    assert packed.dtype == torch.uint8
    _eq(packed, jsm.spike_pack(jnp.asarray(s)))
    _eq(spike_matmul.spike_unpack(packed), s)
    _eq(spike_matmul.spike_unpack(packed),
        jsm.spike_unpack(jnp.asarray(packed.numpy())))


@pytest.mark.parametrize("bit", range(8))
def test_spike_pack_bit_order_is_lsb_first(bit):
    """A one-hot row per bit position: a wrong order still 'works' on random
    data's shapes, not on these values."""
    s = np.zeros((2, 16), np.float32)
    s[0, bit] = 1.0
    s[1, 8 + bit] = 1.0
    packed = spike_matmul.spike_pack(_t(s))
    assert packed.tolist() == [[1 << bit, 0], [0, 1 << bit]]
    _eq(packed, jsm.spike_pack(jnp.asarray(s)))
    w = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    out = spike_matmul.spike_matmul_packed(packed, _t(w))
    _eq(out, np.stack([w[bit], w[8 + bit]]))


def test_spike_pack_rejects_ragged_contraction():
    with pytest.raises(ValueError, match="multiple of 8"):
        spike_matmul.spike_pack(torch.zeros(4, 12))


# ---------------------------------------------------------------------------
# spike_matmul_packed (2-D)
# ---------------------------------------------------------------------------

MM_SHAPES = [(52, 64, 52), (16, 8, 5), (130, 72, 33), (64, 128, 64)]


@pytest.mark.parametrize("m,c,k", MM_SHAPES)
def test_spike_matmul_integer_weights_bitwise(m, c, k):
    rng = np.random.default_rng(m + c + k)
    s = _spikes(rng, (m, c))
    w = rng.integers(-8, 9, (c, k)).astype(np.float32)
    got = spike_matmul.spike_matmul(_t(s), _t(w))
    _eq(got, jsm.spike_matmul(jnp.asarray(s), jnp.asarray(w), interpret=True))
    _eq(got, jref.spike_matmul_ref(jnp.asarray(s), jnp.asarray(w)))
    _eq(ops.spike_matmul_train_op(_t(s), _t(w)), got)


@pytest.mark.parametrize("m,c,k", MM_SHAPES)
def test_spike_matmul_gaussian_weights(m, c, k):
    rng = np.random.default_rng(m * c + k)
    s = _spikes(rng, (m, c))
    w = (rng.normal(size=(c, k)) * c ** -0.5).astype(np.float32)
    packed = spike_matmul.spike_pack(_t(s))
    got = spike_matmul.spike_matmul_packed(packed, _t(w))
    want = jsm.spike_matmul_packed(jnp.asarray(packed.numpy()),
                                   jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert got.dtype == torch.float32


def test_spike_matmul_strided_weight_and_out_dtype():
    rng = np.random.default_rng(7)
    s = _spikes(rng, (52, 64))
    wt = rng.integers(-4, 5, (52, 64)).astype(np.float32)     # K^T stored
    w = _t(wt).t()                                            # (64, 52) view
    assert not w.is_contiguous()
    got = spike_matmul.spike_matmul(_t(s), w, out_dtype=torch.float64)
    assert got.dtype == torch.float64
    _eq(got.float(), s @ wt.T)


def test_spike_matmul_shape_and_dtype_checks():
    packed = torch.zeros((4, 2), dtype=torch.uint8)
    with pytest.raises(ValueError, match="packed C 16 != weight C 24"):
        spike_matmul.spike_matmul_packed(packed, torch.zeros(24, 3))
    with pytest.raises(TypeError, match="uint8"):
        spike_matmul.spike_matmul_packed(packed.float(), torch.zeros(16, 3))
    with pytest.raises(ValueError, match="2-D"):
        spike_matmul.spike_matmul_packed(packed[None], torch.zeros(1, 16, 3))
    with pytest.raises(ValueError, match="batch dims"):
        spike_matmul.spike_matmul_packed_batched(
            packed[None], torch.zeros(2, 16, 3))


# ---------------------------------------------------------------------------
# spike_matmul_packed_batched
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,m,c,k", [(6, 52, 64, 52), (3, 20, 16, 7),
                                     (2, 70, 72, 65)])
def test_spike_bmm_bitwise_and_gaussian(g, m, c, k):
    rng = np.random.default_rng(g * m + c)
    s = _spikes(rng, (g, m, c))
    wi = rng.integers(-8, 9, (g, c, k)).astype(np.float32)
    got = spike_matmul.spike_matmul_batched(_t(s), _t(wi))
    _eq(got, jsm.spike_matmul_batched(jnp.asarray(s), jnp.asarray(wi),
                                      interpret=True))
    _eq(got, jref.spike_matmul_batched_ref(jnp.asarray(s), jnp.asarray(wi)))
    wg = (rng.normal(size=(g, c, k)) * c ** -0.5).astype(np.float32)
    got = ops.spike_bmm_train_op(_t(s), _t(wg))
    want = jsm.spike_matmul_batched(jnp.asarray(s), jnp.asarray(wg),
                                    interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_spike_bmm_attention_views_two_batch_levels():
    """attn_qk as the model calls it: per-head views of (T*B, N, h*dh)
    tensors (N = 52 is ragged against every power-of-two tile, C = dh = 64)
    and K^T as a transposed view — no operand is contiguous."""
    rng = np.random.default_rng(11)
    tb, n, h, dh = 3, 52, 2, 64
    q, k = (_t(_spikes(rng, (tb, n, h * dh))) for _ in range(2))
    qh, kh = (a.view(tb, n, h, dh).permute(0, 2, 1, 3) for a in (q, k))
    kt = kh.transpose(-1, -2)
    assert not qh.is_contiguous() and not kt.is_contiguous()
    got = spike_matmul.spike_matmul_batched(qh, kt)
    assert got.shape == (tb, h, n, n)
    want = jsm.spike_matmul_batched(
        jnp.asarray(qh.reshape(tb * h, n, dh).numpy()),
        jnp.asarray(kt.reshape(tb * h, dh, n).numpy()), interpret=True)
    _eq(got.reshape(tb * h, n, n), want)


def test_spike_patch_matmul_shares_the_weight_without_a_copy(monkeypatch):
    rng = np.random.default_rng(5)
    t, m, c, k = 3, 37, 72, 20
    p = _spikes(rng, (t, m, c))
    w = rng.integers(-8, 9, (c, k)).astype(np.float32)
    seen = {}
    real = conv_spike.spike_matmul_packed_batched

    def spy(packed, wb, **kw):
        seen["stride"], seen["shape"] = wb.stride(), tuple(wb.shape)
        return real(packed, wb, **kw)

    monkeypatch.setattr(conv_spike, "spike_matmul_packed_batched", spy)
    got = ops.spike_patch_mm_train_op(_t(p), _t(w))
    assert seen["shape"] == (t, c, k) and seen["stride"][0] == 0
    _eq(got, jcs.spike_patch_matmul(jnp.asarray(p), jnp.asarray(w),
                                    interpret=True))
    _eq(got, jref.spike_patch_matmul_ref(jnp.asarray(p), jnp.asarray(w)))


# ---------------------------------------------------------------------------
# neuron_layer_eval
# ---------------------------------------------------------------------------

def _dyadic(rng, shape, scale=64, span=16):
    return (rng.integers(-span, span, shape) / scale).astype(np.float32)


@pytest.mark.parametrize("t,m,c,k,packed", [
    (2, 40, 64, 48, True),      # Conv1DBN -> SN pair
    (2, 33, 72, 20, True),      # im2col'd tokenizer stage, ragged M and K
    (4, 50, 27, 64, False),     # first stage: float image, C = 27
    (2, 21, 20, 9, False),      # ragged contraction -> dense arm
    (1, 16, 8, 8, True),
    (1, 37, 27, 64, False),     # dense arm, one time step, ragged M
    (8, 45, 27, 64, False)])    # dense arm, eight time steps, ragged M
def test_neuron_layer_eval_dyadic_weights_bitwise(t, m, c, k, packed):
    """Weights, bias and dense inputs are multiples of 2^-6 (2^-4): every
    fp32 partial sum is exact, so no order of summation can move a spike and
    the three implementations must agree bit for bit."""
    rng = np.random.default_rng(t * m + c * k)
    x = _spikes(rng, (t, m, c)) if packed else _dyadic(rng, (t, m, c), 16, 32)
    w, bias = _dyadic(rng, (c, k)), _dyadic(rng, (k,))
    got = neuron_layer.neuron_layer_eval(_t(x), _t(w), _t(bias), packed=packed)
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    _eq(got, jnl.neuron_layer_eval(*args, packed=packed, interpret=True))
    _eq(got, jref.neuron_layer_eval_ref(*args))
    _eq(ops.neuron_layer_eval_op(_t(x), _t(w), _t(bias), 0.5, 1.0, 0.0, 2.0,
                                 1.0, packed), got)
    assert got.dtype == torch.float32 and got.shape == (t, m, k)
    if c >= 27:                                   # the larger cases do fire
        assert 0.02 < float(got.mean()) < 0.98


def test_neuron_layer_eval_gaussian_weights_mismatch_fraction():
    """Ordinary weights: a membrane within rounding of the threshold may
    fire differently under another order of summation, so spikes compare by
    mismatch fraction (<= 1e-3 here, 0 in practice at this size)."""
    rng = np.random.default_rng(3)
    t, m, c, k = 2, 64, 128, 96
    x = _spikes(rng, (t, m, c), 0.2)
    w = (rng.normal(size=(c, k)) * 2 * c ** -0.5).astype(np.float32)
    bias = rng.normal(0, 0.1, (k,)).astype(np.float32)
    got = neuron_layer.neuron_layer_eval(_t(x), _t(w), _t(bias), alpha=0.4,
                                         th_fire=0.8, packed=True)
    want = jnl.neuron_layer_eval(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(bias), alpha=0.4, th_fire=0.8,
                                 packed=True, interpret=True)
    assert float(np.mean(got.numpy() != np.asarray(want))) <= 1e-3
    assert 0.05 < float(got.mean()) < 0.95


def test_neuron_layer_eval_checks():
    x, w, b = torch.zeros(2, 4, 12), torch.zeros(12, 3), torch.zeros(3)
    with pytest.raises(ValueError, match="multiple of 8"):
        neuron_layer.neuron_layer_eval(x, w, b, packed=True)
    with pytest.raises(ValueError, match="weight contraction"):
        neuron_layer.neuron_layer_eval(x, torch.zeros(16, 3), b)
    with pytest.raises(ValueError, match="bias shape"):
        neuron_layer.neuron_layer_eval(x, w, torch.zeros(4))


# ---------------------------------------------------------------------------
# conv lowering: same_padding, im2col, conv_w_matrix, fold_bn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [4, 5, 7, 8, 14, 28, 56, 112, 224])
def test_same_padding_matches_reference(size):
    assert conv_spike.same_padding(size, 3, 2) == jcs.same_padding(size, 3, 2)
    if size % 2 == 0:      # one-sided on every even size, F.conv2d's is not
        assert conv_spike.same_padding(size, 3, 2) == (0, 1)


@pytest.mark.parametrize("h,w", [(8, 8), (7, 9), (5, 4), (6, 11)])
def test_im2col_and_weight_matrix_match_reference(h, w):
    rng = np.random.default_rng(h * w)
    x = rng.normal(size=(3, h, w, 5)).astype(np.float32)
    wt = rng.normal(size=(3, 3, 5, 6)).astype(np.float32)
    got = conv_spike.im2col(_t(x))
    _eq(got, jcs.im2col(jnp.asarray(x)))            # pure data movement
    _eq(conv_spike.conv_w_matrix(_t(wt)), jcs.conv_w_matrix(jnp.asarray(wt)))
    # and the lowering equals the SAME conv, padded explicitly
    conv = torch.nn.functional.conv2d(
        conv_spike.pad_same(_t(x)).permute(0, 3, 1, 2),
        _t(wt).permute(3, 2, 0, 1), stride=2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(
        (got @ conv_spike.conv_w_matrix(_t(wt))).numpy(), conv.numpy(),
        atol=1e-5)


def test_fold_bn_matches_reference():
    rng = np.random.default_rng(9)
    w = rng.normal(size=(18, 7)).astype(np.float32)
    gamma, beta, mean = (rng.normal(size=(7,)).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.2, 2.0, (7,)).astype(np.float32)
    got = conv_spike.fold_bn(*map(_t, (w, gamma, beta, mean, var)))
    want = jcs.fold_bn(*map(jnp.asarray, (w, gamma, beta, mean, var)))
    for g, ww in zip(got, want):
        # one division and one product per element: 1 ulp of room
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), rtol=3e-7,
                                   atol=1e-7)
        assert g.dtype == torch.float32


# ---------------------------------------------------------------------------
# launch counters, the card
# ---------------------------------------------------------------------------

def test_plain_versions_do_not_count_as_launches():
    reset_launch_counts()
    x = torch.zeros(2, 4, 8, requires_grad=True)
    ops.lif_soma_op(x).sum().backward()
    ops.spike_matmul_train_op(torch.zeros(4, 8), torch.zeros(8, 3))
    ops.bn_train_op(torch.randn(6, 3, requires_grad=True), torch.ones(3),
                    torch.zeros(3))[0].sum().backward()
    ops.neuron_layer_train_op(torch.zeros(2, 4, 8), torch.zeros(8, 3),
                              torch.ones(3), torch.zeros(3), packed=True)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def test_kernel_table_names_sources_that_exist():
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    for name, info in KERNELS.items():
        assert (root / info["source"]).is_file(), name
        for key in ("replaces", "also_replaces"):
            if key not in info:
                continue
            ref_file, line = info[key].split(":")
            text = (root / ref_file).read_text().splitlines()
            assert "pallas_call" in text[int(line) - 1], (name, info[key])
    # every pallas_call of the reference has its kernel
    calls = set()
    for f in (root / "src" / "repro" / "kernels").glob("*.py"):
        for i, line in enumerate(f.read_text().splitlines(), 1):
            if "pl.pallas_call(" in line:
                calls.add(f"src/repro/kernels/{f.name}:{i}")
    covered = {info[k] for info in KERNELS.values()
               for k in ("replaces", "also_replaces") if k in info}
    assert calls == covered
