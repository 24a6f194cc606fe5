"""The bf16 spike matmul's wgmma kernel (``csrc/spike_wgmma.cuh``) on the
CPU: the rule that routes a call to it (``spike_matmul.resolve_tile``,
``tma_suits``), the wrapper's refusal of a forced tile 3 it cannot take,
and the function a forced tile 3 computes on CPU tensors (the plain
version) against the reference's Pallas kernel at bf16.

The kernel itself runs only on the card: ``tests/test_torch_cuda.py``
holds it against its plain version and the oracle there, and
``chip_smoke.py`` at the model's shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import single_thread
from repro.kernels import spike_matmul as jsm
from repro_torch.kernels import spike_matmul as sm

single_thread()
BF16 = torch.bfloat16


def _w(*shape, dtype=BF16):
    return torch.zeros(shape, dtype=dtype)


def _route(m, w, tile=0):
    """The kernel a call of ``m`` rows a product runs for weight ``w`` of
    2, 3 or 4 dims."""
    return sm.resolve_tile(m, sm._as4(w), tile)


# --- the routing rule -------------------------------------------------------

@pytest.mark.parametrize("m,want", [(12544, 3), (513, 3), (512, 2), (196, 2),
                                    (1, 2)])
def test_a_bf16_2d_weight_takes_the_wgmma_kernel_above_512_rows(m, want):
    assert _route(m, _w(512, 512)) == want


@pytest.mark.parametrize("m", [12544, 3136, 513])
def test_a_shared_weight_takes_the_wgmma_kernel(m):
    w = _w(2304, 512).unsqueeze(0).expand(4, 2304, 512)
    assert w.stride(0) == 0
    assert _route(m, w) == sm.WGMMA


def test_a_batched_weight_at_a_16_byte_stride_takes_it():
    assert _route(3136, _w(4, 2304, 512)) == sm.WGMMA


@pytest.mark.parametrize("k,c", [(512, 512), (520, 520), (64, 2048)])
def test_a_kt_view_takes_the_wgmma_kernel(k, c):
    """A K^T view: unit stride along the contraction (c-major)."""
    w = _w(k, c).t()
    assert w.stride() == (1, c)
    assert _route(12544, w) == sm.WGMMA


@pytest.mark.parametrize("m", [12544, 196])
def test_an_fp32_weight_never_takes_it(m):
    assert _route(m, _w(512, 512, dtype=torch.float32)) == \
        sm.default_tile(m)


@pytest.mark.parametrize("tile", [1, 2])
def test_a_forced_tile_keeps_the_mainloop(tile):
    assert _route(12544, _w(512, 512), tile) == tile
    assert _route(12544, _w(512, 512).t(), tile) == tile


def _unsuitable():
    """Weights whose layout TMA cannot read, each with its reason."""
    base = _w(600, 520)
    return {
        # n with stride 2: neither dim has unit stride
        "strided n": _w(512, 1024)[:, ::2],
        # K^T whose n pitch, 516 * 2 bytes, is no multiple of 16
        "K^T pitch": _w(64, 516)[:, :512].t(),
        # a base 2 bytes past a 16-byte boundary
        "misaligned": base.view(-1)[1:512 * 512 + 1].view(512, 512),
        # a batch stride of 4 + 512 * 512 elements: 8 bytes off
        "batch stride": torch.zeros(3 * 512 * 512 + 8, dtype=BF16)
        .as_strided((3, 512, 512), (512 * 512 + 4, 512, 1)),
        # a weight of one column: n has unit stride, c's is 2 bytes
        "one column": _w(512, 1),
    }


@pytest.mark.parametrize("name", sorted(_unsuitable()))
def test_strides_tma_cannot_take_keep_the_mainloop(name):
    w = _unsuitable()[name]
    assert not sm.tma_suits(sm._as4(w)), name
    assert _route(12544, w) == 1, name


def test_tma_suits_needs_a_contraction():
    assert not sm.tma_suits(sm._as4(_w(0, 512)))
    assert sm.tma_suits(sm._as4(_w(8, 512)))


def test_a_batch_level_of_one_batch_ignores_its_stride():
    """One batch: the level never moves, so its stride may be anything."""
    w = torch.zeros(512 * 512 + 8, dtype=BF16).as_strided(
        (1, 512, 512), (7, 512, 1))
    assert sm.tma_suits(sm._as4(w))


def test_the_wgmma_tile_stays_out_of_the_tuners_candidates():
    assert sm.WGMMA not in sm.TILES
    assert sorted(sm.TILES) == [1, 2]
    assert (sm.WGMMA_TILE.bm, sm.WGMMA_TILE.bn, sm.WGMMA_TILE.bk) == \
        (192, 128, 128)


# --- the wrapper's refusals -------------------------------------------------

def _packed(m, c, seed=0):
    rng = np.random.default_rng(seed)
    return sm.spike_pack(torch.from_numpy(
        (rng.random((m, c)) < 0.2).astype(np.float32)))


def test_a_forced_tile_3_refuses_an_fp32_weight():
    with pytest.raises(ValueError, match="bfloat16"):
        sm.spike_matmul_packed(_packed(600, 512), _w(512, 64,
                                                     dtype=torch.float32),
                               tile=3)
    with pytest.raises(ValueError, match="bfloat16"):
        sm.spike_matmul_packed_batched(
            _packed(600, 512)[None].expand(2, 600, 64),
            _w(2, 512, 64, dtype=torch.float32), tile=3)


@pytest.mark.parametrize("name", sorted(_unsuitable()))
def test_a_forced_tile_3_refuses_strides_tma_cannot_take(name):
    w = _unsuitable()[name]
    packed = _packed(600, w.shape[-2])
    if w.ndim == 3:
        packed = packed[None].expand(w.shape[0], *packed.shape)
        call = sm.spike_matmul_packed_batched
    else:
        call = sm.spike_matmul_packed
    with pytest.raises(ValueError, match="TMA"):
        call(packed, w, tile=3)


@pytest.mark.parametrize("tile", [4, -1])
def test_no_other_tile_code(tile):
    with pytest.raises(ValueError, match="tile"):
        sm.spike_matmul_packed(_packed(600, 512), _w(512, 64), tile=tile)


def test_meta_allocates_the_kernels_output_under_a_forced_tile_3():
    packed = torch.empty((12544, 64), dtype=torch.uint8, device="meta")
    out = sm.spike_matmul_packed(
        packed, torch.empty((512, 512), dtype=BF16, device="meta"), tile=3)
    assert out.shape == (12544, 512) and out.dtype == BF16
    assert out.device.type == "meta"


# --- the function: a forced tile 3 on CPU tensors against the reference -----

def _exact(rng, shape):
    """k / 64 with |k| <= 4: every fp32 sum of such weights is exact, so
    both packages round the same sums to bf16."""
    return (rng.integers(-4, 5, shape) / 64).astype(np.float32)


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _t16(a):
    return torch.from_numpy(np.asarray(a).astype(jnp.bfloat16).view(
        np.int16).copy()).view(BF16)


@pytest.mark.parametrize("m,c,k", [(520, 128, 64), (600, 136, 72),
                                   (777, 520, 40)])
def test_a_forced_tile_3_computes_the_references_product(m, c, k):
    rng = np.random.default_rng(m)
    s = (rng.random((m, c)) < 0.2).astype(np.float32)
    w = _exact(rng, (c, k))
    want = jsm.spike_matmul(jnp.asarray(s), jnp.asarray(w, jnp.bfloat16),
                            block_m=64, block_k=64, block_c=64)
    packed = sm.spike_pack(torch.from_numpy(s))
    got = sm.spike_matmul_packed(packed, _t16(w), tile=3)
    assert got.dtype == BF16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    kt = _t16(w.T.copy()).t()            # the same weight as a K^T view
    np.testing.assert_array_equal(
        _bits(sm.spike_matmul_packed(packed, kt, tile=3)), _bits(want))


def test_a_forced_tile_3_on_a_shared_weight_computes_the_references():
    rng = np.random.default_rng(9)
    g, m, c, k = 3, 520, 72, 48
    s = (rng.random((g, m, c)) < 0.3).astype(np.float32)
    w = _exact(rng, (c, k))
    want = jsm.spike_matmul_batched(
        jnp.asarray(s), jnp.broadcast_to(jnp.asarray(w, jnp.bfloat16),
                                         (g, c, k)),
        block_m=32, block_k=16, block_c=8)
    got = sm.spike_matmul_packed_batched(
        sm.spike_pack(torch.from_numpy(s)),
        _t16(w).unsqueeze(0).expand(g, c, k), tile=3)
    np.testing.assert_array_equal(_bits(got), _bits(want))
