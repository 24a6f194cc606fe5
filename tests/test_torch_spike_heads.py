"""The bf16 heads kernel of the spike matmul (``csrc/spike_heads.cuh``,
plan kernel 4 of ``e2a_spike_matmul``) on the CPU: the rule that routes a
call to it (``spike_matmul.resolve_tile``, ``heads_suits``), its limits
mirrored between Python and C, the wrapper's refusals of a forced tile 4
and its ``meta`` branch, and the function a forced tile 4 computes on CPU
tensors (the plain version) against the reference's Pallas kernel at bf16
on per-head K^T views.

The kernel itself runs only on the card: ``tests/test_torch_cuda.py`` holds
it against its plain version, the oracle and the Small tile there, and
``chip_smoke.py`` at ``attn_qk``'s full shape.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import single_thread
from repro.kernels import spike_matmul as jsm
from repro_torch.configs import get_spikingformer_config
from repro_torch.kernels import build
from repro_torch.kernels import spike_matmul as sm

single_thread()
BF16 = torch.bfloat16


def _route(m, w, tile=0):
    return sm.resolve_tile(m, sm._as4(w), tile)


def _attn_qk(model: int, tb: int = 2, dtype=BF16):
    """``attn_qk``'s operands of ``spikingformer-8-512`` on one rank of a
    model axis of ``model``: the per-head views of (T*B, N, h/M * dh)
    spikes, q packed, k as the K^T view (``_fold_tb`` of ``_split_heads``,
    then ``transpose(-1, -2)``)."""
    cfg = get_spikingformer_config("spikingformer-8-512")
    n, h = cfg.num_tokens, cfg.n_heads // model
    dh = cfg.d_model // cfg.n_heads

    def heads(a):
        return a.view(tb, n, h, dh).permute(0, 2, 1, 3)
    q = torch.zeros((tb, n, h * dh))
    k = torch.zeros((tb, n, h * dh), dtype=dtype)
    return sm.spike_pack(heads(q)), heads(k).transpose(-1, -2)


# --- the rule ---------------------------------------------------------------

@pytest.mark.parametrize("model", [1, 2, 4, 8])
def test_attn_qk_at_bf16_takes_the_heads_kernel_on_every_model_axis(model):
    packed, w = _attn_qk(model)
    assert packed.shape[-2:] == (196, 8) and w.shape[-2:] == (64, 196)
    assert w.stride()[-2:] == (1, 64 * 8 // model)
    assert _route(packed.shape[-2], w) == sm.HEADS


@pytest.mark.parametrize("model", [1, 8])
def test_attn_qk_in_fp32_keeps_the_small_tile(model):
    packed, w = _attn_qk(model, dtype=torch.float32)
    assert _route(packed.shape[-2], w) == 2 == sm.default_tile(196)


def test_a_layout_tma_cannot_read_keeps_the_small_tile():
    """A K^T view whose n pitch, 68 * 2 bytes, is no multiple of 16."""
    w = torch.zeros((2, 196, 68), dtype=BF16)[..., :64].transpose(-1, -2)
    assert not sm.tma_suits(sm._as4(w))
    assert _route(196, w) == 2


@pytest.mark.parametrize("c,k", [(136, 196), (64, 264), (136, 264)])
def test_a_weight_past_the_limits_keeps_the_small_tile(c, k):
    w = torch.zeros((2, k, c), dtype=BF16).transpose(-1, -2)
    assert sm.tma_suits(sm._as4(w)) and not sm.heads_suits(sm._as4(w))
    assert _route(196, w) == 2


@pytest.mark.parametrize("c,k", [(8, 8), (128, 256), (64, 196)])
def test_the_limits_themselves_take_it(c, k):
    w = torch.zeros((2, k, c), dtype=BF16).transpose(-1, -2)
    assert _route(196, w) == sm.HEADS
    assert _route(1, w) == sm.HEADS
    assert _route(512, w) == sm.HEADS


def test_more_than_512_rows_take_the_wgmma_kernel():
    _, w = _attn_qk(1)
    assert _route(513, w) == sm.WGMMA
    assert _route(12544, torch.zeros((64, 200), dtype=BF16)) == sm.WGMMA


@pytest.mark.parametrize("tile", [1, 2])
def test_a_forced_tile_wins(tile):
    packed, w = _attn_qk(1)
    assert _route(196, w, tile) == tile


def test_the_heads_code_stays_out_of_the_tuners_candidates():
    assert sm.HEADS not in sm.TILES and sm.HEADS != sm.WGMMA
    assert sorted(sm.TILES) == [1, 2]


# --- the limits, written once in C and mirrored here -------------------------

def test_the_limits_mirror_the_kernels():
    src = (build.CSRC / "spike_heads.cuh").read_text()
    c, k = map(int, re.search(
        r"constexpr int kMaxC = (\d+), kMaxK = (\d+);", src).groups())
    assert (sm.HEADS_MAX_C, sm.HEADS_MAX_K) == (c, k)
    entry = (build.CSRC / "spike_matmul.cu").read_text()
    assert re.search(rf"heads_plan\([^;]*, {sm.HEADS},", entry)
    assert f"l[0].kernel == {sm.HEADS}" in entry
    assert f"tile > {sm.HEADS}" in entry


def test_heads_suits_is_tma_suits_within_the_limits():
    ok = torch.zeros((3, 196, 64), dtype=BF16).transpose(-1, -2)
    n_major = torch.zeros((3, 64, 200), dtype=BF16)
    assert sm.heads_suits(sm._as4(ok)) and sm.heads_suits(sm._as4(n_major))
    # n-major rows of 196 * 2 bytes: TMA cannot read them
    assert not sm.heads_suits(sm._as4(torch.zeros((3, 64, 196),
                                                  dtype=BF16)))


# --- the wrapper's refusals and its meta branch -----------------------------

def _packed(g, m, c, seed=0):
    rng = np.random.default_rng(seed)
    return sm.spike_pack(torch.from_numpy(
        (rng.random((g, m, c)) < 0.2).astype(np.float32)))


def test_a_forced_tile_4_refuses_an_fp32_weight():
    w = torch.zeros((2, 196, 64)).transpose(-1, -2)
    with pytest.raises(ValueError, match="bfloat16"):
        sm.spike_matmul_packed_batched(_packed(2, 196, 64), w, tile=sm.HEADS)


@pytest.mark.parametrize("c,k", [(136, 64), (64, 264)])
def test_a_forced_tile_4_refuses_a_weight_past_its_limits(c, k):
    w = torch.zeros((2, k, c), dtype=BF16).transpose(-1, -2)
    with pytest.raises(ValueError, match=f"tile {sm.HEADS} takes C"):
        sm.spike_matmul_packed_batched(_packed(2, 196, c), w, tile=sm.HEADS)


def test_a_forced_tile_4_refuses_strides_tma_cannot_take():
    w = torch.zeros((2, 196, 68), dtype=BF16)[..., :64].transpose(-1, -2)
    with pytest.raises(ValueError, match="TMA"):
        sm.spike_matmul_packed_batched(_packed(2, 196, 64), w, tile=sm.HEADS)


def test_meta_allocates_the_kernels_output_under_the_rule_and_forced():
    packed = torch.empty((64, 8, 196, 8), dtype=torch.uint8, device="meta")
    w = torch.empty((64, 196, 8, 64), dtype=BF16,
                    device="meta").permute(0, 2, 3, 1)
    assert sm.resolve_tile(196, w) == sm.HEADS
    for tile in (0, sm.HEADS):
        out = sm.spike_matmul_packed_batched(packed, w, tile=tile)
        assert out.shape == (64, 8, 196, 196) and out.dtype == BF16
        assert out.device.type == "meta" and out.is_contiguous()


# --- the function: a forced tile 4 on CPU tensors against the reference ------

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


@pytest.mark.parametrize("tb,h,m,c,k", [
    (2, 2, 196, 64, 196),      # attn_qk's per-head product
    (1, 3, 33, 24, 21),        # ragged M, K and C
    (2, 1, 17, 128, 200),      # C at its limit
    (1, 2, 5, 8, 256),         # K at its limit, C = 8
])
def test_a_forced_tile_4_computes_the_references_product(tb, h, m, c, k):
    """On per-head K^T views (the (T*B, M, h * C) spikes and keys split
    into heads, K^T strided), bit for bit the reference's
    ``spike_matmul_packed_batched`` in interpret mode on the flattened
    heads."""
    rng = np.random.default_rng(m * k + c)
    q = (rng.random((tb, m, h * c)) < 0.2).astype(np.float32)
    kk = _exact(rng, (tb, k, h * c))

    def heads(a, n):
        return a.reshape(tb, n, h, c).transpose(0, 2, 1, 3)
    want = jsm.spike_matmul_packed_batched(
        jsm.spike_pack(jnp.asarray(heads(q, m).reshape(tb * h, m, c))),
        jnp.swapaxes(jnp.asarray(heads(kk, k).reshape(tb * h, k, c),
                                 jnp.bfloat16), -1, -2))
    packed = sm.spike_pack(torch.from_numpy(q).view(tb, m, h, c)
                           .permute(0, 2, 1, 3))
    w = _t16(kk).view(tb, k, h, c).permute(0, 2, 1, 3).transpose(-1, -2)
    assert sm.resolve_tile(m, w) == sm.HEADS
    got = sm.spike_matmul_packed_batched(packed, w, tile=sm.HEADS)
    assert got.dtype == BF16 and got.shape == (tb, h, m, k)
    np.testing.assert_array_equal(_bits(got).reshape(tb * h, m, k),
                                  _bits(want))
    np.testing.assert_array_equal(
        _bits(sm.spike_matmul_packed_batched(packed, w)), _bits(got))
