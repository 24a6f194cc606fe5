"""The bf16 arms of the train-mode kernels on their Hopper designs, on the
CPU: the rule that sends the neuron layer's first pass (z) to the wgmma
mainloop (``neuron_layer.z_kernel``, the spike matmul's rule), the scratch
of the fused and the split forward sized by the kernel it names, the
backward BN's chunks at bf16, and its
plain version against the reference's Pallas kernel at bf16 where D is no
multiple of 8 (the widths whose dx pass keeps four or one column a lane).

The kernels run only on the card: ``tests/test_torch_cuda.py`` holds them
against their plain versions there, and ``chip_smoke.py`` at the model's
shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_port import single_thread
from repro.kernels import fused_bn as jbn
from repro_torch.kernels import fused_bn
from repro_torch.kernels import neuron_layer as nl
from repro_torch.kernels import spike_matmul as sm
from repro_torch.launch import dryrun

single_thread()
BF16 = torch.bfloat16


def _w(c, k, dtype=BF16, device="cpu"):
    return torch.zeros((c, k), dtype=dtype, device=device)


# --- the rule ---------------------------------------------------------------

@pytest.mark.parametrize("rows,c,k,dtype,want", [
    (12544, 512, 512, BF16, nl.Z_WGMMA),          # pssa.qkv
    (12544, 512, 2048, BF16, nl.Z_WGMMA),         # smlp.a
    (200704, 576, 128, BF16, nl.Z_WGMMA),         # tokenizer.conv.1
    (513, 64, 64, BF16, nl.Z_WGMMA),
    (512, 512, 512, BF16, nl.Z_MMA),              # 512 rows or fewer
    (196, 64, 64, BF16, nl.Z_MMA),
    (12544, 512, 512, torch.float32, nl.Z_MMA),   # fp32 keeps mma.sync
    (12544, 512, 100, BF16, nl.Z_MMA),            # K % 8 != 0: no TMA box
    (1200, 256, 200, BF16, nl.Z_WGMMA),           # K % 128 != 0
    (12544, 520, 512, torch.float32, nl.Z_MMA),
])
def test_the_z_pass_takes_the_spike_matmuls_rule(rows, c, k, dtype, want):
    """bf16, more than 512 rows and a weight TMA can read: the wgmma z
    pass, exactly where ``spike_matmul.resolve_tile`` sends the same
    product to its wgmma kernel; every other packed call ``mma.sync``; a
    dense call the dense arm."""
    w = _w(c, k, dtype)
    assert nl.z_kernel(rows, w, True) == want
    assert (sm.resolve_tile(rows, w[None, None]) == sm.WGMMA) == \
        (want == nl.Z_WGMMA)
    assert nl.z_kernel(rows, w, False) == nl.Z_DENSE


def test_rows_tma_cannot_read_keep_the_wgmma_kernel():
    """C = 520: 65 bytes of packed row, which TMA cannot read. The rule
    looks at the weight alone, as the spike matmul's does, so the call
    takes the wgmma kernel, whose producer copies such rows byte by byte
    (the spike matmul's ragged case, 12,581 x 520 x 520)."""
    assert nl.z_kernel(12581, _w(520, 520), True) == nl.Z_WGMMA
    assert sm.resolve_tile(12581, _w(520, 520)[None, None]) == sm.WGMMA


def test_a_weight_off_16_byte_alignment_keeps_mma_sync():
    w = torch.zeros(512 * 512 + 1, dtype=BF16)[1:].view(512, 512)
    assert w.data_ptr() % 16 != 0
    assert nl.z_kernel(12544, w, True) == nl.Z_MMA


@pytest.mark.parametrize("kernel,tile", [(nl.Z_WGMMA, 192), (nl.Z_MMA, 256),
                                         (nl.Z_DENSE, 1024)])
@pytest.mark.parametrize("rows", [1, 191, 192, 193, 12544, 802816])
def test_the_partials_tiles_are_the_kernels(kernel, tile, rows):
    assert nl.part_tiles(rows, kernel) == -(-rows // tile)


@pytest.mark.parametrize("kernel,tile", [
    (nl.Z_WGMMA, nl.WGMMA_TILE_ROWS), (nl.Z_MMA, nl.TILE_ROWS),
    (nl.Z_DENSE, nl.DENSE_TILE_ROWS)])
def test_the_scratch_is_sized_by_the_kernel(kernel, tile):
    """``train_scratch`` (the forward's, the split path's and the meta
    branch's scratch): z (T, M, K) and one partial per column and row tile
    of the kernel named, (2, tiles, K), both fp32."""
    x = torch.empty((4, 3136, 512), dtype=BF16, device="meta")
    z, part = nl.train_scratch(x, _w(512, 200, BF16, "meta"), kernel)
    assert z.shape == (4, 3136, 200) and z.dtype == torch.float32
    assert part.shape == (2, -(-12544 // tile), 200)
    assert part.dtype == torch.float32


def _meta_layer(dtype=BF16, t=4, m=3136, c=512, k=512):
    x = torch.empty((t, m, c), dtype=dtype, device="meta")
    v = torch.empty(k, dtype=dtype, device="meta")
    return x, _w(c, k, dtype, "meta"), v, v


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("dtype,want,tile", [
    (BF16, nl.Z_WGMMA, nl.WGMMA_TILE_ROWS),
    (torch.float32, nl.Z_MMA, nl.TILE_ROWS)])
def test_train_on_meta_takes_the_kernels_scratch(monkeypatch, split, dtype,
                                                  want, tile):
    """The fused forward and the split path's (with a group) on ``meta``
    size their scratch by the kernel the rule names for the operands, as
    the card's wrappers do before they pass that kernel to the entry
    point."""
    seen = []
    real = nl.train_scratch

    def spy(x, w, kernel):
        out = real(x, w, kernel)
        seen.append((kernel, tuple(out[1].shape)))
        return out
    monkeypatch.setattr(nl, "train_scratch", spy)
    x, w, gamma, beta = _meta_layer(dtype)
    if split:
        with dryrun.fake_world(2):
            nl.neuron_layer_train_fwd(x, w, gamma, beta, packed=True,
                                      group=dist.group.WORLD)
    else:
        nl.neuron_layer_train(x, w, gamma, beta, packed=True)
    assert seen == [(want, (2, -(-12544 // tile), 512))]


# --- bn_bwd at bf16 -----------------------------------------------------------

@pytest.mark.parametrize("m,dtype,want", [
    (12544, BF16, (256, 49)), (802816, BF16, (3136, 256)),
    (100, BF16, (256, 1)), (12544, torch.float32, (512, 25)),
    (802816, torch.float32, (3136, 256))])
def test_the_backward_chunks(m, dtype, want):
    """At bf16 a block of the first pass covers twice the columns, so its
    chunks are shorter (at least 256 rows against 512); at most 256
    chunks either way."""
    assert fused_bn.bwd_chunking(m, dtype) == want


def test_the_meta_backward_sizes_its_buffer_by_the_chunks():
    g = torch.empty((12544, 512), dtype=BF16, device="meta")
    v = torch.empty((1, 512), device="meta")
    _, dgamma, _ = fused_bn.bn_bwd(g, g, v[0], v, v)
    chunks = fused_bn.bwd_chunking(12544, BF16)[1]
    assert dgamma.shape == (1, 512)
    assert dgamma.untyped_storage().nbytes() == (4 * chunks + 6) * 512 * 4


def _t16(a):
    return torch.from_numpy(np.asarray(a).astype(jnp.bfloat16).view(
        np.int16).copy()).view(BF16)


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == BF16 else \
            a.numpy().view(np.int32)
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a.view(np.int32)


@pytest.mark.parametrize("m,d", [(300, 130), (129, 7), (200, 24), (64, 12)])
def test_bn_bwd_plain_against_the_reference_at_bf16(m, d):
    """D % 8 != 0 (130 and 24 also D % 4 != 0 or D < 32): the plain
    version of ``bn_bwd`` at bf16 against the reference's Pallas kernel in
    interpret mode. Dyadic inputs (every column sum exact): dx, dgamma
    and dbeta bit for bit. Gaussian inputs: dx within one bf16 rounding
    (the column sums in another order), dgamma and dbeta within 1e-5 of
    their scale."""
    rng = np.random.default_rng(m * d)
    mu = rng.integers(-8, 8, (1, d)) / 8
    g = rng.integers(-1, 2, (m, d)).astype(np.float32)
    x = (mu + rng.integers(-1, 2, (m, d))).astype(np.float32)
    gamma = rng.choice([0.5, 1.0], d).astype(np.float32)
    sd = rng.choice([1.0, 2.0], (1, d)).astype(np.float32)
    mu = mu.astype(np.float32)
    want = jbn.bn_bwd(jnp.asarray(g, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16),
                      jnp.asarray(gamma), jnp.asarray(mu), jnp.asarray(sd),
                      block_d=32)
    got = fused_bn.bn_bwd_plain(_t16(g), _t16(x), torch.from_numpy(gamma),
                                torch.from_numpy(mu), torch.from_numpy(sd))
    assert got[0].dtype == BF16
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    g = rng.normal(size=(m, d)).astype(np.float32)
    x = rng.normal(0.5, 2.0, (m, d)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, d).astype(np.float32)
    x16 = jnp.asarray(x, jnp.bfloat16)
    xf = np.asarray(x16).astype(np.float32)
    mu = xf.mean(0, keepdims=True)
    sd = np.sqrt(xf.var(0, keepdims=True) + 1e-5).astype(np.float32)
    want = jbn.bn_bwd(jnp.asarray(g, jnp.bfloat16), x16, jnp.asarray(gamma),
                      jnp.asarray(mu), jnp.asarray(sd), block_d=32)
    got = fused_bn.bn_bwd_plain(_t16(g), _t16(x), torch.from_numpy(gamma),
                                torch.from_numpy(mu), torch.from_numpy(sd))
    dx, wdx = got[0].float().numpy(), np.asarray(want[0]).astype(np.float32)
    assert np.all(np.abs(dx - wdx) <= 1e-5 + 2.0 ** -7 * np.abs(wdx))
    for a, b in zip(got[1:], want[1:]):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()
