"""The spike pack (``spike_matmul.spike_pack``, ``csrc/spike_pack.cu``) on
the CPU: its plain version and the oracle of ``kernels/ref.py`` against the
reference's ``repro.kernels.spike_matmul.spike_pack``, bit for bit, in fp32
and bf16 at shapes shaped like the model's sites; the wrapper's view of a
layout (merged dims, strides, the path code the kernel is handed); its
``meta`` branch; and what it refuses. The kernel itself runs on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import spike_matmul as jsm
from repro_torch import kernels
from repro_torch.kernels import build, ref, spike_matmul as sm

META = torch.device("meta")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _spikes(shape, seed=0, rate=0.3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < rate).astype(np.float32)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """``attn_qk``'s operand: ``_fold_tb(_split_heads(x, h))`` of a
    (T, B, N, D) tensor, the (T*B, h, N, D/h) view
    (``core/spiking_layers.py``)."""
    t, b, n, d = x.shape
    return x.reshape(t, b, n, h, d // h).permute(0, 1, 3, 2, 4).reshape(
        t * b, h, n, d // h)


def _site_views(dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Small inputs shaped like the model's packed calls, each a view as
    the model hands it."""
    def t(shape, seed):
        return torch.from_numpy(_spikes(shape, seed)).to(dtype)

    return {
        "rows (M, C)": t((37, 64), 1),
        "(T, M, C)": t((3, 17, 64), 2),
        "_fold_tb of _split_heads": _heads(t((2, 3, 7, 64), 3), 4),
        "odd packed width (C = 520)": t((11, 520), 4),
        "time slice of patches": t((4, 9, 72), 5)[1:3],
        "C stride 2": t((6, 5, 32), 6)[..., ::2],
        "unaligned start": t((13 * 72 + 1,), 7)[1:].reshape(13, 72),
    }


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(_site_views(torch.float32)))
def test_plain_and_oracle_equal_the_reference_bitwise(dtype, case):
    tdt, jdt = DTYPES[dtype]
    x = _site_views(tdt)[case]
    want = np.asarray(jsm.spike_pack(jnp.asarray(
        x.float().contiguous().numpy()).astype(jdt)))
    for got in (sm.spike_pack_plain(x), ref.spike_pack_ref(x),
                sm.spike_pack(x)):
        assert got.dtype == torch.uint8
        assert got.shape == (*x.shape[:-1], x.shape[-1] // 8)
        np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int(want.astype(np.int64).sum()) < 255 * want.size


@pytest.mark.parametrize("bit", range(8))
def test_oracle_bit_order_is_lsb_first(bit):
    s = torch.zeros(2, 16)
    s[0, bit] = 1.0
    s[1, 8 + bit] = 1.0
    assert ref.spike_pack_ref(s).tolist() == [[1 << bit, 0], [0, 1 << bit]]
    assert ref.spike_pack_ref(s.bfloat16()).tolist() == \
        sm.spike_pack_plain(s.bfloat16()).tolist()


def test_layout_merges_what_its_strides_allow():
    x = torch.zeros(4, 5, 6, 64)
    assert sm.pack_layout(x) == ((1, 1, 120), (0, 0, 64), 64, 1)
    assert sm.pack_layout(x[1:3]) == ((1, 1, 60), (0, 0, 64), 64, 1)
    assert sm.pack_layout(torch.zeros(1, 9, 1, 16)) == \
        ((1, 1, 9), (0, 0, 16), 16, 1)
    # the heads view keeps three leading dims: (T*B, h, N) at (N*D, dh, D)
    h = _heads(torch.zeros(2, 3, 7, 64), 4)
    assert sm.pack_layout(h) == ((6, 4, 7), (448, 16, 64), 16, 1)
    # the (T, B, h, N, dh) view before _fold_tb merges T and B
    v = torch.zeros(2, 3, 7, 4, 16).permute(0, 1, 3, 2, 4)
    assert sm.pack_layout(v) == ((6, 4, 7), (448, 16, 64), 16, 1)
    assert sm.pack_layout(torch.zeros(8, 64).t()) == \
        ((1, 1, 64), (0, 0, 1), 8, 64)


def test_layout_refuses_more_than_four_dims():
    # every leading dim strided: none merges with the next
    x = torch.zeros(4, 4, 6, 8, 16)[::2, ::2, ::2, ::2]
    with pytest.raises(ValueError, match="up to 4 dims"):
        sm.pack_layout(x)
    assert sm.pack_layout(x[:1]) == ((2, 3, 4), (1536, 256, 32), 16, 1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_path_code_of_each_layout(dtype):
    tdt = DTYPES[dtype][0]
    views = _site_views(tdt)
    want = {"rows (M, C)": sm.PACK_VECTOR, "(T, M, C)": sm.PACK_VECTOR,
            "_fold_tb of _split_heads": sm.PACK_VECTOR,
            "odd packed width (C = 520)": sm.PACK_VECTOR,
            "time slice of patches": sm.PACK_VECTOR,
            "C stride 2": sm.PACK_SCALAR, "unaligned start": sm.PACK_SCALAR}
    assert {k: sm.pack_path(v) for k, v in views.items()} == want
    base = torch.zeros(19, 80, dtype=tdt)
    # a row start off 16 bytes: 76 elements of bf16 are 152 bytes
    assert sm.pack_path(torch.zeros(19, 76, dtype=tdt)[:, :72]) == \
        (sm.PACK_SCALAR if tdt == torch.bfloat16 else sm.PACK_VECTOR)
    assert sm.pack_path(base[:, :72]) == sm.PACK_VECTOR
    assert sm.pack_path(base.t()[:72]) == sm.PACK_SCALAR
    # one row: its stride is never read
    assert sm.pack_path(base[3:4, :64]) == sm.PACK_VECTOR


def test_path_codes_mirror_the_cuda_source():
    src = (build.CSRC / "spike_pack.cu").read_text()
    codes = {name: int(v) for name, v in re.findall(
        r"constexpr int (kPath\w+) = (\d+);", src)}
    assert codes == {"kPathVector": sm.PACK_VECTOR,
                     "kPathScalar": sm.PACK_SCALAR}
    assert "spike_pack.cu" in [s.name for s in build.sources()]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_meta_branch_allocates_and_reports_the_site(dtype, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the plain pack ran on meta tensors")

    monkeypatch.setattr(sm, "spike_pack_plain", refuse)
    seen = []
    monkeypatch.setattr(kernels, "META_OBSERVERS",
                        [lambda *site: seen.append(site)])
    before = kernels.launch_counts()
    x = _heads(torch.empty(2, 3, 7, 64, dtype=DTYPES[dtype][0],
                           device=META), 4)
    out = sm.spike_pack(x)
    assert (out.device, out.dtype, tuple(out.shape)) == \
        (META, torch.uint8, (6, 4, 7, 2))
    assert out.is_contiguous()
    [(name, operands, results, flops)] = seen
    assert (name, flops, results) == ("spike_pack", 0.0, out)
    assert len(operands) == 1 and operands[0] is x
    assert kernels.launch_counts() == before


def test_refusals():
    with pytest.raises(ValueError, match="multiple of 8"):
        sm.spike_pack(torch.zeros(4, 12))
    with pytest.raises(ValueError, match="multiple of 8"):
        sm.spike_pack(torch.empty(4, 12, device=META))
    for dt in (torch.float16, torch.float64, torch.uint8):
        with pytest.raises(TypeError, match="spike_pack kernel takes"):
            kernels.dtype_code(dt, "spike_pack")
        with pytest.raises(TypeError, match="spike_pack kernel takes"):
            sm.spike_pack(torch.empty(4, 16, dtype=dt, device=META))


def test_counts_reset_restore_and_ignore_the_plain_version():
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == dict.fromkeys(kernels.COUNTED, 0)
    assert kernels.COUNTED == (*kernels.KERNELS, "spike_pack")
    sm.spike_pack(torch.zeros(4, 16))           # plain: no launch
    assert sm.spike_pack.launches == 0
    sm.spike_pack.launches = 5
    snap = kernels.launch_counts()
    kernels.reset_launch_counts()
    assert sm.spike_pack.launches == 0
    kernels.set_launch_counts(snap)
    assert sm.spike_pack.launches == 5
    kernels.reset_launch_counts()


def test_plan_launches_restores_the_pack_count(monkeypatch):
    monkeypatch.setattr(build, "load", lambda *a, **kw: None)
    kernels.reset_launch_counts()
    with build.plan_launches():
        sm.spike_pack.launches += 2
    assert sm.spike_pack.launches == 0


def test_every_packed_caller_packs_through_the_wrapper(monkeypatch):
    """The packed arms reach the pack through ``spike_matmul.spike_pack``
    (whose CUDA branch is the kernel): on ``meta`` each reports one
    ``spike_pack`` site a pack."""
    from repro_torch.kernels import conv_spike, neuron_layer
    sites = []
    monkeypatch.setattr(kernels, "META_OBSERVERS",
                        [lambda name, *_: sites.append(name)])
    t, m, c, k = 2, 9, 16, 8
    x = torch.empty(t, m, c, device=META)
    w = torch.empty(c, k, device=META)
    v = torch.empty(k, device=META)
    neuron_layer.neuron_layer_eval(x, w, v, packed=True)
    neuron_layer.neuron_layer_train_fwd(x, w, v, v, packed=True)
    neuron_layer.neuron_layer_train_z(x, w, packed=True)
    sm.spike_matmul(x[0], w)
    sm.spike_matmul_batched(x, w.expand(t, c, k))
    conv_spike.spike_patch_matmul(x, w)
    assert sites.count("spike_pack") == 6
    neuron_layer.neuron_layer_eval(x, w, v, packed=False)
    assert sites.count("spike_pack") == 6
