"""The CUDA kernels against their plain versions on the card, at small
shapes, and one training step on the card.

Every test here is marked ``cuda`` and skips with a reason where there is no
CUDA device. The file imports neither JAX nor the JAX package (the card's
machine has none), so it runs there without the suite's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

``python3 chip_smoke.py`` makes the same comparisons at the model's full
shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (launch_counts, lif_soma, neuron_layer,
                                 reset_launch_counts, spike_matmul)


def _t(a):
    return torch.from_numpy(np.array(a))


def _spikes(rng, shape, rate=0.3):
    return (rng.random(shape) < rate).astype(np.float32)


def _dyadic(rng, shape, scale=64, span=16):
    return (rng.integers(-span, span, shape) / scale).astype(np.float32)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on a card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_against_plain_versions_on_the_card():
    """Needs an NVIDIA GPU and nvcc; ``python3 chip_smoke.py`` runs the same
    comparison at the model's full shapes."""
    dev = _card()
    rng = np.random.default_rng(0)
    reset_launch_counts()
    x = _t(rng.normal(0.3, 1.2, (4, 70, 33)).astype(np.float32)).to(dev)
    for g, p in zip(lif_soma.lif_soma_fwd(x), lif_soma.lif_soma_fwd_plain(x)):
        assert torch.equal(g, p)
    s = _t(_spikes(rng, (3, 52, 64))).to(dev)
    w = _t(rng.integers(-8, 9, (3, 52, 64)).astype(np.float32)).to(dev)
    got = spike_matmul.spike_matmul_batched(s, w.transpose(1, 2))
    assert torch.equal(got, torch.matmul(s, w.transpose(1, 2)))
    assert torch.equal(spike_matmul.spike_matmul(s[0], w[0].t()),
                       s[0] @ w[0].t())
    for packed, c in ((True, 72), (False, 27)):
        xin = _t(_spikes(rng, (2, 70, c)) if packed
                 else _dyadic(rng, (2, 70, c), 16, 32)).to(dev)
        wd, b = _t(_dyadic(rng, (c, 20))).to(dev), _t(_dyadic(rng, (20,))).to(dev)
        assert torch.equal(
            neuron_layer.neuron_layer_eval(xin, wd, b, packed=packed),
            neuron_layer.neuron_layer_eval_plain(xin, wd, b))
    torch.cuda.synchronize()
    assert launch_counts() == {"lif_soma_fwd": 1, "lif_soma_bwd": 0,
                               "spike_matmul_packed": 1,
                               "spike_matmul_packed_batched": 1,
                               "bn_fwd": 0, "bn_bwd": 0,
                               "neuron_layer_train": 0,
                               "neuron_layer_eval": 2, "spike_pack": 3}


def _sparse_rows(rng, shape, ones=12):
    s = np.zeros(shape, np.float32)
    np.put_along_axis(s, rng.random(shape).argsort(-1)[..., :ones], 1.0, -1)
    return s


def _spike_mm_operands(case, rng):
    """(spikes, weight view) of one layout; M and K are multiples of neither
    tile (64 and 128 rows, 64 columns), C is 8 or 8 + 128 n."""
    if case == "2d, small tile":
        return _spikes(rng, (200, 136)), lambda w: w((136, 130))
    if case == "2d, large tile":
        return _spikes(rng, (600, 264)), lambda w: w((264, 70))
    if case == "2d, C = 8":
        return _spikes(rng, (1000, 8)), lambda w: w((8, 65))
    if case == "K^T view, two batch levels":
        return (_spikes(rng, (2, 3, 50, 136)),
                lambda w: w((2, 3, 45, 136)).transpose(-1, -2))
    if case == "attn^T view":
        return _spikes(rng, (4, 24, 72)), lambda w: w((4, 37, 72)).transpose(
            -1, -2)
    if case == "zero batch stride":
        return _spikes(rng, (3, 530, 136)), lambda w: w((136, 40)).unsqueeze(
            0).expand(3, 136, 40)
    raise ValueError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "2d, small tile", "2d, large tile", "2d, C = 8",
    "K^T view, two batch levels", "attn^T view", "zero batch stride"])
def test_tensor_core_spike_matmul_against_its_plain_version(case):
    """Integer weights, and 21-bit integers on rows of 12 spikes (every sum
    exact; the 21-bit ones need all three bf16 planes), bitwise; weights
    spread over 2^-20 .. 2^4 within 1e-5 of sum |s w| (the same exact
    products, summed in another order)."""
    dev = _card()
    rng = np.random.default_rng(3)
    s, view = _spike_mm_operands(case, rng)
    kinds = {
        "integer": lambda sh: rng.integers(-8, 9, sh).astype(np.float32),
        "21-bit": lambda sh: rng.integers(-2 ** 20, 2 ** 20, sh).astype(
            np.float32),
        "spread": lambda sh: (rng.normal(size=sh) * 2.0 ** rng.integers(
            -20, 5, sh)).astype(np.float32)}
    for kind, make in kinds.items():
        x = _t(_sparse_rows(rng, s.shape) if kind == "21-bit" else s).to(dev)
        w = view(lambda sh: _t(make(sh)).to(dev))
        got = spike_matmul.spike_matmul_batched(x, w) if x.ndim > 2 else \
            spike_matmul.spike_matmul(x, w)
        want = spike_matmul.spike_matmul_packed_plain(
            spike_matmul.spike_pack(x), w)
        torch.cuda.synchronize()
        if kind == "spread":
            scale = torch.matmul(x, w.abs())
            assert bool(((got - want).abs() <= 1e-5 * scale).all()), kind
        else:
            assert torch.equal(got, want), kind


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [1, 2])
@pytest.mark.parametrize("case", [
    "2d, small tile", "2d, large tile", "K^T view, two batch levels",
    "zero batch stride"])
def test_forced_tiles_exact_on_21_bit_weights(case, tile):
    """Each tile forced (``tile`` 1 Large, 2 Small, what a tuned table
    passes) at M on both sides of 512: bitwise on 21-bit integer weights
    on rows of 12 spikes, and bit-equal to the kernel's own choice on
    Gaussian weights (both tiles walk the contraction in one order)."""
    dev = _card()
    rng = np.random.default_rng(5)
    s, view = _spike_mm_operands(case, rng)
    bmm = s.ndim > 2
    mm = spike_matmul.spike_matmul_batched if bmm else \
        spike_matmul.spike_matmul
    x = _t(_sparse_rows(rng, s.shape)).to(dev)
    w = view(lambda sh: _t(rng.integers(-2 ** 20, 2 ** 20, sh).astype(
        np.float32)).to(dev))
    want = spike_matmul.spike_matmul_packed_plain(spike_matmul.spike_pack(x),
                                                  w)
    reset_launch_counts()
    assert torch.equal(mm(x, w, tile=tile), want)
    xg = _t(s).to(dev)
    wg = view(lambda sh: _t(rng.normal(size=sh).astype(np.float32)).to(dev))
    assert torch.equal(mm(xg, wg, tile=tile), mm(xg, wg))
    name = "spike_matmul_packed_batched" if bmm else "spike_matmul_packed"
    assert launch_counts()[name] == 3
    with pytest.raises(ValueError, match="tile"):
        mm(xg, wg, tile=3)


#: The bf16 wgmma kernel's cases: (packed, weight) shapes, the weight's
#: layout, ``spikingformer-8-512``'s three sites at batch 16 and the ragged
#: and K^T ones.
WGMMA_CASES = {
    "pssa.proj": ((12544, 512), (512, 512), "n"),
    "smlp.b": ((12544, 2048), (2048, 512), "n"),
    "tokenizer.conv.3": ((4, 3136, 2304), (2304, 512), "shared"),
    "ragged M/K/C": ((12581, 520), (520, 520), "n"),
    "K^T view": ((12544, 512), (512, 512), "kt"),
    "ragged K^T, K = 100": ((600, 136), (136, 100), "kt"),
    "batched, two levels": ((2, 3, 600, 256), (2, 3, 256, 136), "n"),
}


def _wgmma_operands(case, rng, make):
    """Spikes and a bf16 weight of ``case`` (``make(shape)`` gives fp32
    values) on the card."""
    ps, ws, layout = WGMMA_CASES[case]
    s = _t(_spikes(rng, ps, 0.2)).to("cuda")
    if layout == "kt":
        w = _t(make(ws[::-1])).to("cuda", torch.bfloat16).t()
    elif layout == "shared":
        w = _t(make(ws)).to("cuda", torch.bfloat16).unsqueeze(0).expand(
            ps[0], *ws)
    else:
        w = _t(make(ws)).to("cuda", torch.bfloat16)
    return spike_matmul.spike_pack(s), w


def _mm_of(packed):
    return spike_matmul.spike_matmul_packed if packed.ndim == 2 else \
        spike_matmul.spike_matmul_packed_batched


def _plan_kernels(fn, *args, **kw):
    """The launches ``fn`` would make, read from the plan twins, but the
    spike pack's (a packed call's first entry-point call)."""
    from repro_torch.kernels import build
    with build.plan_launches() as calls:
        fn(*args, **kw)
    return [launch for call in calls if call.entry != "e2a_spike_pack"
            for launch in call.launches]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGMMA_CASES))
def test_wgmma_spike_matmul_against_its_plain_version_and_oracle(case):
    """The bf16 wgmma kernel (plan kernel 3, the wrapper's rule) on exact
    weights (k/64, |k| <= 4: every fp32 sum exact) bit for bit equal to
    its plain version and to ``kernels/ref.py``; on Gaussian weights
    within one bf16 rounding of them (the same exact products summed in
    another order); the one-plane mainloop forced (tile 1) bit-equal on
    the exact weights."""
    from repro_torch.kernels import ref
    _card()
    rng = np.random.default_rng(34)
    packed, w = _wgmma_operands(
        case, rng, lambda sh: (rng.integers(-4, 5, sh) / 64).astype(
            np.float32))
    fn = _mm_of(packed)
    assert [la.kernel for la in _plan_kernels(fn, packed, w)] == \
        [spike_matmul.WGMMA]
    got = fn(packed, w)
    dense = spike_matmul.spike_unpack(packed, torch.float32)
    # the batched oracle takes one batch level; two broadcast through @
    oracle = ref.spike_matmul_batched_ref if packed.ndim == 3 else \
        ref.spike_matmul_ref
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, spike_matmul.spike_matmul_packed_plain(packed, w))
    assert torch.equal(got, oracle(dense, w))
    assert torch.equal(fn(packed, w, tile=1), got)
    _, wg = _wgmma_operands(
        case, rng, lambda sh: (rng.normal(size=sh) / sh[-2 if len(sh) > 1
                                                        else 0] ** 0.5
                               ).astype(np.float32))
    got = fn(packed, wg).float()
    want = spike_matmul.spike_matmul_packed_plain(packed, wg).float()
    assert bool(((got - want).abs() <= 1e-4 + 2.0 ** -7 * want.abs()).all())


@pytest.mark.cuda
def test_the_wgmma_plan_twin_reports_kernel_3():
    """``e2a_spike_matmul_plan`` for a bf16 call the rule sends to the
    wgmma kernel: plan kernel 3, 512 threads, the tile's dynamic shared
    memory with the opt-in, one persistent block an SM at most, striding
    over the tiles of 192 x 128 outputs."""
    _card()
    rng = np.random.default_rng(1)
    packed, w = _wgmma_operands("smlp.b", rng, lambda sh: np.zeros(
        sh, np.float32))
    (la,) = _plan_kernels(spike_matmul.spike_matmul_packed, packed, w)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = -(-12544 // 192) * (512 // 128)
    assert la.kernel == spike_matmul.WGMMA
    assert la.block == (512, 1, 1)
    assert la.smem == spike_matmul.WGMMA_TILE.smem and la.opt_in
    assert la.grid == (min(sms, tiles), 1, 1)
    assert la.tile[0] == 1 and la.extent[0] == tiles
    assert la.strided[0] == (sms < tiles)
    # the tokenizer's shared weight: the four batches' rows as one product
    packed, w = _wgmma_operands("tokenizer.conv.3", rng,
                                lambda sh: np.zeros(sh, np.float32))
    (la,) = _plan_kernels(spike_matmul.spike_matmul_packed_batched, packed,
                          w)
    assert la.extent[0] == -(-4 * 3136 // 192) * (512 // 128)


@pytest.mark.cuda
def test_the_entry_point_refuses_tile_3_it_cannot_take():
    """``e2a_spike_matmul`` (and its plan twin) refuse tile 3 with an fp32
    weight or strides TMA cannot take (cudaErrorInvalidValue, 1): the
    wrapper raises, and no other kernel runs in its place."""
    from repro_torch.kernels import build
    _card()
    lib = build.load()
    packed = torch.zeros((600, 64), dtype=torch.uint8, device="cuda")
    out = torch.empty((600, 64), dtype=torch.bfloat16, device="cuda")
    records = (build.ctypes.c_longlong * (build.MAX_LAUNCHES
                                           * build.PLAN_FIELDS))()
    for dtype, w in ((0, torch.zeros((512, 64), device="cuda")),
                     (1, torch.zeros((512, 128), dtype=torch.bfloat16,
                                     device="cuda")[:, ::2])):
        args = (packed.data_ptr(), w.data_ptr(), out.data_ptr(), 1, 1, 600,
                512, 64, 0, 0, 64, 1, 0, 0, *w.stride(), 0, 0, 64, 1, 3,
                dtype)
        assert lib.e2a_spike_matmul_plan(*args, records,
                                         build.MAX_LAUNCHES) == -1
        assert lib.e2a_spike_matmul(*args, 0) == 1
        assert lib.e2a_spike_matmul_plan(*args[:-2], 1, dtype, records,
                                         build.MAX_LAUNCHES) == 1
    with pytest.raises(ValueError, match="bfloat16"):
        spike_matmul.spike_matmul_packed(
            packed, torch.zeros((512, 64), device="cuda"), tile=3)


#: The bf16 heads kernel's cases (plan kernel 4, ``csrc/spike_heads.cuh``):
#: one unit, ``attn_qk`` at batch 16 (G = 512, the K^T view), M = 1, 17,
#: 196 and 512 (more than one unit a batch), K = 8, 21, 196, 200 and the
#: limit 256, C = 8, 24, 64 and the limit 128, both weight layouts, two
#: batch levels and packed rows at a stride.
HEADS_CASES = ("one unit", "attn_qk, G = 512", "M = 1, K = 8, C = 8",
               "M = 17, C = 128, K = 200", "M = 512, K = 256",
               "ragged, two levels", "n-major, K = 200",
               "strided packed rows")


def _heads_operands(case, rng, make):
    """Packed spikes and a bf16 weight of ``case`` (``make(shape)`` gives
    fp32 values) on the card."""
    def bf(shape):
        return _t(make(shape)).to("cuda", torch.bfloat16)

    def kt(*shape):             # K^T views of (..., K, C) keys
        return bf(shape).transpose(-1, -2)

    def pack(shape):
        return spike_matmul.spike_pack(_t(_spikes(rng, shape, 0.2)).to(
            "cuda"))
    if case == "one unit":
        return pack((196, 64)), kt(196, 64)
    if case == "attn_qk, G = 512":
        q = _t(_spikes(rng, (64, 196, 512), 0.2)).to("cuda")
        k = bf((64, 196, 512))
        return (spike_matmul.spike_pack(q.view(64, 196, 8, 64).permute(
            0, 2, 1, 3)), k.view(64, 196, 8, 64).permute(0, 2, 1, 3)
            .transpose(-1, -2))
    if case == "M = 1, K = 8, C = 8":
        return pack((3, 1, 8)), bf((3, 8, 8))
    if case == "M = 17, C = 128, K = 200":
        return pack((5, 17, 128)), bf((5, 128, 200))
    if case == "M = 512, K = 256":
        return pack((2, 512, 64)), kt(2, 256, 64)
    if case == "ragged, two levels":
        return pack((2, 3, 33, 24)), kt(2, 3, 21, 24)
    if case == "n-major, K = 200":
        return pack((4, 196, 64)), bf((4, 64, 200))
    if case == "strided packed rows":
        return pack((2, 3, 392, 64))[:, :, ::2], kt(2, 3, 196, 64)
    raise ValueError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", HEADS_CASES)
def test_heads_spike_matmul_against_its_plain_version_and_oracle(case):
    """The bf16 heads kernel (plan kernel 4, the wrapper's rule at 512 rows
    or fewer) on exact weights (k/64, |k| <= 4: every fp32 sum exact) bit
    for bit equal to its plain version, to ``kernels/ref.py`` and to the
    Small tile forced (tile 2); on Gaussian weights within one bf16
    rounding of the plain version (the same exact products summed in
    another order)."""
    from repro_torch.kernels import ref
    _card()
    rng = np.random.default_rng(38)
    packed, w = _heads_operands(
        case, rng, lambda sh: (rng.integers(-4, 5, sh) / 64).astype(
            np.float32))
    fn = _mm_of(packed)
    assert [la.kernel for la in _plan_kernels(fn, packed, w)] == \
        [spike_matmul.HEADS]
    got = fn(packed, w)
    dense = spike_matmul.spike_unpack(packed, torch.float32)
    oracle = ref.spike_matmul_batched_ref if packed.ndim == 3 else \
        ref.spike_matmul_ref
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got, spike_matmul.spike_matmul_packed_plain(packed, w))
    assert torch.equal(got, oracle(dense, w))
    assert torch.equal(fn(packed, w, tile=2), got)
    _, wg = _heads_operands(
        case, rng, lambda sh: (rng.normal(size=sh) / sh[-2 if len(sh) > 1
                                                        else 0] ** 0.5
                               ).astype(np.float32))
    got = fn(packed, wg).float()
    want = spike_matmul.spike_matmul_packed_plain(packed, wg).float()
    assert bool(((got - want).abs() <= 1e-4 + 2.0 ** -7 * want.abs()).all())


@pytest.mark.cuda
def test_the_heads_plan_twin_reports_kernel_4():
    """``e2a_spike_matmul_plan`` for ``attn_qk`` at bf16: plan kernel 4,
    512 threads, dynamic shared memory within the card's with the opt-in,
    one persistent block an SM at most, striding over the 512 units (one a
    batch: 196 rows fit one unit); at 512 rows of 256 columns a batch
    takes more than one unit."""
    _card()
    rng = np.random.default_rng(2)
    zeros = lambda sh: np.zeros(sh, np.float32)      # noqa: E731
    packed, w = _heads_operands("attn_qk, G = 512", rng, zeros)
    (la,) = _plan_kernels(spike_matmul.spike_matmul_packed_batched, packed,
                          w)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert la.kernel == spike_matmul.HEADS
    assert la.block == (512, 1, 1)
    assert 48 * 1024 < la.smem <= 232448 and la.opt_in
    assert la.grid == (min(sms, 512), 1, 1)
    assert la.tile[0] == 1 and la.extent[0] == 512
    assert la.strided[0] == (sms < 512)
    packed, w = _heads_operands("M = 512, K = 256", rng, zeros)
    (la,) = _plan_kernels(spike_matmul.spike_matmul_packed_batched, packed,
                          w)
    assert la.kernel == spike_matmul.HEADS and la.extent[0] % 2 == 0
    assert la.extent[0] // 2 >= 2 and la.smem <= 232448


@pytest.mark.cuda
def test_the_entry_point_refuses_tile_4_it_cannot_take():
    """``e2a_spike_matmul`` (and its plan twin) refuse tile 4 with an fp32
    weight, a contraction or a width past the limits, or output rows that
    are not K contiguous elements (cudaErrorInvalidValue, 1), where tile 2
    takes the same call: the wrapper raises, and no other kernel runs in
    its place."""
    from repro_torch.kernels import build
    _card()
    lib = build.load()
    records = (build.ctypes.c_longlong * (build.MAX_LAUNCHES
                                           * build.PLAN_FIELDS))()
    bf = torch.bfloat16
    packed = torch.zeros((196, 17), dtype=torch.uint8, device="cuda")
    out = torch.empty((196, 272), dtype=bf, device="cuda")
    calls = (  # (dtype code, C, weight, output row pitch)
        (0, 64, torch.zeros((196, 64), device="cuda").t(), 196),
        (1, 136, torch.zeros((64, 136), dtype=bf, device="cuda").t(), 64),
        (1, 64, torch.zeros((264, 64), dtype=bf, device="cuda").t(), 264),
        (1, 64, torch.zeros((196, 64), dtype=bf, device="cuda").t(), 200))
    for dtype, c, w, o_m in calls:
        k = w.shape[1]
        args = (packed.data_ptr(), w.data_ptr(), out.data_ptr(), 1, 1, 196,
                c, k, 0, 0, 17, 1, 0, 0, *w.stride(), 0, 0, o_m, 1)
        assert lib.e2a_spike_matmul_plan(*args, 4, dtype, records,
                                         build.MAX_LAUNCHES) == -1
        assert lib.e2a_spike_matmul(*args, 4, dtype, 0) == 1
        assert lib.e2a_spike_matmul_plan(*args, 2, dtype, records,
                                         build.MAX_LAUNCHES) == 1
    with pytest.raises(ValueError, match="bfloat16"):
        spike_matmul.spike_matmul_packed(
            packed[:, :8], torch.zeros((196, 64), device="cuda").t(),
            tile=spike_matmul.HEADS)
    with pytest.raises(ValueError, match="takes C"):
        spike_matmul.spike_matmul_packed(
            packed, torch.zeros((64, 136), dtype=bf, device="cuda").t(),
            tile=spike_matmul.HEADS)


@pytest.mark.cuda
def test_tune_at_the_smoke_preset_on_the_card(tmp_path, monkeypatch):
    """The autotuner on the card: every tunable site of the smoke preset
    gets one entry keyed by the card's name (``NVIDIA-H100-80GB-HBM3`` on
    an H100), its winner among the timed candidates; a forward consulting
    the written table gives the untuned forward's logits bit for bit (in
    eval a table only changes tiles, and a tile changes no bits)."""
    dev = _card()
    from repro_torch.configs import get_spikingformer_config
    from repro_torch.core.spikingformer import SpikingFormer
    from repro_torch.tune import table
    from repro_torch.tune.autotune import tune_and_save
    from repro_torch.tune.workloads import site_workloads
    cfg = get_spikingformer_config("spikingformer-smoke@cuda-full")
    path = tmp_path / "tuned.json"
    rep = tune_and_save(cfg, path, smoke=True, device=dev)
    kind = torch.cuda.get_device_name(dev).replace(" ", "-")
    assert rep.device_kind == kind == table.current_device_kind(dev)
    assert sorted(table.parse_key(k)[1] for k in rep.entries) == sorted(
        w.site for w in site_workloads(cfg, 1) if w.tunable)
    assert all(k.startswith(kind + "|") for k in rep.entries)
    for res in rep.results:
        assert res.winner in res.ranked[:2] and res.winner_us > 0
    model = SpikingFormer(cfg, seed=0, device=dev)
    images = torch.rand((2, cfg.image_size, cfg.image_size,
                         cfg.in_channels), device=dev)
    untuned = model(images)
    monkeypatch.setenv(table.ENV_VAR, str(path))
    table.reload()
    try:
        assert len(table.active_table()) == len(rep.entries)
        assert torch.equal(model(images), untuned)
    finally:
        monkeypatch.delenv(table.ENV_VAR)
        table.reload()


@pytest.mark.cuda
def test_a_candidate_that_fails_on_the_card_raises(monkeypatch):
    """A candidate whose kernel refuses to launch stops the sweep with the
    kernel's error: nothing is caught and passed over."""
    dev = _card()
    from repro_torch.core.energy.workload import MMOp
    from repro_torch.tune.autotune import tune_site
    from repro_torch.tune.workloads import SiteWorkload
    wl = SiteWorkload(site="pssa.proj", op="linear_bn", impl="cuda+spike_mm",
                      packed=True, shape=(600, 64, 64), calls=1,
                      mm=MMOp("pssa.proj", "FP", 600, 64, 64, in_bits=1,
                              in_sparsity=0.8))

    def refuse(*args, **kw):
        return 1           # cudaErrorInvalidValue, as a refused launch
    # the candidate's operands are packed on the card first, for real
    pack = staticmethod(spike_matmul.build.load().e2a_spike_pack)
    monkeypatch.setattr(spike_matmul.build, "load",
                        lambda: type("Lib", (), {"e2a_spike_matmul":
                                                 staticmethod(refuse),
                                                 "e2a_spike_pack": pack}))
    with pytest.raises(RuntimeError, match="spike_matmul: kernel launch "
                       "failed"):
        tune_site(wl, device=dev)


@pytest.mark.cuda
def test_training_kernels_against_plain_versions_on_the_card():
    """lif_soma_bwd bitwise (with and without gu_last, vector and scalar
    arms); bn_fwd / bn_bwd and neuron_layer_train within the statistics'
    order of summation (rtol 1e-5)."""
    from repro_torch.kernels import fused_bn
    dev = _card()
    rng = np.random.default_rng(1)
    reset_launch_counts()
    for shape in ((4, 70, 32), (3, 7, 9)):          # n % 4 == 0 and != 0
        x = _t(rng.normal(0.3, 1.2, shape).astype(np.float32)).to(dev)
        s, u, m = lif_soma.lif_soma_fwd_plain(x)
        g = torch.randn(shape, device=dev)
        gu = torch.randn(shape[1:], device=dev)
        for carry in (None, gu):
            assert torch.equal(lif_soma.lif_soma_bwd(g, u, s, m, carry),
                               lif_soma.lif_soma_bwd_plain(g, u, s, m, carry))
    x = torch.randn(300, 24, device=dev) * 2 + 1
    gamma, beta = torch.rand(24, device=dev) + 0.5, torch.randn(24, device=dev)
    got, want = fused_bn.bn_fwd(x, gamma, beta), \
        fused_bn.bn_fwd_plain(x, gamma, beta)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    g = torch.randn_like(x)
    got = fused_bn.bn_bwd(g, x, gamma, want[1], want[2])
    for a, b in zip(got, fused_bn.bn_bwd_plain(g, x, gamma, want[1],
                                                want[2])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
    for packed, c in ((True, 72), (False, 27)):
        xin = _t(_spikes(rng, (2, 70, c)) if packed
                 else rng.normal(0.5, 1, (2, 70, c)).astype(np.float32))
        w = _t((rng.normal(size=(c, 20)) * 1.5 / c ** 0.5).astype(np.float32))
        s, mu, var = neuron_layer.neuron_layer_train(
            xin.to(dev), w.to(dev), gamma[:20], beta[:20], packed=packed)
        s_p, mu_p, var_p = neuron_layer.neuron_layer_train_plain(
            xin.to(dev), w.to(dev), gamma[:20], beta[:20])
        assert float((s != s_p).float().mean()) <= 1e-3
        torch.testing.assert_close(mu, mu_p, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(var, var_p, rtol=1e-5, atol=1e-6)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert (counts["lif_soma_bwd"], counts["bn_fwd"], counts["bn_bwd"],
            counts["neuron_layer_train"]) == (4, 1, 1, 2)


@pytest.mark.cuda
def test_one_training_step_on_the_card():
    """One ``make_train_step`` step of ``spikingformer-smoke`` under
    ``cuda-full`` on the card: finite, every training kernel launched, and
    within 1e-3 of the same step under ``eager`` on the card."""
    from repro_torch.configs import get_spikingformer_config
    from repro_torch.core.policy import named_policy
    from repro_torch.core.spikingformer import init_spikingformer
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    dev = _card()
    cfg = get_spikingformer_config("spikingformer-smoke@cuda-full")
    params, state = init_spikingformer(torch.Generator().manual_seed(0), cfg,
                                       dev)
    images = torch.rand(4, 32, 32, 3, device=dev)
    labels = torch.tensor([0, 1, 2, 3], device=dev)
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32
    # the eager tokenizer's convolution in full fp32, as in the reference
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name in ("cuda-full", "eager"):
            step = make_train_step(cfg.with_policy(named_policy(name)),
                                   OptimizerConfig())
            reset_launch_counts()
            *_, metrics = step(params, state, init_opt_state(params), images,
                               labels)
            torch.cuda.synchronize()
            out[name] = (float(metrics["loss"]), launch_counts())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    loss, counts = out["cuda-full"]
    assert np.isfinite(loss) and abs(loss - out["eager"][0]) <= 1e-3
    for k in ("lif_soma_fwd", "lif_soma_bwd", "bn_fwd", "bn_bwd",
              "neuron_layer_train", "spike_matmul_packed",
              "spike_matmul_packed_batched"):
        assert counts[k] > 0, (k, counts)
    assert set(out["eager"][1].values()) == {0}


#: More rows than 65,535 ranges of 32: the elementwise passes that put row
#: ranges on grid.y must stride over a capped grid (the first tokenizer
#: stage has 12,544 rows a time step per image, so a batch of 168 gets here).
BIG_M = 65535 * 32 + 1000


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,offset", [
    (1000, 516, 0),     # M not a multiple of the 128-row chunk; float4
    (12544, 130, 0),    # D % 4 != 0: one column per lane
    (777, 20, 0),       # D < 32, float4
    (129, 7, 0),        # D < 32, D % 4 != 0
    (300, 24, 1),       # x 4 bytes off 16-byte alignment: scalar loads
    (BIG_M, 4, 0),      # more row ranges than grid.y takes; float4
    (BIG_M, 3, 0),      # the same, scalar
])
def test_bn_fwd_against_its_plain_version_at_ragged_shapes(m, d, offset):
    """mu and sqrt_d within rtol 1e-5 of the plain version's (column sums
    in another order); y bitwise equal to the plain formula applied with the
    kernel's own statistics (the same operations, each rounded once);
    three calls give the same bits (the arrival counters are left at 0)."""
    from repro_torch.kernels import fused_bn
    dev = _card()
    rng = np.random.default_rng(5)
    flat = _t(rng.normal(0.5, 2.0, m * d + offset).astype(np.float32))
    x = flat.to(dev)[offset:].view(m, d)
    gamma = _t(rng.uniform(0.5, 1.5, d).astype(np.float32)).to(dev)
    beta = _t(rng.normal(size=d).astype(np.float32)).to(dev)
    reset_launch_counts()
    runs = [fused_bn.bn_fwd(x, gamma, beta) for _ in range(3)]
    y, mu, sd = runs[0]
    for again in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], again))
    _, wmu, wsd = fused_bn.bn_fwd_plain(x, gamma, beta)
    torch.testing.assert_close(mu, wmu, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sd, wsd, rtol=1e-5, atol=1e-6)
    assert torch.equal(y, gamma * (x - mu) / sd + beta)
    torch.cuda.synchronize()
    assert launch_counts()["bn_fwd"] == 3


# (T, M, C, K): T*M a multiple of neither 256 nor 64, K of neither 64 nor
# (for some) 4, C a multiple of 8 and not of 128
TRAIN_SHAPES = [(1, 300, 72, 20), (4, 70, 136, 100), (4, 97, 264, 130),
                (1, 1000, 8, 65)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,m,c,k", TRAIN_SHAPES)
def test_packed_neuron_layer_train_at_ragged_shapes(t, m, c, k):
    """Gaussian weights: at most 1e-3 of the spikes differ from the plain
    version's (a membrane within rounding of the threshold may fire
    otherwise under another order of summation), mu and var within rtol
    1e-5."""
    dev = _card()
    rng = np.random.default_rng(6)
    x = _t(_spikes(rng, (t, m, c))).to(dev)
    w = _t((rng.normal(size=(c, k)) * 1.5 / c ** 0.5).astype(np.float32))
    gamma = _t(rng.uniform(0.8, 1.2, k).astype(np.float32)).to(dev)
    beta = _t(rng.normal(0.3, 0.2, k).astype(np.float32)).to(dev)
    reset_launch_counts()
    s, mu, var = neuron_layer.neuron_layer_train(x, w.to(dev), gamma, beta,
                                                 packed=True)
    s_p, mu_p, var_p = neuron_layer.neuron_layer_train_plain(
        x, w.to(dev), gamma, beta)
    torch.cuda.synchronize()
    assert float((s != s_p).float().mean()) <= 1e-3
    torch.testing.assert_close(mu, mu_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(var, var_p, rtol=1e-5, atol=1e-6)
    assert launch_counts()["neuron_layer_train"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("t,m,c,k", TRAIN_SHAPES)
def test_packed_neuron_layer_train_exact_on_ternary_weights(t, m, c, k):
    """Weights in {-1, 0, 1} on rows of at most 12 spikes: every z, every
    partial sum of z and z^2 and every statistic is exact in fp32, so the
    spikes, mu and var equal the plain version's bit for bit."""
    dev = _card()
    rng = np.random.default_rng(7)
    x = _t(_sparse_rows(rng, (t, m, c), ones=min(12, c))).to(dev)
    w = _t(rng.integers(-1, 2, (c, k)).astype(np.float32)).to(dev)
    gamma = _t(rng.uniform(0.8, 1.2, k).astype(np.float32)).to(dev)
    beta = _t(rng.normal(0.3, 0.2, k).astype(np.float32)).to(dev)
    got = neuron_layer.neuron_layer_train(x, w, gamma, beta, packed=True)
    want = neuron_layer.neuron_layer_train_plain(x, w, gamma, beta)
    torch.cuda.synchronize()
    for name, a, b in zip(("spikes", "mu", "var"), got, want):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("packed,k", [(True, 4), (True, 3), (False, 4)])
def test_neuron_layer_train_past_the_grid_y_limit(packed, k):
    """T = 1 and BIG_M rows, each of about two spikes out of eight, on
    weights in {-1, 0, 1}: every z and every partial sum of z and z^2 is an
    integer below 2^24, exact in fp32 in any order, so spikes, mu and var
    equal the plain version's bit for bit, in the last rows too."""
    dev = _card()
    rng = np.random.default_rng(8)
    x = _t(_spikes(rng, (1, BIG_M, 8), rate=0.25)).to(dev)
    w = _t(rng.integers(-1, 2, (8, k)).astype(np.float32)).to(dev)
    gamma = _t(rng.uniform(0.8, 1.2, k).astype(np.float32)).to(dev)
    beta = _t(rng.normal(0.3, 0.2, k).astype(np.float32)).to(dev)
    got = neuron_layer.neuron_layer_train(x, w, gamma, beta, packed=packed)
    want = neuron_layer.neuron_layer_train_plain(x, w, gamma, beta)
    torch.cuda.synchronize()
    assert float(want[0][:, -1000:].mean()) > 0.05
    for name, a, b in zip(("spikes", "mu", "var"), got, want):
        assert torch.equal(a, b), name


# (T, M, C, K): M a multiple of neither tile's rows (128, 256), K not of 64,
# C = 8 * odd, T from 1 to 8
EVAL_SHAPES = [(1, 300, 72, 20), (3, 97, 136, 100), (8, 530, 264, 130),
               (5, 1000, 8, 65), (2, 129, 520, 70)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,m,c,k", EVAL_SHAPES)
def test_packed_neuron_layer_eval_at_ragged_shapes(t, m, c, k):
    """The tensor-core eval kernel, each tile and the tile its rule picks:
    on dyadic weights equal to the plain version bit for bit; on Gaussian
    weights equal bit for bit to spike matmul + bias + the plain SOMA (the
    same MMAs in the same order, the same fp32 epilogue), and within 1e-3
    of the plain version's spikes."""
    dev = _card()
    rng = np.random.default_rng(9)
    x = _t(_spikes(rng, (t, m, c))).to(dev)
    xp = spike_matmul.spike_pack(x)
    reset_launch_counts()
    for kind in ("dyadic", "gaussian"):
        if kind == "dyadic":    # multiples of 1/16: every partial sum exact
            w, b = _t(_dyadic(rng, (c, k), 16)), _t(_dyadic(rng, (k,), 16))
        else:
            w = _t((rng.normal(size=(c, k)) * 2 / c ** 0.5).astype(np.float32))
            b = _t(rng.normal(0.3, 0.3, k).astype(np.float32))
        w, b = w.to(dev), b.to(dev)
        got = neuron_layer.neuron_layer_eval(x, w, b, packed=True)
        for tile in (1, 2):
            assert torch.equal(got, neuron_layer._launch_neuron_layer_eval(
                xp, w, b, t, m, c, k, True, 0.5, 1.0, tile=tile)), tile
        plain = neuron_layer.neuron_layer_eval_plain(x, w, b)
        exact = lif_soma.lif_soma_fwd_plain(spike_matmul.spike_matmul_packed(
            xp.reshape(t * m, c // 8), w).reshape(t, m, k) + b)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, exact), kind
        if kind == "dyadic":
            assert torch.equal(got, plain)
        else:
            assert float((got != plain).float().mean()) <= 1e-3
        assert 0.02 < float(got.mean()) < 0.98, kind
    assert launch_counts()["neuron_layer_eval"] == 2


def _preset_sites():
    """(name, T, M, C, K, packed) of every neuron-layer site of
    ``spikingformer-8-512`` at a batch of 16."""
    from repro_torch.configs import get_spikingformer_config
    cfg = get_spikingformer_config("spikingformer-8-512")
    t, size, sites = cfg.time_steps, cfg.image_size, []
    for i, (c_in, c_out) in enumerate(cfg.tokenizer_stage_channels()):
        size //= 2
        sites.append((f"tokenizer.conv.{i}", t, 16 * size * size, 9 * c_in,
                      c_out, i > 0))
    m = 16 * cfg.num_tokens
    return sites + [("pssa.qkv", t, m, cfg.d_model, cfg.d_model, True),
                    ("smlp.a", t, m, cfg.d_model, cfg.d_ff, True)]


@pytest.mark.cuda
def test_replay_reproduces_the_emitted_spikes_at_every_preset_site():
    """C1: at every neuron-layer site of the preset, packed and dense, the
    pre-activation the train op's backward replays (the forward kernel's
    own first pass on the packed input the forward made, BN with the
    forward's statistics in its order) runs SOMA into the spikes the
    forward emitted, bit for bit, on Gaussian weights; and so does the eval
    op's (the same first pass, plus the bias) against the eval kernel's."""
    from repro_torch.kernels import ops
    dev = _card()
    rng = np.random.default_rng(10)
    for name, t, m, c, k, packed in _preset_sites():
        x = _t(_spikes(rng, (t, m, c), 0.2) if packed
               else rng.random((t, m, c), dtype=np.float32)).to(dev)
        w = _t((rng.normal(size=(c, k)) * (2.0 if packed else 1.0)
                / c ** 0.5).astype(np.float32)).to(dev)
        gamma = _t(rng.uniform(0.8, 1.2, k).astype(np.float32)).to(dev)
        beta = _t(rng.normal(0.3, 0.2, k).astype(np.float32)).to(dev)
        s, mu, _, sqrt_d, xin = neuron_layer.neuron_layer_train_fwd(
            x, w, gamma, beta, packed=packed)
        _, y = ops.replay_train_pre_activation(x, xin, w, gamma, beta, mu,
                                               sqrt_d, packed)
        replayed = lif_soma.lif_soma_fwd(y)[0]
        torch.cuda.synchronize()
        assert torch.equal(replayed, s), (name, int((replayed != s).sum()))
        del y, replayed
        s = neuron_layer.neuron_layer_eval(x, w, beta, packed=packed)
        replayed = lif_soma.lif_soma_fwd(
            ops.replay_eval_pre_activation(x, w, beta, packed))[0]
        torch.cuda.synchronize()
        assert torch.equal(replayed, s), (name, int((replayed != s).sum()))
        assert 0.01 < float(s.mean()) < 0.99, name
        del x, s, replayed
        torch.cuda.empty_cache()


def _dyadic_bn_bwd(rng, m, d):
    """(g, x, gamma, mu, sqrt_d) whose every sum is exact in fp32 in any
    order: g and n = x - mu in {-1, 0, 1}, mu a multiple of 1/8, gamma in
    {0.5, 1}, sqrt_d in {1, 2}, so mi = gamma g / sqrt_d and mi n are
    multiples of 1/4 of magnitude <= 1, and every partial sum of a column
    is a multiple of 1/4 below m, exact in fp32 for m < 2^22 rows. Every
    column sum then equals the plain version's, and so must dx, dgamma and
    dbeta, bit for bit."""
    mu = rng.integers(-8, 8, (1, d)) / 8
    x = mu + rng.integers(-1, 2, (m, d))
    return (rng.integers(-1, 2, (m, d)), x, rng.choice([0.5, 1.0], d), mu,
            rng.choice([1.0, 2.0], (1, d)))


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,offset", [
    (1000, 64, 0),      # the first tokenizer stage's width; float4
    (777, 128, 0),
    (300, 512, 0),      # the block sites' width
    (130, 2048, 0),     # smlp's hidden width
    (12544, 130, 0),    # D % 4 != 0: one column per lane
    (129, 7, 0),        # D < 32, D % 4 != 0
    (300, 24, 1),       # g and x 4 bytes off 16-byte alignment: scalar
    (BIG_M, 4, 0),      # more row ranges than grid.y takes; float4
    (BIG_M, 3, 0),      # the same, scalar
])
def test_bn_bwd_against_its_plain_version_at_ragged_shapes(m, d, offset):
    """Two launches a call, the per-column terms of eq. 23 formed once by
    the elected block: on dyadic inputs (every sum exact) dx, dgamma and
    dbeta equal the plain version's bit for bit, which fails a term rounded
    otherwise than the plain version rounds it; on Gaussian inputs dx
    within rtol / atol 1e-5, dgamma and dbeta within 1e-5 of their scale
    (column sums in another order), nan in dgamma where gamma is 0, as the
    reference has it; two calls give the same bits (the arrival counters
    are left at 0)."""
    from repro_torch.kernels import fused_bn
    dev = _card()
    rng = np.random.default_rng(11)

    def operands(arrays):
        out = []
        for a in arrays:
            a = np.asarray(a, np.float32)
            if a.shape == (m, d):          # g and x at the case's offset
                flat = _t(np.concatenate([np.zeros(offset, np.float32),
                                          a.ravel()])).to(dev)
                a = flat[offset:].view(m, d)
            else:
                a = _t(a).to(dev)
            out.append(a)
        return out

    reset_launch_counts()
    g, x, gamma, mu, sd = operands(_dyadic_bn_bwd(rng, m, d))
    got = fused_bn.bn_bwd(g, x, gamma, mu, sd)
    want = fused_bn.bn_bwd_plain(g, x, gamma, mu, sd)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, want):
        assert torch.equal(a, b), name
    gauss = [rng.normal(size=(m, d)), rng.normal(0.5, 2.0, (m, d)),
             rng.uniform(0.5, 1.5, d)]
    gauss[2][::5] = 0.0
    g, x, gamma = operands(gauss)
    _, mu, sd = fused_bn.bn_fwd_plain(x, gamma, gamma)
    runs = [fused_bn.bn_bwd(g, x, gamma, mu, sd) for _ in range(2)]
    for a, b in zip(*runs):             # bitwise, nan where gamma is 0
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    dx, dgamma, dbeta = runs[0]
    wdx, wdgamma, wdbeta = fused_bn.bn_bwd_plain(g, x, gamma, mu, sd)
    torch.cuda.synchronize()
    torch.testing.assert_close(dx, wdx, rtol=1e-5, atol=1e-5)
    assert torch.equal(torch.isnan(dgamma), torch.isnan(wdgamma))
    assert bool(torch.isnan(dgamma[0, ::5]).all())
    ok = ~torch.isnan(wdgamma)
    for a, b in ((dgamma[ok], wdgamma[ok]), (dbeta, wdbeta)):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-5
    assert launch_counts()["bn_bwd"] == 3


@pytest.mark.cuda
def test_bn_bwd_at_two_widths_on_one_stream():
    """Calls at D = 2048, 64 and 2048 again, with a bn_fwd between, on one
    stream: the arrival counters the two kernels share are back at 0 after
    each, so every call gives the bits it gives alone."""
    from repro_torch.kernels import fused_bn
    dev = _card()
    rng = np.random.default_rng(12)
    args = {}
    for d in (2048, 64):
        m = 300 if d == 2048 else 5000
        g, x = (_t(rng.normal(0.3, 1.5, (m, d)).astype(np.float32)).to(dev)
                for _ in range(2))
        gamma = _t(rng.uniform(0.5, 1.5, d).astype(np.float32)).to(dev)
        _, mu, sd = fused_bn.bn_fwd_plain(x, gamma, gamma)
        args[d] = (g, x, gamma, mu, sd)
    first = {d: fused_bn.bn_bwd(*a) for d, a in args.items()}
    fused_bn.bn_fwd(args[64][1], args[64][2], args[64][2])
    again = {d: fused_bn.bn_bwd(*args[d]) for d in (64, 2048)}
    torch.cuda.synchronize()
    for d in args:
        assert all(torch.equal(a, b) for a, b in zip(first[d], again[d])), d


@pytest.mark.cuda
def test_bn_at_a_large_mean_against_the_plain_versions():
    """Columns of mean 500-2000 at mean / std ~ 1e3, where E[x^2] - mu^2
    cancels to about 16 ulps of E[x^2]: bn_fwd's var (sqrt_d^2) within 16
    ulps of E[x^2] of the plain version's (both keep the formula; their sums
    of m terms differ by a few ulps), mu within 1e-6; bn_bwd on the plain
    statistics: dx within rtol / atol 1e-5, dgamma and dbeta within 1e-5
    of their scale (n = x - mu is formed alike; the sums run in another
    order)."""
    from repro_torch.kernels import fused_bn
    dev = _card()
    rng = np.random.default_rng(13)
    m, d = 12544, 512
    mean = rng.uniform(500.0, 2000.0, d)
    x = _t((mean + rng.normal(size=(m, d)) * mean / 1e3).astype(np.float32))
    x = x.to(dev)
    gamma = _t(rng.uniform(0.5, 1.5, d).astype(np.float32)).to(dev)
    beta = _t(rng.normal(0, 0.3, d).astype(np.float32)).to(dev)
    _, mu, sd = fused_bn.bn_fwd(x, gamma, beta)
    _, wmu, wsd = fused_bn.bn_fwd_plain(x, gamma, beta)
    ex2 = (x.double() ** 2).mean(0).float()
    ulp = torch.nextafter(ex2, torch.full_like(ex2, float("inf"))) - ex2
    var_ulps = ((sd.double() ** 2 - wsd.double() ** 2).abs() / ulp).max()
    torch.testing.assert_close(mu, wmu, rtol=1e-6, atol=0.0)
    assert float(var_ulps) <= 16, float(var_ulps)
    g = torch.randn(m, d, device=dev)
    got = fused_bn.bn_bwd(g, x, gamma, wmu, wsd)
    want = fused_bn.bn_bwd_plain(g, x, gamma, wmu, wsd)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    for a, b in zip(got[1:], want[1:]):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-5


# (T, M, C, K) of the dense arms: the first tokenizer stage's C = 27 and
# K = 64, M a multiple of none of the 64-row sub-tiles, T * M of none of
# the 1024-row tiles (one or three of them); a ragged C and K; C over one
# 32-wide staged chunk (72, 130)
DENSE_SHAPES = [(1, 300, 27, 64), (4, 97, 27, 64), (4, 700, 27, 64),
                (8, 45, 20, 9), (3, 130, 72, 70), (2, 200, 130, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,m,c,k", DENSE_SHAPES)
@pytest.mark.parametrize("offset", [0, 1])
def test_dense_neuron_layer_arms_at_ragged_shapes(t, m, c, k, offset):
    """The dense arms (fp32, no tensor cores), x at an offset that breaks
    16-byte alignment or not: on dyadic weights and inputs the eval arm's
    spikes and the train arm's z equal the plain versions' bit for bit; on
    Gaussian weights the eval arm's spikes equal the plain SOMA on the train
    arm's first pass plus the bias bit for bit (one product, the same
    bits), and the train arm's spikes are within 1e-3, mu and var within
    rtol 1e-5 of the plain version's."""
    dev = _card()
    rng = np.random.default_rng(14)

    def at_offset(a):
        flat = _t(np.concatenate([np.zeros(offset, np.float32),
                                  a.astype(np.float32).ravel()])).to(dev)
        return flat[offset:].view(a.shape)

    reset_launch_counts()
    x = at_offset(_dyadic(rng, (t, m, c), 16, 32))
    w, b = _t(_dyadic(rng, (c, k))).to(dev), _t(_dyadic(rng, (k,))).to(dev)
    assert torch.equal(neuron_layer.neuron_layer_eval(x, w, b),
                       neuron_layer.neuron_layer_eval_plain(x, w, b))
    assert torch.equal(neuron_layer.neuron_layer_train_z(x, w),
                       neuron_layer.neuron_layer_train_z_plain(x, w))
    x = at_offset(rng.random((t, m, c)))
    w = _t((rng.normal(size=(c, k)) / c ** 0.5).astype(np.float32)).to(dev)
    b = _t(rng.normal(0.3, 0.3, k).astype(np.float32)).to(dev)
    s = neuron_layer.neuron_layer_eval(x, w, b)
    z = neuron_layer.neuron_layer_train_z(x, w)
    assert torch.equal(s, lif_soma.lif_soma_fwd_plain(z + b)[0])
    assert 0.02 < float(s.mean()) < 0.98
    gamma = _t(rng.uniform(0.8, 1.2, k).astype(np.float32)).to(dev)
    beta = _t(rng.normal(0.3, 0.2, k).astype(np.float32)).to(dev)
    got = neuron_layer.neuron_layer_train(x, w, gamma, beta)
    want = neuron_layer.neuron_layer_train_plain(x, w, gamma, beta)
    torch.cuda.synchronize()
    assert float((got[0] != want[0]).float().mean()) <= 1e-3
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    counts = launch_counts()
    assert (counts["neuron_layer_eval"], counts["neuron_layer_train"]) \
        == (2, 3)


# ---------------------------------------------------------------------------
# The spiking LM's serving path (qwen3-0.6b + LIF)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("t,m", [(1, 8), (256, 1), (256, 8)])
def test_lif_soma_fwd_at_the_lm_shapes(t, m):
    """Decode (1, slots, d) and the forward's (S, B, d), d = 1024: S, U and
    mask bit-equal to the plain version; and the forward's LIF scan on the
    (B, S, d) branch output with its axes swapped (a non-contiguous view,
    which the ``cuda`` arm hands the kernel as it is: the spikes come back
    in its layout) equal to the eager scan."""
    from repro_torch.core.lif import LIFConfig, lif_scan
    from repro_torch.core.policy import named_policy
    dev = _card()
    rng = np.random.default_rng(t + m)
    x = _t(rng.normal(0.3, 1.2, (t, m, 1024)).astype(np.float32)).to(dev)
    reset_launch_counts()
    for g, p in zip(lif_soma.lif_soma_fwd(x), lif_soma.lif_soma_fwd_plain(x)):
        assert torch.equal(g, p)
    f = _t(rng.normal(0.3, 1.2, (m, t, 1024)).astype(np.float32)).to(dev)
    swapped = f.transpose(0, 1)
    assert not swapped.is_contiguous() or m == 1 or t == 1
    cuda = lif_scan(swapped, LIFConfig(policy=named_policy("cuda-full")))
    eager = lif_scan(swapped, LIFConfig())
    assert torch.equal(cuda, eager)
    assert lif_soma.same_layout(cuda, swapped)   # strides of size-1 axes aside
    torch.cuda.synchronize()
    assert launch_counts()["lif_soma_fwd"] == 2


@pytest.mark.cuda
def test_lif_soma_step_op_equals_lif_step_bitwise():
    """The decode step's carry folded into x[0] before the SOMA kernel
    against ``lif_step``'s alpha*u0*(1-s0) + x: spikes and state equal bit
    for bit over a chain of steps, signed zeros included."""
    from repro_torch.core.lif import LIFConfig, lif_step
    from repro_torch.kernels import ops
    dev = _card()
    rng = np.random.default_rng(11)
    cfg = LIFConfig()
    u_k = u_e = torch.zeros(8, 1024, device=dev)
    s_k = s_e = torch.zeros(8, 1024, device=dev)
    reset_launch_counts()
    for i in range(6):
        x = rng.normal(0.3, 1.2, (8, 1024)).astype(np.float32)
        x[0, :4] = [0.0, -0.0, 1.0, -1.0]
        x = _t(x).to(dev)
        s, u_k, s_k = ops.lif_soma_step_op(x, u_k, s_k, cfg.alpha,
                                           cfg.th_fire, cfg.th_lo, cfg.th_hi,
                                           cfg.grad_scale)
        u_e, s_e = lif_step(u_e, s_e, x, cfg)
        assert torch.equal(s, s_e) and torch.equal(s_k, s_e)
        assert torch.equal(u_k, u_e)
    torch.cuda.synchronize()
    assert launch_counts()["lif_soma_fwd"] == 6
    # The carry runs inside the kernel (one launch a step, no fold into
    # x[0]), so U equals lif_step's to the sign of a zero: from u0 < 0 and
    # s0 = 1, alpha * u0 * (1 - s0) is -0, and -0 + x keeps x's sign.
    u0 = torch.full((8, 1024), -0.5, device=dev)
    s0 = torch.ones(8, 1024, device=dev)
    x = torch.zeros(8, 1024, device=dev)
    x[:, ::2] = -0.0
    s, u_k, s_k = ops.lif_soma_step_op(x, u0, s0, cfg.alpha, cfg.th_fire,
                                       cfg.th_lo, cfg.th_hi, cfg.grad_scale)
    u_e, s_e = lif_step(u0, s0, x, cfg)
    assert torch.equal(u_k.view(torch.int32), u_e.view(torch.int32))
    assert torch.equal(s_k.view(torch.int32), s_e.view(torch.int32))
    assert bool(torch.signbit(u_k[:, ::2]).all())
    torch.cuda.synchronize()
    assert launch_counts()["lif_soma_fwd"] == 7


def _lif_input(rng, t, m, d, layout, dev):
    """(T, M, D) contiguous, or the LM's (S, B, D) view of (B, S, D)."""
    if layout == "lm":
        return _t(rng.normal(0.3, 1.2, (m, t, d)).astype(np.float32)).to(
            dev).transpose(0, 1)
    return _t(rng.normal(0.3, 1.2, (t, m, d)).astype(np.float32)).to(dev)


def _fwd_on(arm, x, *state):
    """``lif_soma_fwd``'s launch on one arm (the wrapper picks one)."""
    return lif_soma._launch_fwd(x, *(state or (None, None)), arm,
                                (0.5, 1.0, 0.0, 2.0),
                                torch.cuda.current_stream().cuda_stream)


def _bwd_on(arm, g, u, s, mask, gu_last=None):
    return lif_soma._launch_bwd(g, u, s, mask, gu_last, arm, (0.5, 1.0),
                                torch.cuda.current_stream().cuda_stream)


def _check_lif_arms(rng, t, m, d, layout, dev):
    """Both kernels on every arm that takes the layout, from rest and from a
    carried state, with and without ``gu_last``: bit-equal to the plain
    versions, outputs in the operands' layout."""
    x = _lif_input(rng, t, m, d, layout, dev)
    u0 = _t(rng.normal(0.4, 0.8, (m, d)).astype(np.float32)).to(dev)
    s0 = _t(_spikes(rng, (m, d), 0.4)).to(dev)
    gu = _t(rng.normal(0, 1, (m, d)).astype(np.float32)).to(dev)
    for arm in ("ring", "flat"):
        if arm == "flat" and not x.is_contiguous():
            continue
        for state in ((), (u0, s0)):
            if arm == "flat" and state:
                continue
            got = _fwd_on(arm, x, *state)
            want = lif_soma.lif_soma_fwd_plain(x, *state)
            assert len(got) == len(want) == 3 + len(state)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (arm, len(state))
            assert all(a.stride() == x.stride() for a in got[:3])
            s, u, mask = got[:3]
            g = torch.empty_like(u).copy_(_t(rng.normal(
                0, 1, (t, m, d)).astype(np.float32)))
            for carry in (None, gu):
                dx = _bwd_on(arm, g, u, s, mask, carry)
                assert torch.equal(dx, lif_soma.lif_soma_bwd_plain(
                    g, u, s, mask, carry)), (arm, carry is None)
                assert dx.stride() == g.stride()
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("t,m,d", [(1, 8, 1024), (4, 3136, 512),
                                   (128, 8, 1024), (256, 1, 1024),
                                   (256, 8, 1024)])
@pytest.mark.parametrize("layout", ["dense", "lm"])
def test_lif_kernels_bitwise_at_the_path_shapes(t, m, d, layout):
    """The decode, training, forward and Spikingformer shapes, contiguous
    and as the LM's (S, B, D) view: both kernels bit-equal to their plain
    versions on each arm, from rest and from a carried state, with and
    without ``gu_last``."""
    _check_lif_arms(np.random.default_rng(t * m), t, m, d, layout, _card())


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 5, 127, 129, 1000])
@pytest.mark.parametrize("m,d", [(1, 1), (1, 3), (1, 37), (3, 2731)])
def test_lif_kernels_bitwise_at_ragged_shapes(t, m, d):
    """T = 1, 5, 127, 129, 1000 (a ragged last chunk of the ring) over
    n = 1, 3, 37, 8193 elements (no full warp, D not a multiple of 32 or of
    4), contiguous and as a swapped view."""
    dev = _card()
    rng = np.random.default_rng(t + m * d)
    for layout in ("dense", "lm"):
        _check_lif_arms(rng, t, m, d, layout, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("t,m,d", [(100, 8, 1024), (129, 2, 1024),
                                   (1000, 1, 64), (70, 20, 1024)])
def test_lif_ring_arm_wide_copies_over_a_ragged_last_chunk(t, m, d):
    """D % 32 == 0 with 16-byte aligned rows: the ring arm's warp-shared
    16-byte copies, over whole 64-step chunks and then a ragged one (T =
    100, 129, 1000, 70), in blocks of 32 threads and (n = 20,480) of 64;
    both kernels, contiguous and as the LM's (S, B, D) view, from rest and
    from a carried state, with and without ``gu_last``, bit-equal to the
    plain versions."""
    dev = _card()
    rng = np.random.default_rng(t * m + d)
    for layout in ("dense", "lm"):
        _check_lif_arms(rng, t, m, d, layout, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("below", [True, False])
def test_lif_kernels_on_both_sides_of_the_arm_crossover(below):
    """Just below and at ``FLAT_MIN_N`` elements, at T = 16, the rule
    changes arm; each side bit-equal to the plain versions, one launch a
    call."""
    dev = _card()
    t, d = 16, 1024
    m = lif_soma.FLAT_MIN_N // d - (1 if below else 0)
    assert lif_soma.choose_arm(t, m * d, True) == ("ring" if below
                                                   else "flat")
    rng = np.random.default_rng(m)
    x = _lif_input(rng, t, m, d, "dense", dev)
    reset_launch_counts()
    got = lif_soma.lif_soma_fwd(x)
    for a, b in zip(got, lif_soma.lif_soma_fwd_plain(x)):
        assert torch.equal(a, b)
    g = torch.randn_like(x)
    assert torch.equal(lif_soma.lif_soma_bwd(g, got[1], got[0], got[2]),
                       lif_soma.lif_soma_bwd_plain(g, got[1], got[0],
                                                   got[2]))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert (counts["lif_soma_fwd"], counts["lif_soma_bwd"]) == (1, 1)


@pytest.mark.cuda
def test_lif_kernels_refuse_what_they_do_not_take():
    """No arm stands in for another: the flat arm's entry refuses a view
    and a carried state, GRAD operands of two layouts, and the wrappers a
    strided D."""
    dev = _card()
    x = torch.randn(4, 16, 64, device=dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        _fwd_on("flat", x.transpose(0, 1))
    z = torch.zeros(16, 64, device=dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        _fwd_on("flat", x, z, z)
    s, u, mask = lif_soma.lif_soma_fwd(x)
    g = x.transpose(0, 1).contiguous().transpose(0, 1)   # x's shape, not
    with pytest.raises(ValueError, match="one layout"):   # its layout
        lif_soma.lif_soma_bwd(g, u, s, mask)
    with pytest.raises(ValueError, match="unit stride"):
        lif_soma.lif_soma_fwd(x.transpose(1, 2))


@pytest.mark.cuda
def test_engine_tokens_equal_under_cuda_full_and_eager():
    """qwen3-0.6b at its published width, two layers deep, fp32, 6 requests
    through 4 slots: the token streams, every step's logits and the final
    cache equal under ``cuda-full`` and ``eager``, 2 ``lif_soma_fwd``
    launches a step under ``cuda-full`` and none under ``eager``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.lif import LIFConfig
    from repro_torch.core.policy import named_policy
    from repro_torch.models.common import split_tree
    from repro_torch.models.lm import init_lm
    from repro_torch.serving import Request, ServingEngine
    dev = _card()
    base = get_config("qwen3-0.6b").replace(num_layers=2, dtype=torch.float32)
    params = split_tree(init_lm(torch.Generator(device=dev).manual_seed(0),
                                base, dev))[0]
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, base.vocab_size, rng.integers(2, 9)).tolist(),
             int(rng.integers(3, 9))) for _ in range(6)]
    runs = {}
    for policy in ("cuda-full", "eager"):
        cfg = base.replace(lif=LIFConfig(policy=named_policy(policy)))
        engine = ServingEngine(params, cfg, slots=4, max_seq=32, device=dev)
        logits, fused = [], engine._step

        def record(*args):
            out = fused(*args)
            logits.append(out[0])
            return out
        engine._step = record
        for uid, (p, n) in enumerate(reqs):
            engine.submit(Request(uid=uid, prompt=p, max_new_tokens=n))
        reset_launch_counts()
        engine.run_to_completion()
        torch.cuda.synchronize()
        runs[policy] = ({r.uid: r.output for r in engine.finished}, logits,
                        engine.cache, launch_counts()["lif_soma_fwd"],
                        engine.step_count)
    (tok_c, lg_c, cache_c, n_c, steps), (tok_e, lg_e, cache_e, n_e, _) = \
        runs["cuda-full"], runs["eager"]
    assert len(tok_c) == 6 and tok_c == tok_e
    assert len(lg_c) == len(lg_e) == steps
    assert all(torch.equal(a, b) for a, b in zip(lg_c, lg_e))
    assert torch.equal(cache_c["lif"]["s"], cache_e["lif"]["s"])
    assert torch.equal(cache_c["kv"]["k"], cache_e["kv"]["k"])
    assert (n_c, n_e) == (2 * steps, 0)


@pytest.mark.cuda
def test_moe_mla_lm_launches_and_bits_under_cuda_full_and_eager():
    """deepseek-v2-236b reduced (d 64, MLA, 8 experts top-2, a shared
    expert), two layers, fp32, with the LIF: a (2, 16) forward takes 2
    ``lif_soma_fwd`` launches (one a layer), a decode step 2 (from the
    carry); two ``cuda-full`` forwards give the same bits (the MoE combine
    adds in a fixed order), equal to ``eager``'s, and so do the decode
    steps' logits."""
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.core.lif import LIFConfig
    from repro_torch.core.policy import named_policy
    from repro_torch.models.common import split_tree
    from repro_torch.models.lm import (init_cache, init_lm, lm_decode_step,
                                       lm_forward)
    dev = _card()
    base = reduced(get_config("deepseek-v2-236b")).replace(num_layers=2)
    params = split_tree(init_lm(torch.Generator(device=dev).manual_seed(0),
                                base, dev))[0]
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, base.vocab_size, (2, 16))).to(dev)
    out = {}
    for policy in ("cuda-full", "eager"):
        cfg = base.replace(lif=LIFConfig(policy=named_policy(policy)))
        with torch.inference_mode():
            reset_launch_counts()
            h, aux = lm_forward(params, {"tokens": toks}, cfg)
            torch.cuda.synchronize()
            n_fwd = launch_counts()["lif_soma_fwd"]
            again, _ = lm_forward(params, {"tokens": toks}, cfg)
            cache = init_cache(cfg, 2, 16, torch.float32, dev)
            logits = []
            for t in range(4):
                reset_launch_counts()
                lg, cache = lm_decode_step(params, cache, toks[:, t:t + 1],
                                           torch.full((2,), t, device=dev),
                                           cfg)
                torch.cuda.synchronize()
                logits.append((lg, launch_counts()["lif_soma_fwd"]))
        assert torch.equal(h, again)
        out[policy] = (h, aux, n_fwd, logits)
    (h_c, aux_c, n_c, lg_c), (h_e, aux_e, n_e, lg_e) = \
        out["cuda-full"], out["eager"]
    assert torch.equal(h_c, h_e) and torch.equal(aux_c, aux_e)
    assert (n_c, n_e) == (2, 0)
    assert all(torch.equal(a, b) for (a, _), (b, _) in zip(lg_c, lg_e))
    assert [n for _, n in lg_c] == [2] * 4 and [n for _, n in lg_e] == [0] * 4


# ---------------------------------------------------------------------------
# The spiking LM's training path (qwen3-0.6b + LIF)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_lif_soma_bwd_at_the_lm_training_shape():
    """GRAD over the LM's training shape (S, B, d) = (128, 8, 1024): dL/dX
    bit-equal to the plain version, one launch."""
    dev = _card()
    rng = np.random.default_rng(19)
    x = _t(rng.normal(0.3, 1.2, (128, 8, 1024)).astype(np.float32)).to(dev)
    g = _t(rng.normal(0, 1, (128, 8, 1024)).astype(np.float32)).to(dev)
    s, u, mask = lif_soma.lif_soma_fwd_plain(x)
    reset_launch_counts()
    got = lif_soma.lif_soma_bwd(g, u, s, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, lif_soma.lif_soma_bwd_plain(g, u, s, mask))
    assert launch_counts()["lif_soma_bwd"] == 1


@pytest.mark.cuda
def test_reduced_spiking_lm_train_step_cuda_full_against_eager():
    """Reduced qwen3-0.6b (4 layers, d 64) with the LIF, fp32, the layers
    rematerialised: the loss bit-equal under ``cuda-full`` and ``eager``
    (the SOMA kernel equals the eager scan bit for bit), every gradient
    leaf within 1e-5 relative L2 (GRAD may round in another order than
    autograd through the eager loop), 2 x 4 ``lif_soma_fwd`` (forward and
    recompute) and 4 ``lif_soma_bwd`` launches, and a finite train step
    that moves every parameter leaf."""
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.core.lif import LIFConfig
    from repro_torch.core.policy import named_policy
    from repro_torch.core.spikingformer import tree_leaves, value_and_grad
    from repro_torch.launch.train import build_state
    from repro_torch.models.lm import lm_loss
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptimizerConfig
    dev = _card()
    base = reduced(get_config("qwen3-0.6b")).replace(remat=True)
    params, opt, _ = build_state(base, seed=0, device=dev)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, base.vocab_size, (4, 33))
    batch = {"tokens": _t(toks[:, :-1]).to(dev),
             "labels": _t(toks[:, 1:]).to(dev)}
    out = {}
    for name in ("cuda-full", "eager"):
        cfg = base.replace(lif=LIFConfig(policy=named_policy(name)))
        reset_launch_counts()
        out[name] = value_and_grad(lm_loss, params, batch, cfg)
        torch.cuda.synchronize()
        out[name] += (launch_counts(),)
    ((loss_c, _), g_c, n_c), ((loss_e, _), g_e, n_e) = \
        out["cuda-full"], out["eager"]
    assert torch.equal(loss_c, loss_e)
    for a, b in zip(tree_leaves(g_c), tree_leaves(g_e)):
        assert float((a - b).norm() / b.norm().clamp_min(1e-30)) <= 1e-5
    assert (n_c["lif_soma_fwd"], n_c["lif_soma_bwd"]) == (8, 4)
    assert set(n_e.values()) == {0}
    cfg = base.replace(lif=LIFConfig(policy=named_policy("cuda-full")))
    new, _, metrics = make_train_step(cfg, OptimizerConfig())(params, opt,
                                                              batch)
    assert float(metrics["nonfinite"]) == 0.0
    assert np.isfinite(float(metrics["grad_norm"]))
    assert not any(torch.equal(a, b) for a, b in
                   zip(tree_leaves(new), tree_leaves(params)))


@pytest.mark.cuda
def test_checkpoint_round_trip_of_cuda_tensors(tmp_path):
    """An asynchronous save of CUDA tensors (fp32, bf16, int32) restores
    bit-equal onto the devices of the ``like`` tree's leaves: the card, or
    the CPU."""
    from repro_torch.train import checkpoint as ckpt
    dev = _card()
    tree = {"w": torch.randn(64, 32, device=dev),
            "h": [torch.randn(7, device=dev).to(torch.bfloat16)],
            "step": torch.tensor(3, dtype=torch.int32, device=dev)}
    ckpt.save_checkpoint(str(tmp_path), 3, tree, async_save=True).join(30)
    assert ckpt.verify_checkpoint(str(tmp_path), 3) == []
    on_card = ckpt.restore_checkpoint(str(tmp_path), 3, tree)
    cpu_like = {"w": torch.zeros(1), "h": [torch.zeros(1)],
                "step": torch.zeros(1)}
    on_cpu = ckpt.restore_checkpoint(str(tmp_path), 3, cpu_like)
    for got, device in ((on_card, dev), (on_cpu, torch.device("cpu"))):
        assert got["w"].device.type == device.type
        assert torch.equal(got["w"].cpu(), tree["w"].cpu())
        assert got["h"][0].dtype == torch.bfloat16
        assert torch.equal(got["h"][0].cpu().view(torch.int16),
                           tree["h"][0].cpu().view(torch.int16))
        assert int(got["step"]) == 3


@pytest.fixture
def world_of_one():
    """A world of 1 on the card (NCCL, a file store): its data group."""
    from repro_torch.launch.mesh import (init_distributed, make_test_mesh,
                                         shutdown_distributed)
    _card()
    init_distributed()
    try:
        yield make_test_mesh(1, 1)
    finally:
        shutdown_distributed()


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(1000, 64), (777, 130), (4096, 96)])
def test_split_bn_path_is_the_fused_path_at_a_world_of_one(world_of_one, m,
                                                           d):
    """The BN kernels' split path (sums, the all-reduce, apply) gives the
    fused path's outputs and statistics bit for bit at a world of 1, and
    the halves' sums added give the whole's statistics within 1e-6."""
    from repro_torch.kernels import fused_bn
    dev, group = world_of_one.device, world_of_one.batch_group
    rng = np.random.default_rng(m + d)
    x = _t(rng.normal(0.5, 2.0, (m, d)).astype(np.float32)).to(dev)
    g = _t(rng.normal(0, 1, (m, d)).astype(np.float32)).to(dev)
    gamma = _t(rng.uniform(0.5, 1.5, d).astype(np.float32)).to(dev)
    beta = _t(rng.normal(0, 0.3, d).astype(np.float32)).to(dev)
    fused = fused_bn.bn_fwd(x, gamma, beta)
    split = fused_bn.bn_fwd(x, gamma, beta, group=group)
    assert all(torch.equal(a, b) for a, b in zip(fused, split))
    mu, sd = fused[1], fused[2]
    for a, b in zip(fused_bn.bn_bwd(g, x, gamma, mu, sd),
                    fused_bn.bn_bwd(g, x, gamma, mu, sd, group)):
        assert torch.equal(a, b)
    h = m // 2
    sums = fused_bn.bn_fwd_sums(x[:h]) + fused_bn.bn_fwd_sums(x[h:])
    _, mu_h, sd_h = fused_bn.bn_fwd_apply(x[:h], gamma, beta, sums)
    torch.cuda.synchronize()
    assert float((mu_h - mu).abs().max() / mu.abs().max()) <= 1e-6
    assert float((sd_h - sd).abs().max() / sd.abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("packed,c", [(True, 64), (False, 27)])
def test_split_neuron_layer_is_the_fused_path_at_a_world_of_one(
        world_of_one, packed, c):
    """neuron_layer_train with the group: spikes and statistics the fused
    path's bits, and the backward's replay on them equal to the emitted
    spikes."""
    from repro_torch.kernels import ops
    dev, group = world_of_one.device, world_of_one.batch_group
    rng = np.random.default_rng(c)
    x = _t(_spikes(rng, (4, 300, c)) if packed
           else rng.random((4, 300, c)).astype(np.float32)).to(dev)
    w = _t(rng.normal(0, 2 * c ** -0.5, (c, 40)).astype(np.float32)).to(dev)
    gamma = _t(rng.uniform(0.8, 1.2, 40).astype(np.float32)).to(dev)
    beta = _t(rng.normal(0.3, 0.2, 40).astype(np.float32)).to(dev)
    fused = neuron_layer.neuron_layer_train_fwd(x, w, gamma, beta,
                                                packed=packed)
    split = neuron_layer.neuron_layer_train_fwd(x, w, gamma, beta,
                                                packed=packed, group=group)
    assert all(torch.equal(a, b) for a, b in zip(fused[:4], split[:4]))
    s, mu, _, sd, xin = split
    _, y = ops.replay_train_pre_activation(x, xin, w, gamma, beta, mu, sd,
                                           packed)
    assert torch.equal(lif_soma.lif_soma_fwd(y)[0], s)


@pytest.mark.cuda
def test_mesh_step_is_the_mesh_less_step_at_a_world_of_one(world_of_one):
    """Two ``cuda-full`` training steps at the smoke preset on a (1, 1)
    mesh: losses, parameters, BN state and moments bit-equal to the
    mesh-less step's."""
    from repro_torch.configs import get_spikingformer_config
    from repro_torch.core.spikingformer import tree_leaves
    from repro_torch.launch.train import build_spikingformer_state
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptimizerConfig
    dev = world_of_one.device
    cfg = get_spikingformer_config("spikingformer-smoke@cuda-full")
    rng = np.random.default_rng(5)
    images = _t(rng.random((4, cfg.image_size, cfg.image_size,
                            cfg.in_channels)).astype(np.float32)).to(dev)
    labels = _t(np.array([0, 1, 2, 3], np.int32)).to(dev)
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    out = {}
    for name, mesh in (("mesh", world_of_one), ("none", None)):
        p, st, opt, (p_specs, _) = build_spikingformer_state(
            cfg, mesh, opt_cfg, seed=3, fsdp_min_elems=1024, device=dev)
        step = make_train_step(cfg, opt_cfg, mesh=mesh,
                               specs=p_specs if mesh is not None else None)
        losses = []
        for _ in range(2):
            p, st, opt, m = step(p, st, opt, images, labels)
            losses.append(m["loss"])
        out[name] = (losses, tree_leaves({"p": p, "st": st, "opt": opt}))
    assert all(torch.equal(a, b) for a, b in zip(out["mesh"][0],
                                                 out["none"][0]))
    assert all(torch.equal(a, b) for a, b in zip(out["mesh"][1],
                                                 out["none"][1]))


# ---------------------------------------------------------------------------
# The analysis on the card: every contract against the oracles of
# kernels/ref.py, and the launch family of the contract verifier
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_every_contract_case_against_the_oracle_on_the_card():
    """Each of the eleven contracts at each of its site geometries at batch 1
    (the matrix of ``analysis.contracts.kernel_cases``) launched on the
    card and held against ``kernels/ref.py`` (``hold_against_oracle``'s
    tolerances)."""
    from repro_torch.analysis.contracts import (hold_against_oracle,
                                                kernel_cases)
    from repro_torch.kernels.contract import SkipCase, kernel_contracts

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for where, decl, case in kernel_cases(batch=1):
        try:
            rows.append((where, hold_against_oracle(decl, case, gen)))
        except SkipCase:
            continue
    bad = [(w, r) for w, r in rows if not r["ok"]]
    assert not bad, bad[:5]
    assert {r["contract"] for _, r in rows} == set(kernel_contracts())


@pytest.mark.cuda
def test_the_launch_family_runs_clean_on_the_card():
    """Every declared case at batch 16: the launches read from the plan
    exports are within the card's limits, and none was made."""
    from repro_torch.analysis.contracts import (audit_kernel_matrix,
                                                launch_family_ran)

    _card()
    before = launch_counts()
    findings = audit_kernel_matrix(batch=16, launches=True)
    assert launch_family_ran(findings)
    assert [f.format() for f in findings if f.level == "error"] == []
    assert launch_counts() == before


@pytest.mark.cuda
def test_a_chaos_fault_at_a_cuda_site_trips_the_breaker():
    """``chaos.kernel.pssa.qkv`` in one training step of
    ``spikingformer-smoke`` under ``cuda-full`` on the card: the site
    demotes to the eager pipeline, so loss and every gradient leaf equal
    those of the step with ``pssa.qkv: eager``; the demoted neuron layers'
    launches (each a forward, its replay and its ``bn_bwd``) go, the other
    kernels keep theirs."""
    from repro_torch.chaos import FaultSchedule, FaultSpec, chaos
    from repro_torch.configs import get_spikingformer_config
    from repro_torch.core.policy import breaker_trips, reset_breaker
    from repro_torch.core.spikingformer import (init_spikingformer,
                                                spikingformer_grad_step,
                                                tree_leaves)
    dev = _card()
    cfg = get_spikingformer_config("spikingformer-smoke@cuda-full")
    pinned = cfg.with_policy(cfg.policy.with_sites({"pssa.qkv": "eager"}))
    params, state = init_spikingformer(torch.Generator().manual_seed(0), cfg,
                                       dev)
    images = torch.rand(4, 32, 32, 3, device=dev)
    labels = torch.tensor([0, 1, 2, 3], device=dev)
    out = {}
    reset_breaker()
    try:
        for name, c, sched in (
                ("clean", cfg, None),
                ("faulted", cfg, FaultSchedule(faults=(
                    FaultSpec("chaos.kernel.pssa.qkv", 0, "raise"),))),
                ("pinned", pinned, None)):
            if name == "pinned":
                assert set(breaker_trips()) == {"pssa.qkv"}
                reset_breaker()
            reset_launch_counts()
            if sched is None:
                grads, st, m = spikingformer_grad_step(params, state, images,
                                                       labels, c)
            else:
                with chaos(sched) as inj:
                    grads, st, m = spikingformer_grad_step(
                        params, state, images, labels, c)
                assert inj.events == ["chaos.kernel.pssa.qkv@0:raise"]
            torch.cuda.synchronize()
            out[name] = (m["loss"], tree_leaves(grads), tree_leaves(st),
                         launch_counts())
    finally:
        reset_breaker()
    (lf, gf, sf, cf), (lp, gp, sp, cp) = out["faulted"], out["pinned"]
    assert torch.equal(lf, lp)
    assert all(torch.equal(a, b) for a, b in zip(gf, gp))
    assert all(torch.equal(a, b) for a, b in zip(sf, sp))
    want = dict(out["clean"][3])
    want["neuron_layer_train"] -= 2 * 3 * cfg.num_layers
    want["bn_bwd"] -= 3 * cfg.num_layers
    want["spike_pack"] -= 3 * cfg.num_layers
    assert cf == cp == want


@pytest.mark.cuda
def test_a_real_kernel_error_is_not_demoted():
    """A kernel that refuses its input raises through dispatch on the card,
    with a chaos schedule active for another site: no fallback to the
    eager arm, no trip."""
    from repro_torch.chaos import FaultSchedule, FaultSpec, chaos
    from repro_torch.core.lif import LIFConfig, lif_scan
    from repro_torch.core.policy import breaker_trips, named_policy
    from repro_torch.core.spiking_layers import bn_apply, init_bn

    dev = _card()
    x = torch.rand(4, 70, 32, device=dev, dtype=torch.float64)
    bn_p, bn_s = init_bn(32, torch.float64, dev)
    with chaos(FaultSchedule(faults=(
            FaultSpec("chaos.kernel.smlp.a", 0, "raise"),))) as inj:
        with pytest.raises(TypeError, match="float32"):
            lif_scan(x, LIFConfig(policy=named_policy("cuda")),
                     site="pssa.lif")
        with pytest.raises(TypeError, match="float32"):
            bn_apply(bn_p, bn_s, x, train=True, policy=named_policy("cuda"),
                     site="tokenizer.bn")
        assert inj.events == []
    assert breaker_trips() == {}


# ---------------------------------------------------------------------------
# bf16: each kernel's bf16 arm, fp16 refused, the spiking LM at bf16
# ---------------------------------------------------------------------------

#: Small geometries of every contract at bf16: the packed and dense neuron
#: layers, a ragged tile, and a long LIF walk (the ring arm).
BF16_CASES = ((4, 196, 512, 512, True), (4, 70, 27, 40, False),
              (4, 33, 24, 20, True), (2, 64, 64, 64, True),
              (130, 8, 1024, 1024, False), (70, 8, 200, 200, False))


@pytest.mark.cuda
def test_every_contract_at_bf16_against_its_oracle_on_the_card():
    """Each contract's bf16 arm against its bf16 oracle
    (``hold_against_oracle`` on ``oracle_operands``' exact bf16 operands):
    within its tolerance everywhere, and bit for bit but where the values
    pass through BN's backward sums (the neuron layers' spikes equal the
    oracle's outright on exact operands)."""
    from repro_torch.analysis.contracts import hold_against_oracle
    from repro_torch.kernels.contract import (KernelCase, SkipCase,
                                              kernel_contracts)
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    seen = set()
    for name, decl in kernel_contracts().items():
        for t, m, c, k, packed in BF16_CASES:
            if t > 8 and not name.startswith("lif"):
                continue
            try:
                row = hold_against_oracle(
                    decl, KernelCase(t, m, c, k, packed, "bfloat16"), gen)
            except SkipCase:
                continue
            assert row["ok"], (name, (t, m, c, k, packed), row)
            assert row["bitwise"] or name == "bn_bwd", (name, row)
            seen.add(name)
    assert seen == set(kernel_contracts())


@pytest.mark.cuda
def test_the_kernels_refuse_fp16_and_mixed_dtypes():
    """fp16 has no kernel arm: every wrapper raises ``TypeError`` for an
    fp16 CUDA tensor before anything launches; x and w of two dtypes are
    refused too."""
    from repro_torch.kernels import fused_bn
    dev = _card()
    h = torch.float16
    x = torch.randn(4, 16, 64, device=dev, dtype=h)
    packed = spike_matmul.spike_pack((x[0] > 0).float())   # a launch, before
    reset_launch_counts()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lif_soma.lif_soma_fwd(x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lif_soma.lif_soma_bwd(x, x, x, x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        spike_matmul.spike_matmul_packed(packed, torch.randn(
            64, 32, device=dev, dtype=h))
    x2 = x.reshape(64, 64)
    v = torch.ones(64, device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_bn.bn_fwd(x2, v, v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_bn.bn_bwd(x2, x2, v, v[None], v[None])
    w = torch.randn(64, 32, device=dev, dtype=h)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        neuron_layer.neuron_layer_eval(x, w, v[:32])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        neuron_layer.neuron_layer_train(x, w, v[:32], v[:32])
    with pytest.raises(TypeError, match="one dtype"):
        neuron_layer.neuron_layer_eval(x.to(torch.bfloat16), w.float(),
                                       v[:32])
    assert set(launch_counts().values()) == {0}


@pytest.mark.cuda
def test_reduced_spiking_lm_at_bf16_cuda_full_against_eager():
    """Reduced qwen3-0.6b + LIF at bf16 (the registry's dtype), the
    layers rematerialised: the forward and the loss bit-equal under
    ``cuda-full`` and ``eager`` (the bf16 SOMA kernel equals the eager scan
    bit for bit), every gradient leaf within 2e-2 of its scale (GRAD rounds
    eq. 12 in the recursion's order, autograd in its own), the launches of
    the fp32 step, and a finite bf16 train step that moves every weight
    matrix."""
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.core.lif import LIFConfig
    from repro_torch.core.policy import named_policy
    from repro_torch.core.spikingformer import tree_leaves, value_and_grad
    from repro_torch.launch.train import build_state
    from repro_torch.models.lm import lm_forward, lm_loss
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptimizerConfig
    dev = _card()
    base = reduced(get_config("qwen3-0.6b")).replace(
        remat=True, dtype=torch.bfloat16)
    params, opt, _ = build_state(base, seed=0, device=dev)
    assert {a.dtype for a in tree_leaves(params)} == {torch.bfloat16}
    rng = np.random.default_rng(5)
    toks = rng.integers(0, base.vocab_size, (4, 33))
    batch = {"tokens": _t(toks[:, :-1]).to(dev),
             "labels": _t(toks[:, 1:]).to(dev)}
    out = {}
    for name in ("cuda-full", "eager"):
        cfg = base.replace(lif=LIFConfig(policy=named_policy(name)))
        with torch.no_grad():
            h = lm_forward(params, {"tokens": batch["tokens"]}, cfg)[0]
        reset_launch_counts()
        out[name] = value_and_grad(lm_loss, params, batch, cfg)
        torch.cuda.synchronize()
        out[name] += (launch_counts(), h)
    ((loss_c, _), g_c, n_c, h_c), ((loss_e, _), g_e, n_e, h_e) = \
        out["cuda-full"], out["eager"]
    assert torch.equal(h_c, h_e) and torch.equal(loss_c, loss_e)
    for a, b in zip(tree_leaves(g_c), tree_leaves(g_e)):
        assert a.dtype == b.dtype == torch.bfloat16
        scale = float(b.float().abs().max().clamp_min(1.0))
        assert float((a.float() - b.float()).abs().max()) <= 2e-2 * scale
    assert (n_c["lif_soma_fwd"], n_c["lif_soma_bwd"]) == (8, 4)
    assert set(n_e.values()) == {0}
    cfg = base.replace(lif=LIFConfig(policy=named_policy("cuda-full")))
    # bf16 weights take the AdamW step themselves: a step below half a bf16
    # unit of a weight leaves it as it was, so the step here is 1e-2
    new, _, metrics = make_train_step(cfg, OptimizerConfig(
        lr=1e-2, warmup_steps=1))(params, opt, batch)
    assert float(metrics["nonfinite"]) == 0.0
    assert np.isfinite(float(metrics["grad_norm"]))
    assert not any(torch.equal(a, b) for a, b in
                   zip(tree_leaves(new), tree_leaves(params)))


# ---------------------------------------------------------------------------
# The last modules: the vlm family, the examples, the read fault on a mesh
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduced_pixtral_with_patches_cuda_full_against_eager(dtype):
    """Reduced ``pixtral-12b`` + LIF on a batch whose ``patch_mask`` is
    partly true: the merge changes the forward, the forward and the loss
    are bit-equal under ``cuda-full`` and ``eager``, every gradient leaf
    within 1e-5 (fp32) or 2e-2 (bf16) of its scale, and 4 requests served
    with a cache of the model's dtype give the same tokens; one launch of
    ``lif_soma_fwd`` a layer in the forward."""
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.core.lif import LIFConfig
    from repro_torch.core.policy import named_policy
    from repro_torch.core.spikingformer import tree_leaves, value_and_grad
    from repro_torch.launch.train import build_state
    from repro_torch.models.lm import lm_forward, lm_loss
    from repro_torch.serving import Request, ServingEngine
    dev = _card()
    base = reduced(get_config("pixtral-12b")).replace(remat=True, dtype=dtype)
    params = build_state(base, seed=1, device=dev)[0]
    rng = np.random.default_rng(9)
    toks = rng.integers(0, base.vocab_size, (4, 33))
    batch = {"tokens": _t(toks[:, :-1]).to(dev),
             "labels": _t(toks[:, 1:]).to(dev),
             "patch_embeds": _t(rng.normal(0, 1, (4, 32, base.d_model))
                                .astype(np.float32)).to(dev).to(dtype),
             "patch_mask": _t(rng.random((4, 32)) < 0.25).to(dev)}
    out, tokens = {}, {}
    for name in ("cuda-full", "eager"):
        cfg = base.replace(lif=LIFConfig(policy=named_policy(name)))
        reset_launch_counts()
        with torch.no_grad():
            h = lm_forward(params, batch, cfg)[0]
        torch.cuda.synchronize()
        n = launch_counts()["lif_soma_fwd"]
        out[name] = (h, n) + value_and_grad(lm_loss, params, batch, cfg)
        engine = ServingEngine(params, cfg, slots=2, max_seq=32,
                               cache_dtype=dtype, device=dev)
        for uid in range(4):
            assert engine.submit(Request(uid=uid, prompt=toks[uid, :5]
                                         .tolist(), max_new_tokens=6))
        tokens[name] = {r.uid: r.output for r in engine.run_to_completion()}
    (h_c, n_c, (loss_c, _), g_c), (h_e, n_e, (loss_e, _), g_e) = \
        out["cuda-full"], out["eager"]
    with torch.no_grad():
        plain = lm_forward(params, {"tokens": batch["tokens"]}, base)[0]
    assert not torch.equal(plain, h_e)
    assert torch.equal(h_c, h_e) and torch.equal(loss_c, loss_e)
    assert (n_c, n_e) == (base.num_layers, 0)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(tree_leaves(g_c), tree_leaves(g_e)):
        scale = float(b.float().abs().max().clamp_min(1.0))
        assert float((a.float() - b.float()).abs().max()) <= tol * scale
    assert tokens["cuda-full"] == tokens["eager"] and \
        len(tokens["eager"]) == 4


@pytest.mark.cuda
def test_the_examples_run_on_the_card(capsys):
    """``examples/torch``' three model examples on the card at a few steps,
    under their default policy (``cuda-full``): the kernels launch, every
    loss finite."""
    import importlib.util
    import math
    import re
    from pathlib import Path
    _card()
    root = Path(__file__).resolve().parents[1] / "examples" / "torch"
    runs = {"quickstart": [], "train_spikingformer": ["--steps", "3",
                                                      "--batch", "4"],
            "serve_lm": ["--train-steps", "3", "--requests", "2"]}
    for name, argv in runs.items():
        spec = importlib.util.spec_from_file_location(f"ex_{name}",
                                                      root / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        reset_launch_counts()
        mod.main(argv)
        torch.cuda.synchronize()
        out = capsys.readouterr().out
        losses = [float(v) for v in re.findall(r"loss (-?[\d.]+|nan|inf)",
                                               out)]
        assert losses and all(map(math.isfinite, losses)), out
        if name != "serve_lm":              # the Spikingformer's kernels
            assert launch_counts()["lif_soma_bwd"] > 0, name


@pytest.mark.cuda
def test_a_read_fault_on_a_world_of_one_falls_back_once(world_of_one,
                                                        tmp_path):
    """A ``chaos.ckpt`` corrupt read fault at the newest of two steps saved
    on a (1, 1) mesh of the card: the flag's all-reduce on the card (NCCL)
    refuses it, the previous step comes back bit-equal, one event."""
    import warnings
    from repro_torch.chaos import inject
    from repro_torch.chaos.schedule import FaultSchedule, FaultSpec
    from repro_torch.train import checkpoint as ckpt
    dev = world_of_one.device

    def tree(step):
        return {"w": torch.arange(48, dtype=torch.float32,
                                  device=dev).reshape(6, 8) + step,
                "b": torch.full((8,), float(step), device=dev)}
    specs = {"w": None, "b": None}
    for step in (2, 4):
        ckpt.save_checkpoint(str(tmp_path), step, tree(step), specs,
                             mesh=world_of_one)
    sched = FaultSchedule(seed=3, faults=(
        FaultSpec("chaos.ckpt", 4, "corrupt", mode="read"),))
    with inject.chaos(sched) as injector, warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        step, got = ckpt.restore_latest_good(str(tmp_path), tree(0),
                                             world_of_one, specs)
    assert step == 2 and len(injector.events) == 1
    assert all(torch.equal(got[k], v) for k, v in tree(2).items())


# --- the bf16 arms of bn_bwd and of the train z pass, on Hopper designs ----

BF16 = torch.bfloat16
#: ``Kernel`` of ``csrc/fused_bn.cu``: the backward's first pass (one or
#: two columns a lane) and its dx pass (one, four or eight).
BN_PLAN = {"P1": 4, "DX4": 5, "DX1": 6, "P2": 8, "DX8": 9}


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,offset,want", [
    (12544, 512, 0, ("P2", "DX8")),   # the block sites' width
    (130, 2048, 0, ("P2", "DX8")),    # smlp's hidden width
    (5000, 256, 0, ("P2", "DX8")),
    (777, 128, 0, ("P2", "DX8")),
    (1000, 64, 0, ("P2", "DX8")),
    (12544, 130, 0, ("P2", "DX1")),   # D % 4 != 0
    (300, 24, 1, ("P1", "DX1")),      # g and x 2 bytes off: today's arms
    (BIG_M, 4, 0, ("P2", "DX4")),     # more row ranges than grid.y takes
    (BIG_M, 8, 0, ("P2", "DX8")),
])
def test_bf16_bn_bwd_against_its_plain_version_at_ragged_shapes(m, d, offset,
                                                                 want):
    """bn_bwd at bf16 on the arms its plan names (two columns a lane in the
    first pass, eight in the dx pass where D % 8 == 0 and the operands are
    16-byte aligned): on dyadic inputs dx, dgamma and dbeta
    equal the plain version's bit for bit (every column sum exact, every
    element's arithmetic the plain version's); on Gaussian inputs dx within
    one bf16 rounding, dgamma and dbeta within 1e-5 of their scale, nan in
    dgamma where gamma is 0, two calls the same bits. An fp32 call of the
    same shape keeps the fp32 arms."""
    from repro_torch.kernels import fused_bn
    dev = _card()
    rng = np.random.default_rng(35)

    def operands(arrays, dtype):
        out = []
        for a in arrays:
            a = np.asarray(a, np.float32)
            if a.shape == (m, d):          # g and x at the case's offset
                flat = _t(np.concatenate([np.zeros(offset, np.float32),
                                          a.ravel()])).to(dev, dtype)
                a = flat[offset:].view(m, d)
            else:
                a = _t(a).to(dev)
            out.append(a)
        return out

    exact = operands(_dyadic_bn_bwd(rng, m, d), BF16)
    plans = [la.kernel for la in _plan_kernels(fused_bn.bn_bwd, *exact)]
    assert plans == [BN_PLAN[w] for w in want]
    got = fused_bn.bn_bwd(*exact)
    wanted = fused_bn.bn_bwd_plain(*exact)
    torch.cuda.synchronize()
    assert got[0].dtype == BF16
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, wanted):
        assert torch.equal(a, b), name
    fp32 = operands(_dyadic_bn_bwd(rng, m, d), torch.float32)
    assert [la.kernel for la in _plan_kernels(fused_bn.bn_bwd, *fp32)][0] == \
        BN_PLAN["P1"]
    del exact, fp32
    gauss = [rng.normal(size=(m, d)), rng.normal(0.5, 2.0, (m, d)),
             rng.uniform(0.5, 1.5, d)]
    gauss[2][::5] = 0.0
    g, x, gamma = operands(gauss, BF16)
    _, mu, sd = fused_bn.bn_fwd_plain(x, gamma, gamma)
    runs = [fused_bn.bn_bwd(g, x, gamma, mu, sd) for _ in range(2)]
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    dx, dgamma, dbeta = runs[0]
    wdx, wdgamma, wdbeta = fused_bn.bn_bwd_plain(g, x, gamma, mu, sd)
    torch.cuda.synchronize()
    err = (dx.float() - wdx.float()).abs()
    assert bool((err <= 1e-5 + 2.0 ** -7 * wdx.float().abs()).all())
    assert torch.equal(torch.isnan(dgamma), torch.isnan(wdgamma))
    assert bool(torch.isnan(dgamma[0, ::5]).all())
    ok = ~torch.isnan(wdgamma)
    for a, b in ((dgamma[ok], wdgamma[ok]), (dbeta, wdbeta)):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-5


#: ``Kernel`` of ``csrc/neuron_layer.cu``: the z pass on ``mma.sync`` and
#: on wgmma.
Z_MMA, Z_WGMMA = 4, 9
Z_SHAPES = [
    (4, 300, 256, 200),   # T*M % 192 != 0, K % 128 != 0
    (1, 777, 128, 64),    # T = 1, K < 128
    (4, 129, 520, 136),   # rows TMA cannot read (65 bytes): byte copies
    (4, 3136, 512, 512),  # pssa.qkv
]


@pytest.mark.cuda
@pytest.mark.parametrize("t,m,c,k", Z_SHAPES)
def test_bf16_train_z_pass_on_wgmma(t, m, c, k):
    """The bf16 z pass on the wgmma mainloop, where the rule sends it
    (bf16, more than 512 rows, a weight TMA can read): the forward, the
    split path's sums and the replay plan kernel 9, an fp32 weight kernel
    4. Ternary weights on rows of at most 12 spikes: z equals the fp32
    product, and the spikes, mu and var the plain version's, bit for bit.
    Gaussian weights: mu and var within 1e-5 of the plain version's scale,
    and the replay's spikes the emitted ones bit for bit."""
    from repro_torch.kernels import ops
    dev = _card()
    rng = np.random.default_rng(36)
    x = _t(_sparse_rows(rng, (t, m, c), ones=min(12, c))).to(dev, BF16)
    w = _t(rng.integers(-1, 2, (c, k)).astype(np.float32)).to(dev, BF16)
    gamma = _t(rng.uniform(0.8, 1.2, k).astype(np.float32)).to(dev)
    beta = _t(rng.normal(0.3, 0.2, k).astype(np.float32)).to(dev)
    for fn, args in ((neuron_layer.neuron_layer_train, (x, w, gamma, beta)),
                     (neuron_layer.neuron_layer_train_sums, (x, w)),
                     (neuron_layer.neuron_layer_train_z, (x, w))):
        assert _plan_kernels(fn, *args, packed=True)[0].kernel == Z_WGMMA
    assert neuron_layer.z_kernel(t * m, w, True) == Z_WGMMA
    assert _plan_kernels(neuron_layer.neuron_layer_train_z, x.float(),
                         w.float(), packed=True)[0].kernel == Z_MMA
    z = neuron_layer.neuron_layer_train_z(x, w, packed=True)
    got = neuron_layer.neuron_layer_train(x, w, gamma, beta, packed=True)
    want = neuron_layer.neuron_layer_train_plain(x, w, gamma, beta)
    torch.cuda.synchronize()
    assert torch.equal(z, torch.matmul(x.float(), w.float()))
    for name, a, b in zip(("spikes", "mu", "var"), got, want):
        assert torch.equal(a, b), name
    wg = _t((rng.normal(size=(c, k)) * 1.5 / c ** 0.5).astype(
        np.float32)).to(dev, BF16)
    xs = _t(_spikes(rng, (t, m, c), 0.2)).to(dev, BF16)
    s, mu, var, sd, xin = neuron_layer.neuron_layer_train_fwd(
        xs, wg, gamma, beta, packed=True)
    _, mu_p, var_p = neuron_layer.neuron_layer_train_plain(xs, wg, gamma,
                                                           beta)
    for a, b in ((mu, mu_p), (var, var_p)):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-5
    _, y = ops.replay_train_pre_activation(xs, xin, wg, gamma, beta, mu, sd,
                                           True)
    assert torch.equal(lif_soma.lif_soma_fwd(y)[0], s)


@pytest.mark.cuda
def test_the_z_wgmma_plan_twin():
    """``e2a_neuron_layer_train_plan`` at pssa.qkv in bf16: the z pass is
    plan kernel 9, 512 threads, the tile's shared memory (three 35 KB
    stages, three consumers' 32 KB z staging and 6 KB of column sums)
    with the opt-in, one persistent block an SM at most over the 192 x 128
    tiles; the statistics add one partial per 192-row tile."""
    _card()
    x = torch.zeros((4, 3136, 512), dtype=BF16, device="cuda")
    w = torch.zeros((512, 512), dtype=BF16, device="cuda")
    v = torch.zeros(512, device="cuda")
    la = _plan_kernels(neuron_layer.neuron_layer_train, x, w, v, v,
                       packed=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = -(-12544 // 192) * (512 // 128)
    assert [a.kernel for a in la] == [Z_WGMMA, 5, 7]
    assert la[0].block == (512, 1, 1) and la[0].opt_in
    assert la[0].smem == 3 * (128 * 128 * 2 + 192 * 16) + 3 * 64 * 128 * 4 \
        + 2 * 2 * 3 * 128 * 4 + 2 * 3 * 8 + 1024
    assert la[0].grid == (min(sms, tiles), 1, 1)
    assert la[0].extent[0] == tiles and la[0].strided[0] == (sms < tiles)
    assert neuron_layer.part_tiles(12544, Z_WGMMA) == -(-12544 // 192)


@pytest.mark.cuda
def test_the_z_pass_entry_refuses_a_kernel_it_cannot_take():
    """The wrappers name the first pass's kernel (``z_kernel``) and the
    entry point plans that one or refuses it, with no other in its place:
    the wgmma kernel on an fp32 weight or on one TMA cannot read, the
    dense arm's kernel on packed rows and an unknown code are refused; the
    ``mma.sync`` kernel on a bf16 weight the rule would send to wgmma
    still runs, and gives the wgmma kernel's z bit for bit on exact
    operands."""
    from repro_torch.kernels import build, dtype_code
    dev = _card()
    rng = np.random.default_rng(38)
    t, m, c, k = 4, 300, 256, 200
    x = _t(_sparse_rows(rng, (t, m, c), ones=12)).to(dev, BF16)
    xp = spike_matmul.spike_pack(x)
    w = _t(rng.integers(-1, 2, (c, k)).astype(np.float32)).to(dev, BF16)
    off = torch.zeros(c * k + 1, dtype=BF16, device=dev)[1:].view(c, k)
    lib = build.load()

    def z_pass(w, kernel):
        z = torch.full((t, m, k), float("nan"), device=dev)
        code = lib.e2a_neuron_layer_train_z(
            xp.data_ptr(), w.data_ptr(), z.data_ptr(), t, m, c, k, 1,
            kernel, dtype_code(w.dtype, "neuron_layer_train_z"),
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        return code, z
    for weight, kernel in ((w.float(), Z_WGMMA), (off, Z_WGMMA),
                           (w, neuron_layer.Z_DENSE), (w, 7)):
        assert z_pass(weight, kernel)[0] != 0, (weight.dtype, kernel)
    assert neuron_layer.z_kernel(t * m, w, True) == Z_WGMMA
    (ok_w, z_w), (ok_m, z_m) = z_pass(w, Z_WGMMA), z_pass(w, Z_MMA)
    assert ok_w == 0 and ok_m == 0
    assert torch.equal(z_w, z_m)
    assert torch.equal(z_w, torch.matmul(x.float(), w.float()))


@pytest.mark.cuda
def test_bf16_replay_reproduces_the_emitted_spikes_at_every_preset_site():
    """C1 at bf16: at every neuron-layer site of the preset the train op's
    backward replays the forward's z (the packed sites on the wgmma z pass,
    which the forward ran too) into the spikes the forward emitted, bit
    for bit, on Gaussian weights."""
    from repro_torch.kernels import ops
    dev = _card()
    rng = np.random.default_rng(37)
    for name, t, m, c, k, packed in _preset_sites():
        x = _t(_spikes(rng, (t, m, c), 0.2) if packed
               else rng.random((t, m, c), dtype=np.float32)).to(dev, BF16)
        w = _t((rng.normal(size=(c, k)) * (2.0 if packed else 1.0)
                / c ** 0.5).astype(np.float32)).to(dev, BF16)
        gamma = _t(rng.uniform(0.8, 1.2, k).astype(np.float32)).to(dev)
        beta = _t(rng.normal(0.3, 0.2, k).astype(np.float32)).to(dev)
        if packed:
            assert neuron_layer.z_kernel(t * m, w, True) == Z_WGMMA, name
        s, mu, _, sqrt_d, xin = neuron_layer.neuron_layer_train_fwd(
            x, w, gamma, beta, packed=packed)
        _, y = ops.replay_train_pre_activation(x, xin, w, gamma, beta, mu,
                                               sqrt_d, packed)
        replayed = lif_soma.lif_soma_fwd(y)[0]
        torch.cuda.synchronize()
        assert torch.equal(replayed, s), (name, int((replayed != s).sum()))
        assert 0.01 < float(s.float().mean()) < 0.99, name
        del x, s, y, replayed
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_bf16_split_neuron_layer_is_the_fused_path_at_a_world_of_one(
        world_of_one):
    """The split path at bf16 runs the forward's z pass (on wgmma at 1,200
    rows): spikes and statistics the fused path's bits at a world of 1."""
    dev, group = world_of_one.device, world_of_one.batch_group
    rng = np.random.default_rng(38)
    x = _t(_spikes(rng, (4, 300, 512))).to(dev, BF16)
    w = _t(rng.normal(0, 2 / 512 ** 0.5, (512, 136)).astype(
        np.float32)).to(dev, BF16)
    gamma = _t(rng.uniform(0.8, 1.2, 136).astype(np.float32)).to(dev)
    beta = _t(rng.normal(0.3, 0.2, 136).astype(np.float32)).to(dev)
    fused = neuron_layer.neuron_layer_train_fwd(x, w, gamma, beta,
                                                packed=True)
    split = neuron_layer.neuron_layer_train_fwd(x, w, gamma, beta,
                                                packed=True, group=group)
    assert all(torch.equal(a, b) for a, b in zip(fused[:4], split[:4]))


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(12544, 512), (777, 130), (1000, 64)])
def test_bf16_split_bn_bwd_is_the_fused_path_at_a_world_of_one(world_of_one,
                                                               m, d):
    """The split backward at bf16 (``bn_bwd_sums``, the all-reduce,
    ``bn_bwd_apply``) runs the fused path's pass kernels (two columns a
    lane in pass 1; at D % 8 == 0 eight in the dx pass): dx, dgamma and
    dbeta the fused path's bits at a world of 1."""
    from repro_torch.kernels import fused_bn
    dev, group = world_of_one.device, world_of_one.batch_group
    rng = np.random.default_rng(m + d)
    x = _t(rng.normal(0.5, 2.0, (m, d)).astype(np.float32)).to(dev, BF16)
    g = _t(rng.normal(0, 1, (m, d)).astype(np.float32)).to(dev, BF16)
    gamma = _t(rng.uniform(0.5, 1.5, d).astype(np.float32)).to(dev)
    _, mu, sd = fused_bn.bn_fwd(x, gamma, gamma)
    fused = fused_bn.bn_bwd(g, x, gamma, mu, sd)
    split = fused_bn.bn_bwd(g, x, gamma, mu, sd, group)
    torch.cuda.synchronize()
    assert fused[0].dtype == BF16
    assert all(torch.equal(a, b) for a, b in zip(fused, split))


#: ``Kernel`` of ``csrc/neuron_layer.cu``: the bf16 eval arm on wgmma, and
#: the tile code of ``e2a_neuron_layer_eval`` that asks for it.
EVAL_WGMMA, EVAL_TILE_WGMMA = 10, 3
EVAL_WGMMA_SHAPES = [
    (1, 128, 128, 128),    # one unit, T = 1
    (4, 600, 256, 256),    # T = 4, M % 128 != 0
    (8, 530, 264, 136),    # T = 8; M, K, C ragged; rows of 33 bytes
    (2, 700, 520, 136),    # rows of 65 bytes: the producer's byte copies
    (3, 777, 576, 128),    # tokenizer.conv.1's 72-byte rows
    (5, 513, 64, 24),      # K < 64, C < 128
    (6, 1100, 1152, 256),  # tokenizer.conv.2's rows (144 bytes, by TMA)
    (7, 640, 128, 2048),   # K = 2048, as smlp.a
]


def _eval_operands(rng, t, m, c, k):
    x = _t(_spikes(rng, (t, m, c), 0.25)).to("cuda", BF16)
    w = _t((rng.integers(-4, 5, (c, k)) / 64).astype(np.float32)).to(
        "cuda", BF16)
    b = _t(rng.normal(0.9, 0.1, k).astype(np.float32)).to("cuda")
    return x, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("t,m,c,k", EVAL_WGMMA_SHAPES)
def test_bf16_eval_on_wgmma(t, m, c, k):
    """The bf16 eval kernel on the wgmma mainloop (tile code 3, plan kernel
    10), forced at every shape and taken by the wrapper's rule above 512
    rows a step. Exact weights (k/64, |k| <= 4: every fp32 sum exact): the
    spikes equal the plain version's and the one-plane arm's bit for bit.
    Gaussian weights: the spikes equal the plain SOMA's on the wgmma z
    pass's fp32 product plus the bias (the same mainloop, the same sums in
    the same order) bit for bit where the z pass runs on wgmma, and are
    within 1e-3 of the plain version's."""
    dev = _card()
    rng = np.random.default_rng(36 + t)
    x, w, b = _eval_operands(rng, t, m, c, k)
    xp = spike_matmul.spike_pack(x)

    def launch(w, tile):
        return neuron_layer._launch_neuron_layer_eval(
            xp, w, b, t, m, c, k, True, 0.5, 1.0, tile=tile)
    assert [la.kernel for la in _plan_kernels(
        launch, w, EVAL_TILE_WGMMA)] == [EVAL_WGMMA]
    if m > 512:
        assert neuron_layer.eval_kernel(m, w) == EVAL_TILE_WGMMA
        assert [la.kernel for la in _plan_kernels(
            neuron_layer.neuron_layer_eval, x, w, b, packed=True)] == \
            [EVAL_WGMMA]
    got = launch(w, EVAL_TILE_WGMMA)
    plain = neuron_layer.neuron_layer_eval_plain(x, w, b)
    one_plane = launch(w, 0)
    torch.cuda.synchronize()
    assert got.dtype == BF16 and got.shape == (t, m, k)
    assert torch.equal(got, plain)
    assert torch.equal(got, one_plane)
    if m > 512:
        assert torch.equal(neuron_layer.neuron_layer_eval(x, w, b,
                                                          packed=True), got)
    assert 0.02 < float(got.float().mean()) < 0.98
    wg = _t((rng.normal(size=(c, k)) * 2 / c ** 0.5).astype(np.float32)).to(
        dev, BF16)
    got = launch(wg, EVAL_TILE_WGMMA)
    plain = neuron_layer.neuron_layer_eval_plain(x, wg, b)
    torch.cuda.synchronize()
    assert float((got != plain).float().mean()) <= 1e-3
    if neuron_layer.z_kernel(t * m, wg, True) == neuron_layer.Z_WGMMA:
        z = neuron_layer.neuron_layer_train_z(x, wg, packed=True)
        exact = lif_soma.lif_soma_fwd_plain(z + b)[0].to(BF16)
        torch.cuda.synchronize()
        assert torch.equal(got, exact)


@pytest.mark.cuda
def test_the_eval_wgmma_plan_twin():
    """``e2a_neuron_layer_eval_plan`` at pssa.qkv and smlp.a in bf16: plan
    kernel 10, 384 threads (a producer and two consumer warpgroups), four
    34 KB stages, two consumers' 16 KB spike staging and bias copies with
    the opt-in, one persistent block an SM at most over the 128 x 128 units
    of a time step's rows (each walks the T steps); fp32 keeps the Large
    ``mma.sync`` tile."""
    _card()
    x = torch.zeros((4, 3136, 512), dtype=BF16, device="cuda")
    v = torch.zeros(2048, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k, units in ((512, 100), (2048, 400)):
        w = torch.zeros((512, k), dtype=BF16, device="cuda")
        (la,) = _plan_kernels(neuron_layer.neuron_layer_eval, x, w, v[:k],
                              packed=True)
        assert la.kernel == EVAL_WGMMA
        assert la.block == (384, 1, 1) and la.opt_in
        assert la.smem == 4 * (128 * 128 * 2 + 128 * 16) + \
            2 * (64 * 128 * 2 + 128 * 4) + 2 * 4 * 8 + 1024
        assert la.grid == (min(sms, units), 1, 1)
        assert la.tile[0] == 1 and la.extent[0] == units
        assert la.strided[0] == (sms < units)
    w = torch.zeros((512, 512), device="cuda")
    (la,) = _plan_kernels(neuron_layer.neuron_layer_eval, x.float(), w,
                          v[:512], packed=True)
    assert la.kernel == (1 if 13 * 8 <= sms else 2)   # eval_tile's rule


@pytest.mark.cuda
def test_the_eval_entry_refuses_tile_3_it_cannot_take():
    """Tile code 3 on an fp32 weight, on a weight TMA cannot read or on a
    dense input is refused (the plan twin too), with no other kernel in
    its place, and the wrapper raises; tile code 4 is refused."""
    from repro_torch.kernels import build, dtype_code
    dev = _card()
    rng = np.random.default_rng(39)
    t, m, c, k = 2, 600, 256, 128
    x, w, b = _eval_operands(rng, t, m, c, k)
    xp = spike_matmul.spike_pack(x)
    off = torch.zeros(c * k + 1, dtype=BF16, device=dev)[1:].view(c, k)
    off.copy_(w)
    lib = build.load()
    records = (build.ctypes.c_longlong * (build.MAX_LAUNCHES
                                           * build.PLAN_FIELDS))()
    for xin, weight, packed, tile in ((xp, w.float(), 1, 3), (xp, off, 1, 3),
                                      (x, w, 0, 3), (xp, w, 1, 4)):
        s = torch.full((t, m, k), 7.0, dtype=weight.dtype, device=dev)
        args = (xin.data_ptr(), weight.data_ptr(), b.data_ptr(),
                s.data_ptr(), t, m, c, k, packed, tile, 0.5, 1.0,
                dtype_code(weight.dtype, "neuron_layer_eval"))
        assert lib.e2a_neuron_layer_eval(
            *args, torch.cuda.current_stream().cuda_stream) == 1
        assert lib.e2a_neuron_layer_eval_plan(
            *args, records, build.MAX_LAUNCHES) == -1
        torch.cuda.synchronize()
        assert bool((s == 7.0).all())
    with pytest.raises(RuntimeError, match="neuron_layer_eval"):
        neuron_layer._launch_neuron_layer_eval(
            xp, w.float(), b, t, m, c, k, True, 0.5, 1.0,
            tile=EVAL_TILE_WGMMA)
    assert neuron_layer.eval_kernel(m, off) == 0


# ---------------------------------------------------------------------------
# The spike pack (csrc/spike_pack.cu): the pack of every packed arm
# ---------------------------------------------------------------------------

def _pack_views(dev, dtype, gen) -> dict[str, torch.Tensor]:
    """Spikes at rate 0.2 at the seven packed calls' shapes of
    ``spikingformer-8-512`` at batch 16 (T = 4, 196 tokens, d 512, d_ff
    2048, 8 heads), each laid out as the model hands it to the pack."""
    def s(*shape):
        return (torch.rand(shape, generator=gen, device=dev) < 0.2).to(dtype)

    t, b, n, d = 4, 16, 196, 512
    m = b * n
    q = s(t, b, n, d).reshape(t, b, n, 8, 64).permute(0, 1, 3, 2, 4)
    return {"pssa.qkv/smlp.a": s(t, m, d), "pssa.proj": s(t * m, d),
            "smlp.b": s(t * m, 4 * d),
            "attn_qk": q.reshape(t * b, 8, n, 64),
            "tokenizer.conv.1": s(t, b * 56 * 56, 9 * 64),
            "tokenizer.conv.2": s(t, b * 28 * 28, 9 * 128),
            "tokenizer.conv.3": s(t, m, 9 * 256)}


def _pack_edges(dev, dtype, gen) -> dict[str, tuple[torch.Tensor, int]]:
    """Layouts off the main path and the path each takes."""
    def s(*shape):
        return (torch.rand(shape, generator=gen, device=dev) < 0.3).to(dtype)

    vec, sca = spike_matmul.PACK_VECTOR, spike_matmul.PACK_SCALAR
    return {"ragged C=520": (s(3, 700, 520), vec),
            "one row": (s(1, 64), vec),
            "odd rows, C=8": (s(4097, 8), vec),
            "expanded": (s(1, 300, 128).expand(3, 300, 128), vec),
            "(T, B, h, N, dh) view": (s(2, 3, 49, 256).reshape(
                2, 3, 49, 4, 64).permute(0, 1, 3, 2, 4), vec),
            "row pitch off 16 bytes": (s(700, 76)[:, :72],
                                       sca if dtype == BF16 else vec),
            "C stride 2": (s(3, 700, 256)[..., ::2], sca),
            "unaligned start": (s(700 * 72 + 1)[1:].view(700, 72), sca),
            "transposed": (s(512, 300).t(), sca)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_spike_pack_at_the_main_path_shapes(dtype):
    """One launch a call, bit for bit the plain pack and the oracle, the
    result contiguous, on the vector path."""
    from repro_torch.kernels import ref
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(41)
    for case, x in _pack_views(dev, dtype, gen).items():
        reset_launch_counts()
        got = spike_matmul.spike_pack(x)
        assert launch_counts()["spike_pack"] == 1, case
        torch.cuda.synchronize()
        assert got.is_contiguous() and got.dtype == torch.uint8, case
        assert torch.equal(got, spike_matmul.spike_pack_plain(x)), case
        assert torch.equal(got, ref.spike_pack_ref(x)), case
        assert spike_matmul.pack_path(x) == spike_matmul.PACK_VECTOR, case


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_spike_pack_on_strided_and_ragged_layouts(dtype):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(42)
    for case, (x, path) in _pack_edges(dev, dtype, gen).items():
        assert spike_matmul.pack_path(x) == path, case
        got = spike_matmul.spike_pack(x)
        torch.cuda.synchronize()
        assert torch.equal(got, spike_matmul.spike_pack_plain(x)), case
    empty = torch.zeros(0, 64, dtype=dtype, device=dev)
    assert spike_matmul.spike_pack(empty).shape == (0, 8)


@pytest.mark.cuda
def test_spike_pack_refusals_on_the_card():
    """fp16 and other dtypes raise ``TypeError``, a ragged C
    ``ValueError``; the entry point refuses the vector path on a layout it
    cannot read, and a path code it does not know, launching nothing."""
    from repro_torch.kernels import build
    dev = _card()
    for dt in (torch.float16, torch.float64, torch.uint8):
        with pytest.raises(TypeError, match="spike_pack"):
            spike_matmul.spike_pack(torch.zeros(4, 16, dtype=dt, device=dev))
    with pytest.raises(ValueError, match="multiple of 8"):
        spike_matmul.spike_pack(torch.zeros(4, 12, device=dev))
    x = torch.ones(64, 33, device=dev).t()[:32]          # C stride 33
    out = torch.full((32, 8), 7, dtype=torch.uint8, device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream().cuda_stream
    for path in (spike_matmul.PACK_VECTOR, 0, 3):
        assert lib.e2a_spike_pack(x.data_ptr(), out.data_ptr(), 1, 1, 32, 64,
                                  0, 0, 1, 33, path, 0, stream) != 0
    torch.cuda.synchronize()
    assert bool((out == 7).all())


@pytest.mark.cuda
def test_every_packed_call_launches_the_pack():
    """The packed arms pack through the kernel, once a call; the backward's
    replay reads the packed input its forward kept and packs nothing."""
    from repro_torch.kernels import conv_spike
    dev = _card()
    rng = np.random.default_rng(43)
    x = _t(_spikes(rng, (2, 70, 64))).to(dev)
    w = _t(_dyadic(rng, (64, 24))).to(dev)
    v = torch.ones(24, device=dev)
    calls = (
        lambda: neuron_layer.neuron_layer_eval(x, w, v, packed=True),
        lambda: neuron_layer.neuron_layer_train_fwd(x, w, v, v, packed=True),
        lambda: neuron_layer.neuron_layer_train_z(x, w, packed=True),
        lambda: spike_matmul.spike_matmul(x[0], w),
        lambda: spike_matmul.spike_matmul_batched(x, w.expand(2, 64, 24)),
        lambda: conv_spike.spike_patch_matmul(x, w))
    for call in calls:
        reset_launch_counts()
        call()
        assert launch_counts()["spike_pack"] == 1
    xin = spike_matmul.spike_pack(x)
    reset_launch_counts()
    neuron_layer.neuron_layer_train_z(x, w, packed=True, xin=xin)
    neuron_layer.neuron_layer_eval(x, w, v, packed=False)
    assert launch_counts()["spike_pack"] == 0
