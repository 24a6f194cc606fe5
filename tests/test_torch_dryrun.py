"""The dry run (``repro_torch.launch.dryrun``) and ``launch.specs.
input_specs`` against the reference and against real steps on the CPU:
the collective counter on hand-made calls, ``model_flops`` for every
assigned cell, ``input_specs``' structs and specs for each family at
reduced widths, the kernel wrappers' ``meta`` branches (no plain version,
no launch), the live-bytes tracker, two reduced cells on a fake (data 4,
model 1) mesh (collectives against the specs and against the same step
run for real on the CPU, flops against ``FlopCounterMode`` of the real
step, no process group left behind), the model-axis meshes refused, and
the perf driver's pixtral variants on a model axis of 1; on ``pod16x16``
an MoE cell's all-to-all and a flash-decode cell's collectives."""
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_spikingformer_config
from repro_torch.configs import registry as treg
from repro_torch.core.lif import LIFConfig
from repro_torch.core.policy import named_policy
from repro_torch.kernels import (fused_bn, launch_counts, lif_soma,
                                 neuron_layer, spike_matmul)
from repro_torch.launch import dryrun, perf
from repro_torch.launch.mesh import AbstractMesh, Mesh
from repro_torch.launch.specs import SHAPES, ShapeSpec, input_specs
from repro_torch.train.checkpoint import _flatten_with_paths

META = torch.device("meta")


@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` as it was (the
    module sets the flag for its own 512-device runs)."""
    before = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as ref
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return ref


def _mesh4(device=META) -> Mesh:
    return Mesh((4, 1), ("data", "model"), torch.device(device))


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

def test_collective_counter_kinds_and_bytes():
    """Each kind's bytes are those of its result, as the reference's HLO
    parser counts them (``tests/test_launch_helpers.py``)."""
    def calls():
        x = torch.empty(128, 256, device=META)
        dist.all_gather_into_tensor(torch.empty(512, 256, device=META), x)
        dist.all_reduce(torch.empty(1024, dtype=torch.bfloat16, device=META))
        dist.reduce_scatter_tensor(torch.empty(32, 256, device=META), x)
        dist.all_to_all_single(
            torch.empty(16, 32, dtype=torch.bfloat16, device=META),
            torch.empty(16, 32, dtype=torch.bfloat16, device=META))
        torch.add(x, x)                       # not a collective

    with dryrun.fake_world(4):
        out = dryrun.collective_bytes(calls)
    assert out == {"all-gather": 512 * 256 * 4, "all-reduce": 1024 * 2,
                   "reduce-scatter": 32 * 256 * 4, "all-to-all": 16 * 32 * 2}
    assert not dist.is_initialized()


def test_live_bytes_tracker():
    """Storages counted once (views share theirs), rounded up to 512
    bytes, freed when the last tensor goes; the inputs held from the
    start; in-place results add nothing."""
    counter = dryrun.StepCounter()
    x = torch.empty(100, device=META)                 # 400 -> 512 bytes
    inputs = (x, {"y": x[:10]})
    with counter:
        assert counter.hold(inputs) == 512
        a = torch.empty(1000, device=META)            # 4,000 -> 4,096
        b = torch.empty(2000, device=META)            # 8,000 -> 8,192
        b.add_(1.0)
        _ = b.view(40, 50)
        del a
        c = torch.empty(10, device=META)              # 40 -> 512
        assert counter.live == 512 + 8192 + 512
        del b, c, _
    assert counter.peak == 512 + 4096 + 8192
    assert counter.live == 512


def test_tensor_bytes_counts_a_broadcast_dim_once():
    w = torch.empty(64, 32, device=META)
    assert dryrun.tensor_bytes(w.expand(4, 64, 32)) == 64 * 32 * 4
    assert dryrun.tensor_bytes(w.t()) == 64 * 32 * 4


def test_h100_constants_and_rules():
    assert (dryrun.PEAK_FLOPS, dryrun.PEAK_FLOPS_FP32, dryrun.HBM_BW,
            dryrun.HBM_BYTES) == (989e12, 67e12, 3.35e12, 80e9)
    assert dryrun.peak_flops(torch.bfloat16) == 989e12
    assert dryrun.peak_flops(torch.float32) == 67e12
    assert dryrun.link_bw(8) == dryrun.ICI_BW == 450e9
    assert dryrun.link_bw(16) == dryrun.IB_BW == 50e9


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", treg.ASSIGNED)
def test_model_flops_equals_the_reference(ref_dryrun, arch):
    from repro.configs.registry import get_config as j_get_config
    for shape in dryrun.cells_for(arch):
        got = dryrun.model_flops(treg.get_config(arch), shape)
        want = ref_dryrun.model_flops(j_get_config(arch), shape)
        assert got == want, (arch, shape)
    assert dryrun.cells_for(arch) == ref_dryrun.cells_for(arch)


@dataclasses.dataclass(frozen=True)
class _StubMesh:
    """What the reference's ``input_specs`` reads of a mesh."""
    axis_names: tuple
    axis_sizes: tuple

    @property
    def devices(self):
        return np.empty(self.axis_sizes)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.axis_sizes))


def _leaves(tree, spec_leaves=False) -> dict:
    return {k: v for k, v in _flatten_with_paths(tree, spec_leaves=spec_leaves)
            if v is not None}


def _j_leaves(tree) -> dict:
    import jax
    from repro.models.common import spec_is_leaf
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: spec_is_leaf(x) or x is None)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): v for path, v in flat if v is not None}


def _same_specs(got, want, cfg_name):
    import jax.numpy as jnp
    gs, ws = _leaves(got[1]), _j_leaves(want[1])
    assert set(gs) == set(ws), cfg_name
    for k, w in ws.items():
        g = gs[k]
        assert tuple(g.shape) == tuple(w.shape), (cfg_name, k)
        assert str(g.dtype).split(".")[-1] == str(jnp.dtype(w.dtype)), \
            (cfg_name, k, g.dtype, w.dtype)
    gp, wp = _leaves(got[2], True), _j_leaves(want[2])
    assert set(gp) == set(wp), cfg_name
    for k, w in wp.items():
        assert repr(gp[k]) == repr(w), (cfg_name, k, gp[k], w)


FAMILY_ARCHS = ["qwen3-0.6b", "mixtral-8x7b", "deepseek-v2-236b", "rwkv6-7b",
                "zamba2-2.7b", "whisper-large-v3", "pixtral-12b"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_input_specs_equal_the_reference(ref_dryrun, arch):
    """Every shape's structs (shapes, dtypes) and printed specs at
    ``reduced()`` widths on a (4, 1) mesh, leaf for leaf."""
    from repro.configs.registry import get_config as j_get_config
    from repro.configs.registry import reduced as j_reduced
    from repro.launch.specs import input_specs as j_input_specs
    tcfg = treg.reduced(treg.get_config(arch))
    jcfg = j_reduced(j_get_config(arch))
    names, sizes = ("data", "model"), (4, 1)
    for shape in SHAPES:
        if shape == "long_500k" and not tcfg.subquadratic:
            continue
        got = input_specs(tcfg, shape, AbstractMesh(names, sizes))
        want = j_input_specs(jcfg, shape, _StubMesh(names, sizes))
        assert len(got[1]) == len(want[1])
        for i in range(len(want[1])):
            _same_specs((None, got[1][i], got[2][i]),
                        (None, want[1][i], want[2][i]), f"{arch} {shape} {i}")


def test_vision_input_specs_equal_the_reference(ref_dryrun):
    from repro.configs.spikingformer import get_spikingformer_config as jsf
    from repro.launch.specs import _vision_input_specs as j_vision
    names, sizes = ("data", "model"), (4, 1)
    sh = SHAPES["train_4k"]
    got = input_specs(get_spikingformer_config("spikingformer-smoke"),
                      "train_4k", AbstractMesh(names, sizes))
    want = j_vision(jsf("spikingformer-smoke"), sh, _StubMesh(names, sizes),
                    ("data",))
    for i in range(5):
        _same_specs((None, got[1][i], got[2][i]),
                    (None, want[1][i], want[2][i]), f"vision {i}")
    with pytest.raises(ValueError, match="train-only"):
        input_specs(get_spikingformer_config("spikingformer-smoke"),
                    "decode_32k", AbstractMesh(names, sizes))


# ---------------------------------------------------------------------------
# The kernel wrappers on meta
# ---------------------------------------------------------------------------

def _refuse(*_, **__):
    raise AssertionError("a plain version ran on meta tensors")


def test_meta_branches_allocate_the_kernels_outputs(monkeypatch):
    """On ``meta`` every wrapper returns its kernel's outputs without its
    plain version and without a launch, and reports the site."""
    for mod, name in ((lif_soma, "lif_soma_fwd_plain"),
                      (lif_soma, "lif_soma_bwd_plain"),
                      (fused_bn, "bn_fwd_plain"), (fused_bn, "bn_bwd_plain"),
                      (spike_matmul, "spike_matmul_packed_plain"),
                      (spike_matmul, "spike_pack_plain"),
                      (neuron_layer, "neuron_layer_eval_plain"),
                      (neuron_layer, "_train_plain"),
                      (neuron_layer, "neuron_layer_train_z_plain")):
        monkeypatch.setattr(mod, name, _refuse)
    counts = launch_counts()
    t, m, c, k = 4, 24, 16, 8
    x = torch.empty(t, m, k, device=META)
    sites = {}
    counter = dryrun.StepCounter()
    with counter:
        s, u, mask, ul, sl = lif_soma.lif_soma_fwd(
            x, torch.empty(m, k, device=META), torch.empty(m, k, device=META))
        assert [a.shape for a in (s, u, mask, ul, sl)] == [x.shape] * 3 + \
            [(m, k)] * 2
        assert lif_soma.lif_soma_bwd(x, x, x, x).shape == x.shape
        y, mu, sd = fused_bn.bn_fwd(torch.empty(m, k, device=META),
                                    torch.empty(k, device=META),
                                    torch.empty(k, device=META))
        assert (y.shape, mu.shape, sd.shape) == ((m, k), (1, k), (1, k))
        dx, dg, db = fused_bn.bn_bwd(y, y, torch.empty(k, device=META), mu, sd)
        assert (dx.shape, dg.shape, db.shape) == ((m, k), (1, k), (1, k))
        packed = torch.empty(m, c // 8, dtype=torch.uint8, device=META)
        w = torch.empty(c, k, device=META)
        assert spike_matmul.spike_matmul_packed(packed, w).shape == (m, k)
        assert spike_matmul.spike_matmul_packed_batched(
            packed.expand(3, m, c // 8), w.expand(3, c, k)).shape == (3, m, k)
        xs = torch.empty(t, m, c, device=META)
        vec = torch.empty(k, device=META)
        for packed_arm in (False, True):
            assert neuron_layer.neuron_layer_eval(
                xs, w, vec, packed=packed_arm).shape == (t, m, k)
            out = neuron_layer.neuron_layer_train_fwd(xs, w, vec, vec,
                                                      packed=packed_arm)
            assert [tuple(a.shape) for a in out[:4]] == [(t, m, k)] + \
                [(1, k)] * 3
            assert (out[4] is None) != packed_arm
            assert neuron_layer.neuron_layer_train_z(
                xs, w, packed=packed_arm).shape == (t, m, k)
        with pytest.raises(ValueError, match="time steps"):
            neuron_layer.neuron_layer_eval(
                torch.empty(9, m, c, device=META), w, vec)
    sites = counter.kernel_sites
    assert launch_counts() == counts
    assert sites == {"lif_soma_fwd": 1, "lif_soma_bwd": 1, "bn_fwd": 1,
                     "bn_bwd": 1, "spike_matmul_packed": 1,
                     "spike_matmul_packed_batched": 1,
                     "neuron_layer_eval": 2, "neuron_layer_train": 4,
                     "spike_pack": 3}
    assert counter.kernel_flops["spike_matmul_packed"] == 2 * m * c * k
    assert counter.kernel_flops["spike_matmul_packed_batched"] == \
        3 * 2 * m * c * k
    assert counter.kernel_flops["neuron_layer_train"] == 4 * 2 * t * m * c * k


# ---------------------------------------------------------------------------
# Reduced cells on a fake (data 4, model 1) mesh
# ---------------------------------------------------------------------------

def _real(tree, gen):
    """CPU tensors of ``tree``'s meta shapes and dtypes."""
    if isinstance(tree, dict):
        return {k: _real(v, gen) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_real(v, gen) for v in tree)
    if tree.dtype.is_floating_point:
        return torch.randn(tree.shape, generator=gen, dtype=tree.dtype)
    return torch.zeros(tree.shape, dtype=tree.dtype)


def _pack_flops(monkeypatch):
    """Inside, the CPU's plain spike pack counts the flops of its bit-weight
    product in ``out[0]``: the card's pack kernel forms no product, and its
    ``meta`` site reports none."""
    real = spike_matmul.spike_pack_plain
    out = [0]

    def counted(spikes):
        with FlopCounterMode(display=False) as f:
            packed = real(spikes)
        out[0] += f.get_total_flops()
        return packed

    monkeypatch.setattr(spike_matmul, "spike_pack_plain", counted)
    return out


def _counted(cfg, shape, monkeypatch):
    """The dry run's counts of the cell on a fake (4, 1) mesh, and the
    same step's flops (``FlopCounterMode``, less the plain spike pack's,
    :func:`_pack_flops`) and collectives run for real on CPU tensors of the
    rank's shapes."""
    with dryrun.fake_world(4):
        fn, structs, specs = input_specs(cfg, shape, _mesh4())
        args = dryrun.shard_args(structs, specs, _mesh4())
        counts = dryrun.count_step(fn, args)
    with dryrun.fake_world(4):
        mesh = _mesh4("cpu")
        fn, structs, specs = input_specs(cfg, shape, mesh)
        args = _real(dryrun.shard_args(structs, specs, mesh),
                     torch.Generator().manual_seed(0))
        with monkeypatch.context() as mp:
            pack = _pack_flops(mp)
            with FlopCounterMode(display=False) as real:
                coll = dryrun.collective_bytes(fn, *args)
    assert not dist.is_initialized()
    return counts, real.get_total_flops() - pack[0], coll, structs, specs


def _lm_cfg(policy):
    # vocab 2^14 x d 64 = 2^20 elements: the embedding is FSDP'd
    return treg.reduced(treg.get_config("qwen3-0.6b")).replace(
        vocab_size=1 << 14, lif=LIFConfig(policy=named_policy(policy)))


def test_lm_train_cell_on_a_fake_mesh(monkeypatch):
    shape = ShapeSpec("train", 16, 8)
    counts, flops, coll, structs, specs = _counted(_lm_cfg("cuda-full"),
                                                   shape, monkeypatch)
    assert counts["collectives"] == coll
    # the collectives from the specs: one all-gather of each FSDP'd leaf
    # (its whole bytes) and one reduce-scatter of its gradient (its shard),
    # one all-reduce of each replicated leaf's gradient; then the step's
    # scalars, one fp32 each: the loss's metrics, the leaves' squared norms
    # and the non-finite flag
    p_struct, p_specs = structs[0], specs[0]
    leaves = _leaves(p_struct)
    sp = _leaves(p_specs, True)
    nbytes = {k: v.numel() * v.element_size() for k, v in leaves.items()}
    fsdp = [k for k in leaves if "data" in tuple(sp[k])]
    assert fsdp, "no FSDP'd leaf: the check needs one"
    assert coll["all-gather"] == sum(nbytes[k] for k in fsdp)
    assert coll["reduce-scatter"] == sum(nbytes[k] // 4 for k in fsdp)
    from repro_torch.models.lm import lm_loss
    metrics = lm_loss(p_struct, structs[2], _lm_cfg("cuda-full"))[1]
    assert coll["all-reduce"] == sum(nbytes[k] for k in leaves
                                     if k not in fsdp) + \
        4 * (len(metrics) + len(leaves) + 1)
    # flops: the same step for real on the CPU, under cuda-full (plain
    # versions) and under eager (the LIF forms no product)
    assert counts["flops"] == flops
    eager, eager_flops = _counted(_lm_cfg("eager"), shape, monkeypatch)[:2]
    assert eager["flops"] == eager_flops == flops
    assert counts["kernel_sites"] == {"lif_soma_fwd": 4, "lif_soma_bwd": 4}
    assert eager["kernel_sites"] == {}
    assert counts["peak"] > counts["argument"] > 0


def test_vision_train_cell_on_a_fake_mesh(monkeypatch):
    shape = ShapeSpec("train", 0, 8)
    cfg = get_spikingformer_config("spikingformer-smoke@cuda-full")
    counts, flops, coll, _, _ = _counted(cfg, shape, monkeypatch)
    # the BN sites' split-path all-reduces, the gradients' and the
    # scalars', as the plain versions make them on the CPU
    assert counts["collectives"] == coll and coll["all-reduce"] > 0
    assert counts["flops"] == flops
    eager, eager_flops = _counted(
        get_spikingformer_config("spikingformer-smoke@eager"), shape,
        monkeypatch)[:2]
    assert eager["flops"] == eager_flops and eager["kernel_sites"] == {}
    # the policies' steps form other products: cuda-full replays each
    # neuron layer's product in its backward (the second half of its
    # kernel sites), which eager's autograd does not
    assert counts["flops"] > eager_flops
    assert counts["kernel_sites"]["neuron_layer_train"] % 2 == 0


def test_hybrid_decode_regathers_the_mamba_state():
    """The plan shards the hybrid's Mamba2 state over "data" on a feature
    dim (its batch sits on axis 2): the decode step gathers each such leaf
    whole, one all-gather of its bytes, and runs on the rank's rows."""
    from repro_torch.launch.mesh import batch_dim
    from repro_torch.models.lm import cache_batch_axes
    cfg = treg.reduced(treg.get_config("zamba2-2.7b"))
    shape = ShapeSpec("decode", 64, 8)
    with dryrun.fake_world(4):
        mesh = _mesh4()
        fn, structs, specs = input_specs(cfg, shape, mesh)
        counts = dryrun.count_step(fn, dryrun.shard_args(structs, specs,
                                                         mesh))
        c_struct, c_specs = structs[1], specs[1]
        axes = _leaves(cache_batch_axes(cfg, c_struct))
        sp = _leaves(c_specs, True)
        moved = [k for k, leaf in _leaves(c_struct).items()
                 if batch_dim(sp[k], mesh) not in (None, axes[k])]
    assert moved and all(k.startswith("mamba/") for k in moved)
    assert counts["collectives"] == {"all-gather": sum(
        _leaves(c_struct)[k].numel() * _leaves(c_struct)[k].element_size()
        for k in moved)}


def test_run_cell_writes_the_reference_keys(tmp_path, monkeypatch):
    """A reduced cell through ``run_cell``: the reference's keys plus
    ``fits``; nothing left initialised."""
    arch = "qwen3-0.6b"
    small = treg.reduced(treg.get_config(arch))
    monkeypatch.setattr(treg, "get_config", lambda name: small)
    with dryrun.fake_world(4):
        r = dryrun.run_cell(arch, "decode_32k", _mesh4(), "fake4",
                            str(tmp_path))
    assert not dist.is_initialized()
    assert os.path.exists(tmp_path / f"{arch}__decode_32k.json")
    keys = {"arch", "shape", "mesh", "devices", "compile_s",
            "bytes_per_device", "hlo_flops_per_device",
            "hlo_bytes_per_device", "collective_bytes_per_device",
            "roofline", "model_flops_global", "model_flops_per_device",
            "useful_flops_ratio"}
    assert keys <= set(r) and r["fits"] is True
    assert set(r["bytes_per_device"]) == {"argument", "output", "temp",
                                          "peak"}
    assert r["bytes_per_device"]["temp"] == \
        r["bytes_per_device"]["peak"] - r["bytes_per_device"]["argument"]
    assert r["model_flops_global"] == dryrun.model_flops(small, "decode_32k")


def test_model_axis_meshes_raise_naming_a11c(tmp_path, capsys):
    """The model-axis meshes give their shapes; a "heads" cell
    (``deepseek-7b`` x ``decode_32k`` on ``pod16x16``: 32 kv heads over
    16) runs on ``meta`` with the rank's heads and the model group's
    collectives counted; a flash-decode cell (``qwen3-0.6b``'s 8 kv heads
    over 16: the seq-sharded cache) is counted too, and so is
    ``rwkv6-7b`` x ``decode_32k``, once counted apart as ROADMAP A11c-2b:
    each an ``[ok]`` row of the command line, the summary counting ok and
    failed cells only."""
    assert dryrun.mesh_shape("pod16x16") == (("data", "model"), (16, 16))
    assert dryrun.mesh_shape("pod2x16x16") == (("pod", "data", "model"),
                                               (2, 16, 16))
    assert dryrun.mesh_shape("data16") == (("data", "model"), (16, 1))
    assert dryrun.mesh_shape("pod2xdata16") == (("pod", "data", "model"),
                                                (2, 16, 1))
    r = dryrun.dry_run_cell("deepseek-7b", "decode_32k", "pod16x16",
                            str(tmp_path))
    assert r["devices"] == 256 and r["fits"] is True
    assert r["collective_bytes_per_device"]["all-reduce"] > 0
    # the rank's cache (8 rows x 32768 x 2 of 32 kv heads x 128, bf16, 30
    # layers, k and v) and its rows' logits gathered whole (fp32)
    assert r["bytes_per_device"]["output"] == 8 * 32768 * 2 * 128 * 2 * \
        30 * 2 + 8 * 102400 * 4
    assert not dist.is_initialized()
    dryrun.main(["--arch", "rwkv6-7b", "--shape", "decode_32k",
                 "--mesh", "pod16x16", "--out", str(tmp_path)])
    dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                 "--mesh", "pod16x16", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[ok] rwkv6-7b x decode_32k" in out
    assert "[ok] qwen3-0.6b x decode_32k" in out
    assert out.count("dry-run complete: 1 ok, 0 failed") == 2
    assert "A11c-2b" not in out


def test_moe_train_cell_on_pod16x16_runs_its_experts_by_all_to_all(
        tmp_path):
    """``mixtral-8x7b`` x ``train_4k`` on ``pod16x16``: 8 experts over 16
    ranks, so two ranks share each expert's F columns (tp = 2, one expert
    slice a rank), and each rank's 16 rows x 256 positions go to their
    experts by all-to-all: the (16, 1 x capacity, 4096) bf16 buffer six
    times a layer (dispatch and return, in the forward, its recompute and
    the backward)."""
    cfg = treg.get_config("mixtral-8x7b").with_model_shards(16)
    assert (cfg.moe.tp, cfg.moe.e_loc) == (2, 1)
    r = dryrun.dry_run_cell("mixtral-8x7b", "train_4k", "pod16x16",
                            str(tmp_path))
    assert r["fits"] is True
    tokens = (256 // 16) * (4096 // 16)
    buffer = 16 * cfg.moe.e_loc * cfg.moe.capacity(tokens) * 4096 * 2
    assert cfg.remat
    assert r["collective_bytes_per_device"]["all-to-all"] == \
        6 * cfg.num_layers * buffer
    assert not dist.is_initialized()


def test_flash_decode_cell_on_pod16x16_never_gathers_the_cache(tmp_path):
    """``qwen3-14b`` x ``decode_32k`` on ``pod16x16``: 8 kv heads over 16,
    so the cache holds each rank's 2048 of the 32768 positions; the step
    merges the softmax with small all-reduces and gathers only the
    token's activations and the logits, never the cache (the reference's
    107 GB a step) nor a weight."""
    cfg = treg.get_config("qwen3-14b")
    r = dryrun.dry_run_cell("qwen3-14b", "decode_32k", "pod16x16",
                            str(tmp_path))
    assert r["fits"] is True
    rows, pos = 128 // 16, 32768 // 16
    layer_cache = rows * pos * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    coll = r["collective_bytes_per_device"]
    assert set(coll) == {"all-reduce", "all-gather"}
    assert coll["all-gather"] < layer_cache / 2
    assert coll["all-reduce"] < layer_cache / 4
    assert r["bytes_per_device"]["output"] == \
        cfg.num_layers * layer_cache + rows * cfg.vocab_size * 4
    assert not dist.is_initialized()


def test_spiking_lm_decode_on_pod16x16_keeps_the_lif_state_whole(
        tmp_path, monkeypatch):
    """``deepseek-7b`` + LIF x ``decode_32k`` on ``pod16x16`` (model 16):
    the LIF state is whole on every model rank (the neuron runs on the
    whole D after ``w_down``'s sum), so the step runs on ``meta`` and its
    output holds the rank's kv heads, its rows' LIF state at the full D and
    the logits."""
    cfg = treg.get_config("deepseek-7b")
    lif = cfg.replace(lif=LIFConfig(policy=named_policy("cuda-full")))
    monkeypatch.setattr(treg, "get_config", lambda name: lif)
    fn, structs, specs = input_specs(lif, "decode_32k",
                                     AbstractMesh(("data", "model"),
                                                  (16, 16)))
    assert all(all(d is None or "model" not in (
        d if isinstance(d, tuple) else (d,)) for d in s)
        for s in specs[1]["lif"].values())
    r = dryrun.dry_run_cell("deepseek-7b", "decode_32k", "pod16x16",
                            str(tmp_path))
    assert r["devices"] == 256 and r["fits"] is True
    kv = 8 * 32768 * 2 * 128 * 2 * 30 * 2
    assert r["bytes_per_device"]["output"] == \
        kv + 2 * 30 * 8 * cfg.d_model * 2 + 8 * 102400 * 4
    assert not dist.is_initialized()


def test_fake_world_refuses_a_running_group():
    with dryrun.fake_world(2):
        with pytest.raises(RuntimeError, match="process group is running"):
            with dryrun.fake_world(2):
                pass
    assert not dist.is_initialized()


def test_perf_pixtral_variants_on_a_model_axis_of_one():
    """``baseline`` and ``seq_sharded_cache`` differ only in where the
    model axis would fall: on a model axis of 1 they count the same; the
    scatter update moves fewer bytes."""
    cfg = treg.reduced(treg.get_config("pixtral-12b"))
    out = {}
    for name, tf in perf.LM_VARIANTS["pixtral"]["variants"].items():
        with dryrun.fake_world(4):
            out[name] = perf.measure_lm(tf(cfg), ShapeSpec("decode", 64, 8),
                                        _mesh4())
    assert out["baseline"] == out["seq_sharded_cache"]
    assert out["scatter_cache"]["hlo_bytes"] < out["baseline"]["hlo_bytes"]
    assert out["scatter_cache"]["hlo_flops"] == out["baseline"]["hlo_flops"]


#: The decode cells of the rest of the model axis on ``pod16x16``: the
#: state each keeps on its rank's slice (a leaf of the cache, by path),
#: and the step.
STATE_CELLS = {
    ("deepseek-v2-236b", "decode_32k"): "c",          # latent on positions
    ("rwkv6-7b", "decode_32k"): "time/s",            # state on dk
    ("zamba2-2.7b", "long_500k"): "mamba/h",         # h on its columns
    ("whisper-large-v3", "decode_32k"): "cross/mk",  # memory on head_dim
}


@pytest.mark.parametrize("arch,shape", list(STATE_CELLS))
def test_recurrent_and_latent_decode_on_pod16x16_never_gathers_the_state(
        arch, shape):
    """Each cell's decode step on ``pod16x16`` (``meta`` tensors, a fake
    group of 256) with the weights gathered over "data" first, as the
    serving plan does before the step: every all-gather inside the step
    moves less than one layer of the state the cell keeps sliced over the
    model ranks (the latent cache on its positions, RWKV's ``s`` on dk,
    Mamba2's ``h`` on its columns, whisper's cross memory on head_dim),
    so none gathers a state, a cache or a memory; only the token's
    activations and the logits cross the group, and partial sums are
    all-reduced."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.launch.mesh import gather_leaf, map_specs, use_mesh
    from repro_torch.models.encdec import encdec_decode_step
    from repro_torch.models.lm import lm_decode_step

    class Gathers(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.sizes, self.kinds = [], set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.namespace == "c10d":
                name = func._schema.name.split("::")[-1]
                self.kinds.add(name)
                if "allgather" in name:
                    self.sizes.append(args[0].numel())
            return out

    cfg = treg.get_config(arch).with_model_shards(16)
    with dryrun.fake_world(256):
        mesh = dryrun.make_mesh("pod16x16")
        _, structs, specs = input_specs(cfg, shape, mesh)
        params, cache, tok, pos = dryrun.shard_args(structs, specs, mesh)
        params = map_specs(lambda sp, leaf: gather_leaf(leaf, sp, mesh),
                           specs[0], params)
        state = _leaves(cache)[STATE_CELLS[(arch, shape)]]
        whole = _leaves(structs[1])[STATE_CELLS[(arch, shape)]]
        rows = whole.shape[1] // state.shape[1]        # the data split
        assert state.numel() * rows * 16 == whole.numel()   # and model
        layer = state[0].numel() * 16                  # one layer gathered
        rec = Gathers()
        step = encdec_decode_step if cfg.family == "audio" else \
            lm_decode_step
        with use_mesh(mesh), rec:
            step(params, cache, tok, pos, cfg)
    assert not dist.is_initialized()
    assert rec.sizes and max(rec.sizes) < layer / 2, (max(rec.sizes), layer)
    assert rec.kinds <= {"_allgather_base_", "allreduce_"}, rec.kinds
