"""The sharding plan's arithmetic against the reference, with no processes:
``sanitize_specs`` and ``apply_fsdp`` leaf for leaf on the (4, 2), (2, 4),
(16, 16) and (2, 16, 16) meshes for every registry config and for the
Spikingformer plan (the reference is handed a stand-in mesh with
``axis_names`` and ``axis_sizes``, all it reads); ``ElasticPlan`` on the
reference's cases; ``batch_axes``; ``describe_execution(mesh)``; the
partition spec's printing; the placement of one leaf (slice, gather
shape, the model axis refused); the driver's refusal of a model axis."""
import dataclasses

import jax
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.spikingformer import get_spikingformer_config as jsf_cfg
from repro.core.spikingformer import (spikingformer_param_specs as
                                      j_param_specs, spikingformer_scan_dims
                                      as j_scan_dims)
from repro.launch import mesh as jmesh
from repro.launch.specs import param_structs as j_param_structs
from repro.models.common import spec_is_leaf as j_spec_is_leaf
from repro.train.resilience import ElasticPlan as JElasticPlan
from repro_torch.configs import get_spikingformer_config
from repro_torch.configs import registry as treg
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.specs import (cache_structs, param_structs,
                                      spikingformer_structs)
from repro_torch.train.checkpoint import _flatten_with_paths
from repro_torch.train.resilience import ElasticPlan

MESHES = {"4x2": (("data", "model"), (4, 2)),
          "2x4": (("data", "model"), (2, 4)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


@dataclasses.dataclass(frozen=True)
class _StubMesh:
    """What the reference's spec functions read of a mesh."""
    axis_names: tuple
    axis_sizes: tuple


def _jax_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=j_spec_is_leaf)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): spec for path, spec in flat[0]}


def _torch_specs(tree) -> dict:
    return dict(_flatten_with_paths(tree, spec_leaves=True))


def _same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert (g is None) == (w is None), k
        if w is not None:
            assert tuple(g) == tuple(w) and repr(g) == repr(w), (k, g, w)


@pytest.fixture(scope="module")
def lm_structs():
    """Every registry config's (reference structs, specs) and the port's
    (meta tensors, specs)."""
    return {name: (j_param_structs(jreg.get_config(name)),
                   param_structs(treg.get_config(name)))
            for name in jreg.list_configs()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_lm_plans_equal_the_reference(lm_structs, mesh):
    names, sizes = MESHES[mesh]
    jm, tm = _StubMesh(names, sizes), tmesh.AbstractMesh(names, sizes)
    for name, ((js, jspec), (ts, tspec)) in lm_structs.items():
        assert [tuple(x.shape) for x in jax.tree.leaves(js)] == \
            [tuple(x.shape) for _, x in _flatten_with_paths(ts)], name
        j_san = jmesh.sanitize_specs(jspec, js, jm)
        t_san = tmesh.sanitize_specs(tspec, ts, tm)
        _same(_torch_specs(t_san), _jax_specs(j_san))
        for min_elems in (1 << 20, 1024):
            _same(_torch_specs(tmesh.apply_fsdp(t_san, ts, tm, min_elems)),
                  _jax_specs(jmesh.apply_fsdp(j_san, js, jm, min_elems)))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("preset", ["spikingformer-smoke",
                                    "spikingformer-8-512"])
def test_spikingformer_plan_equals_the_reference(mesh, preset):
    names, sizes = MESHES[mesh]
    jm, tm = _StubMesh(names, sizes), tmesh.AbstractMesh(names, sizes)
    jcfg = jsf_cfg(preset)
    from repro.core.spikingformer import init_spikingformer
    jp, js = jax.eval_shape(lambda k: init_spikingformer(k, jcfg),
                            jax.random.PRNGKey(0))
    jps, jss = j_param_specs(jcfg)
    jps = jmesh.sanitize_specs(jps, jp, jm)
    for min_elems in (1 << 20, 1024):
        want = jmesh.apply_fsdp(jps, jp, jm, min_elems=min_elems,
                                scan_dims=j_scan_dims(jps))
        (_, _), (tps, tss) = spikingformer_structs(
            get_spikingformer_config(preset), tm, min_elems)
        _same(_torch_specs(tps), _jax_specs(want))
    _same(_torch_specs(tss), _jax_specs(jmesh.sanitize_specs(jss, js, jm)))


def test_describe_execution_names_the_plan():
    mesh = tmesh.AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    got = get_spikingformer_config("spikingformer-8-512").describe_execution(
        mesh)
    assert "pssa.qkv,PartitionSpec(None, ('pod', 'data'), None, 'model')" \
        in got
    assert "blocks/pssa/q/linear/w,PartitionSpec(" in got
    want = jsf_cfg("spikingformer-8-512").describe_sharding()
    assert got.split("\n\n")[-1].startswith(want)


def test_partition_spec_prints_and_compares_as_jax_does():
    from jax.sharding import PartitionSpec as JP
    for axes in [(), (None,), ("data",), (None, ("pod", "data"), None,
                                          "model"), (("model",), None)]:
        assert repr(tmesh.P(*axes)) == repr(JP(*axes))
    assert tmesh.P(("model",)) == ("model",)


def test_batch_axes_and_production_meshes():
    assert tmesh.batch_axes(tmesh.make_production_mesh()) == ("data",)
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert tmesh.batch_axes(multi) == ("pod", "data")
    assert multi.size == 512 and multi.shape == {"pod": 2, "data": 16,
                                                 "model": 16}
    for names, sizes in MESHES.values():
        assert tmesh.batch_axes(tmesh.AbstractMesh(names, sizes)) == \
            jmesh.batch_axes(_StubMesh(names, sizes))


def test_structs_are_the_reference_s():
    """The decode cache's, the optimizer's and the batch's structs and specs
    (meta tensors) against ``repro.launch.specs``'s, shapes and specs."""
    from repro.launch import specs as jspecs
    from repro_torch.launch.specs import SHAPES, _batch_structs, opt_structs
    for name in ("qwen3-0.6b", "whisper-large-v3", "pixtral-12b"):
        jcfg, tcfg = jreg.get_config(name), treg.get_config(name)
        for batch in (1, 8):
            js, jspec = jspecs.cache_structs(jcfg, batch, 64, ("data",))
            ts, tspec = cache_structs(tcfg, batch, 64, ("data",))
            assert [x.shape for x in jax.tree.leaves(js)] == \
                [tuple(x.shape) for _, x in _flatten_with_paths(ts)]
            assert all(x.device.type == "meta"
                       for _, x in _flatten_with_paths(ts))
            _same(_torch_specs(tspec), _jax_specs(jspec))
        sh = jspecs.SHAPES["train_4k"]
        assert SHAPES["train_4k"] == type(SHAPES["train_4k"])(
            sh.kind, sh.seq, sh.batch)
        jb, jbs = jspecs._batch_structs(jcfg, sh, ("data",))
        tb, tbs = _batch_structs(tcfg, SHAPES["train_4k"], ("data",))
        assert {k: v.shape for k, v in jb.items()} == \
            {k: tuple(v.shape) for k, v in tb.items()}
        _same(_torch_specs(tbs), _jax_specs(jbs))
    ts, tspec = param_structs(treg.reduced(treg.get_config("qwen3-0.6b")))
    state, specs = opt_structs(ts, tspec)
    assert specs["m"] is tspec and specs["err"] is None
    assert [tuple(x.shape) for _, x in _flatten_with_paths(state["v"])] == \
        [tuple(x.shape) for _, x in _flatten_with_paths(ts)]


@pytest.mark.parametrize("shape,names,healthy,want,scale", [
    ((2, 16, 16), ("pod", "data", "model"), 256, (1, 16, 16), 0.5),
    ((16, 16), ("data", "model"), 140, (8, 16), 0.5),
    ((2, 16, 16), ("pod", "data", "model"), 128, (8, 16), None),
])
def test_elastic_plan_is_the_reference(shape, names, healthy, want, scale):
    got = ElasticPlan.after_failure(shape, names, healthy)
    ref = JElasticPlan.after_failure(shape, names, healthy)
    assert got.new_shape == ref.new_shape == want
    assert got.axis_names == ref.axis_names
    assert got.batch_scale == ref.batch_scale
    if scale is not None:
        assert got.batch_scale == scale


def test_elastic_plan_preserves_the_model_axis():
    for plan in (ElasticPlan, JElasticPlan):
        with pytest.raises(RuntimeError):
            plan.after_failure((1, 16), ("data", "model"), healthy_devices=8)


class _FakeMesh(tmesh.AbstractMesh):
    """A rank's coordinates without a process group (placement only)."""

    def __init__(self, names, sizes, coords):
        super().__init__(names, sizes)
        object.__setattr__(self, "coords", coords)


def test_local_shard_slices_by_coordinates():
    full = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    mesh = _FakeMesh(("pod", "data", "model"), (2, 3, 1),
                     {"pod": 1, "data": 2, "model": 0})
    got = tmesh.local_shard(full, tmesh.P(None, ("pod", "data")), mesh)
    assert torch.equal(got, full[:, 5:6])           # index 1 * 3 + 2 of 6
    assert tmesh.full_shape(got, tmesh.P(None, ("pod", "data")), mesh) == \
        (4, 6, 2)
    assert tmesh.local_shard(full, None, mesh) is full
    with pytest.raises(ValueError, match="divide"):
        tmesh.local_shard(full, tmesh.P("data"), mesh)
    assert tmesh.resolve_spec(tmesh.P(("pod", "data"), "model"),
                              tmesh.AbstractMesh(("data",), (2,))) == \
        tmesh.P("data", None)


def test_gather_refuses_the_model_axis():
    mesh = _FakeMesh(("data", "model"), (2, 2), {"data": 0, "model": 1})
    with pytest.raises(NotImplementedError, match="A11c"):
        tmesh.batch_dim(tmesh.P(None, "model"), mesh)
    one = _FakeMesh(("data", "model"), (2, 1), {"data": 0, "model": 0})
    assert tmesh.batch_dim(tmesh.P("data", "model"), one) == 0


def test_a_train_step_on_a_model_axis_raises():
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptimizerConfig
    mesh = _FakeMesh(("data", "model"), (1, 2), {"data": 0, "model": 0})
    with pytest.raises(NotImplementedError, match="A11c"):
        make_train_step(treg.reduced(treg.get_config("qwen3-0.6b")),
                        OptimizerConfig(), mesh=mesh)


def test_mesh_axis_size_reads_the_ambient_mesh():
    from repro_torch.models.common import mesh_axis_size
    assert mesh_axis_size("model") is None
    with tmesh.use_mesh(tmesh.AbstractMesh(("data", "model"), (4, 2))):
        assert mesh_axis_size("model") == 2 and mesh_axis_size("pod") is None
        assert tmesh.batch_group() is None       # no ranks: local statistics
    assert tmesh.current_mesh() is None


def test_meta_structs_allocate_nothing():
    structs, _ = param_structs(treg.get_config("deepseek-v2-236b"))
    leaves = [x for _, x in _flatten_with_paths(structs)]
    assert all(x.device.type == "meta" for x in leaves)
    assert sum(x.numel() for x in leaves) > 2e11
