"""The port's site-level autotuner (``repro_torch.tune``) against the
reference's (``repro.tune``): tuned-block tables (keys, bytes on disk, each
package reading the other's file), plan-generated workloads at both
presets under every named policy, the oracle's arithmetic, measured
sparsity on the same weights and images; and, on the CPU, a smoke sweep
and dispatch that consults a table."""
import dataclasses
import json
import logging
import re
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from _torch_port import POLICY_PAIRS, np_tree, translate_impl

from repro.configs.spikingformer import get_spikingformer_config as jax_cfg
from repro.tune import table as jtable
from repro_torch.configs import get_spikingformer_config
from repro_torch.convert import from_jax
from repro_torch.core.energy.workload import MMOp
from repro_torch.core.spikingformer import (init_spikingformer,
                                            spikingformer_apply)
from repro_torch.kernels import build, neuron_layer, ops, spike_matmul
from repro_torch.tune import table as tb
from repro_torch.tune.oracle import (_pipeline_extra_cycles, candidate_cycles,
                                     oracle_array, oracle_best_dataflow,
                                     oracle_rank)
from repro_torch.tune.table import (TABLE_VERSION, TunedBlocks,
                                    current_device_kind, describe_tuned,
                                    load_table, lookup, parse_key,
                                    save_table, site_key)
from repro_torch.tune.workloads import (TUNABLE_IMPLS, SiteWorkload,
                                        kernel_shape_cases, site_workloads,
                                        training_mms)

SMOKE = "spikingformer-smoke@cuda-full"
PROJ_KEY = ("smlp.a", "linear_bn", "cuda+spike_mm", (64, 128, 64), True)


@pytest.fixture
def clean_table(monkeypatch, tmp_path):
    """Point the active table at a tmp file; always reload on teardown so
    no cached table leaks into other tests."""
    path = tmp_path / "tuned_blocks.json"
    monkeypatch.setenv(tb.ENV_VAR, str(path))
    tb.reload()
    yield path
    tb.reload()


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


# ---------------------------------------------------------------------------
# Tuned-block table
# ---------------------------------------------------------------------------

def test_site_key_round_trip():
    key = site_key(*PROJ_KEY, device_kind="NVIDIA-H100-80GB-HBM3")
    assert key == "NVIDIA-H100-80GB-HBM3|smlp.a|linear_bn|cuda+spike_mm|" \
        "64x128x64|packed"
    assert parse_key(key) == ("NVIDIA-H100-80GB-HBM3", *PROJ_KEY)
    assert key == jtable.site_key(*PROJ_KEY,
                                  device_kind="NVIDIA-H100-80GB-HBM3")
    assert jtable.parse_key(key) == parse_key(key)
    with pytest.raises(ValueError):
        parse_key("too|few|fields")
    with pytest.raises(ValueError):
        parse_key("k|s|o|i|64x64|sideways")
    assert current_device_kind(torch.device("cpu")) == "cpu"
    assert current_device_kind("cpu") == "cpu"


ENTRIES = {
    "cpu|smlp.a|linear_bn|fused_epilogue|2x64x64x128|packed": dict(
        block_m=256, block_k=64, block_c=128, arm="pipeline",
        oracle_cycles=1234.5, measured_us=4.5, sparsity=0.75),
    "cpu|smlp.b|linear_bn|cuda+spike_mm|128x128x64|packed": dict(
        block_m=128, block_k=64, block_c=64, oracle_cycles=892.0,
        measured_us=58.771),
    "cpu|tokenizer.conv.0|conv|fused_epilogue|2x256x27x32|dense": dict(
        arm="fused", block_k=64, block_c=128, sparsity=0.0),
}


def test_save_table_writes_the_references_bytes(tmp_path):
    meta = {"device_kind": "cpu"}
    save_table(tmp_path / "port.json",
               {k: TunedBlocks(**v) for k, v in ENTRIES.items()}, meta=meta)
    jtable.save_table(tmp_path / "ref.json",
                      {k: jtable.TunedBlocks(**v) for k, v in
                       ENTRIES.items()}, meta=meta)
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()


def test_each_package_reads_the_others_table(tmp_path):
    port = {k: TunedBlocks(**v) for k, v in ENTRIES.items()}
    ref = {k: jtable.TunedBlocks(**v) for k, v in ENTRIES.items()}
    save_table(tmp_path / "port.json", port)
    jtable.save_table(tmp_path / "ref.json", ref)
    from_port = jtable.load_table(tmp_path / "port.json")
    from_ref = load_table(tmp_path / "ref.json")
    assert from_ref == port
    assert {k: _fields(v) for k, v in from_port.items()} == \
        {k: _fields(v) for k, v in port.items()}
    # None fields are dropped on disk, restored as None on load
    (entry,) = [v for k, v in from_ref.items() if "conv.0" in k]
    assert entry.block_m is None and entry.mm_blocks() is None


def test_table_version_mismatch_loads_empty(tmp_path, caplog):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"version": TABLE_VERSION + 1,
                                "entries": {"x": {}}}))
    with caplog.at_level(logging.WARNING, logger="repro_torch.tune.table"):
        assert load_table(path) == {}
    assert any("version" in r.message for r in caplog.records)


def test_lookup_hit_and_once_per_key_miss_log(clean_table, caplog):
    entry = TunedBlocks(block_m=128, block_k=64, block_c=64)
    save_table(clean_table, {site_key(*PROJ_KEY, device_kind="cpu"): entry})
    tb.reload()
    assert lookup(*PROJ_KEY, device=torch.device("cpu")) == entry
    assert lookup(*PROJ_KEY, device="cpu").tile() == 2
    with caplog.at_level(logging.INFO, logger="repro_torch.tune.table"):
        for _ in range(3):            # miss: logged once, not three times
            assert lookup("smlp.a", "linear_bn", "cuda+spike_mm",
                          (999, 128, 64), True, "cpu") is None
    misses = [r for r in caplog.records if "no tuned blocks" in r.message]
    assert len(misses) == 1


def test_lookup_without_table_is_silent_none(monkeypatch, caplog):
    monkeypatch.setenv(tb.ENV_VAR, "/nonexistent/tuned.json")
    tb.reload()
    try:
        with caplog.at_level(logging.INFO, logger="repro_torch.tune.table"):
            assert lookup(*PROJ_KEY, device="cpu") is None
        assert not [r for r in caplog.records
                    if "no tuned blocks" in r.message]
    finally:
        tb.reload()
    monkeypatch.delenv(tb.ENV_VAR)
    assert tb.DEFAULT_PATH.parts[-3:] == ("benchmarks", "torch",
                                          "tuned_blocks.json")
    assert tb.table_path() == (tb.DEFAULT_PATH if tb.DEFAULT_PATH.exists()
                               else None)


def test_describe_tuned_renders_entries(clean_table):
    save_table(clean_table, {
        site_key(*PROJ_KEY, device_kind="cpu"): TunedBlocks(
            block_m=256, block_k=64, block_c=128),
        site_key(*PROJ_KEY, device_kind="NVIDIA-H100-80GB-HBM3"):
            TunedBlocks(block_m=128, block_k=64, block_c=64)})
    tb.reload()
    out = describe_tuned(["smlp.a"], device="cpu")
    assert out.splitlines()[0] == f"# TunedBlocks device=cpu " \
        f"source={clean_table}"
    assert "smlp.a,linear_bn,cuda+spike_mm,64x128x64,packed,256,64,128,-" \
        in out
    assert ",128,64,64," not in out          # another device's entry
    assert "no tuned entries" in describe_tuned(["not.a.site"], "cpu")
    cfg = get_spikingformer_config(SMOKE)
    if not torch.cuda.is_available():
        assert cfg.describe_execution().split("\n\n")[1] == \
            describe_tuned([r.site for r in cfg.execution_plan()], "cpu")


def test_entries_name_the_kernels_tiles():
    """``TunedBlocks.tile`` maps an entry's blocks to the spike matmul's
    ``tile`` argument; ``spike_matmul.TILES`` mirrors the tiles of
    ``csrc/spike_mma_mainloop.cuh`` (rows, columns, contraction chunk and
    shared memory, ``Tile::SMEM``)."""
    assert TunedBlocks().tile() == 0
    assert TunedBlocks(arm="fused", block_k=64, block_c=128).tile() == 0
    assert TunedBlocks(block_m=256, block_k=64, block_c=128).tile() == 1
    assert TunedBlocks(block_m=128, block_k=64, block_c=64).tile() == 2
    with pytest.raises(ValueError, match="no tile"):
        TunedBlocks(block_m=512, block_k=128, block_c=128).tile()
    src = (build.CSRC / "spike_mma_mainloop.cuh").read_text()
    for tile in spike_matmul.TILES.values():
        wm_, wn_, wm, wn, bk, _ = map(int, re.search(
            rf"using {tile.name} = Tile<(\d+), (\d+), (\d+), (\d+), (\d+), "
            rf"(\d+)>;", src).groups())
        bm, bn = 16 * wm * wm_, 8 * wn * wn_
        smem = 3 * bk * (bn + 8) * 2 + 2 * bm * (bk // 8)
        assert (tile.bm, tile.bn, tile.bk, tile.smem) == (bm, bn, bk, smem)
    assert [spike_matmul.default_tile(m) for m in (196, 512, 513)] == \
        [2, 2, 1]


@pytest.mark.parametrize("m,tile,sent", [(196, 0, 2), (512, 0, 2),
                                         (513, 0, 1), (196, 1, 1),
                                         (600, 2, 2)])
def test_the_wrapper_owns_the_tile_rule(monkeypatch, m, tile, sent):
    """The kernel takes the tile it runs, 1 (Large) or 2 (Small): the
    wrapper resolves ``tile=0`` by ``default_tile`` on the rows of one
    product, so the rule has one owner."""
    sent_tiles = []

    class Lib:
        @staticmethod
        def e2a_spike_matmul(*args):
            # ..., tile, the dtype code (0: fp32), stream
            assert args[-2] == 0
            sent_tiles.append(args[-3])
            return 0
    monkeypatch.setattr(spike_matmul.build, "load", lambda: Lib)
    spike_matmul._launch_spike_matmul(torch.zeros((2, 1, m, 2),
                                                  dtype=torch.uint8),
                                      torch.zeros((2, 1, 16, 8)), tile=tile)
    assert sent_tiles == [sent]


# ---------------------------------------------------------------------------
# Plan-generated workloads
# ---------------------------------------------------------------------------

def _workload_row(w, impl_map=lambda i: i):
    return (w.site, w.op, impl_map(w.impl), w.packed, w.shape, w.calls,
            _fields(w.mm) if w.mm is not None else None,
            [_fields(e) for e in w.elems], w.trailing_lif)


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("preset", ["spikingformer-smoke",
                                    "spikingformer-8-512"])
@pytest.mark.parametrize("jax_policy,port_policy", POLICY_PAIRS)
def test_workloads_equal_the_references(preset, batch, jax_policy,
                                        port_policy):
    """site_workloads (sites, shapes, calls, MMOp and ElemOp fields,
    packing, trailing LIF, with and without measured sparsity),
    kernel_shape_cases, training_mms, fused_site_geometries and
    oracle_best_dataflow, impl names mapped."""
    from repro.analysis.audit import fused_site_geometries as j_geoms
    from repro.tune import workloads as jw
    from repro.tune.oracle import oracle_best_dataflow as j_best
    from repro_torch.analysis.audit import fused_site_geometries

    jcfg = jax_cfg(f"{preset}@{jax_policy}")
    cfg = get_spikingformer_config(f"{preset}@{port_policy}")
    assert fused_site_geometries(cfg, batch) == j_geoms(jcfg, batch)
    for sp in (None, {"smlp.a": 0.123, "pssa.lif": 0.9, "attn_qk": 0.5}):
        want = jw.site_workloads(jcfg, batch, sp)
        got = site_workloads(cfg, batch, sp)
        assert [_workload_row(w) for w in got] == \
            [_workload_row(w, translate_impl) for w in want]
        assert [w.tunable for w in got] == [w.tunable for w in want]
        for g, w in zip(got, want):
            assert [_fields(m) for m in training_mms(g)] == \
                [_fields(m) for m in jw.training_mms(w)]
            assert oracle_best_dataflow(g) == j_best(w)
    assert [_fields(c) for c in kernel_shape_cases(cfg, batch)] == \
        [{**_fields(c), "impl": translate_impl(c.impl)}
         for c in jw.kernel_shape_cases(jcfg, batch)]
    assert TUNABLE_IMPLS == {(op, translate_impl(i))
                             for op, i in jw.TUNABLE_IMPLS}


def test_the_paper_preset_has_nine_tunable_sites():
    cfg = get_spikingformer_config("spikingformer-8-512@cuda-full")
    tunable = {w.site: w.impl for w in site_workloads(cfg, 16) if w.tunable}
    assert tunable == {
        **{f"tokenizer.conv.{i}": "fused_epilogue" for i in range(4)},
        "pssa.qkv": "fused_epilogue", "smlp.a": "fused_epilogue",
        "pssa.proj": "cuda+spike_mm", "smlp.b": "cuda+spike_mm",
        "attn_qk": "cuda_packed"}


# ---------------------------------------------------------------------------
# Oracle
# ---------------------------------------------------------------------------

def _wl(impl="cuda+spike_mm", op="linear_bn", shape=(64, 128, 64),
        packed=True, trailing=False, sparsity=0.75):
    return SiteWorkload(
        site="smlp.a", op=op, impl=impl, packed=packed, shape=shape,
        calls=1, trailing_lif=trailing,
        mm=MMOp("smlp.a", "FP", shape[-3], shape[-2], shape[-1],
                in_bits=1 if packed else 16, in_sparsity=sparsity))


@pytest.mark.parametrize("arr_name", ["paper", "reference_tpu", "port_h100"])
def test_oracle_arithmetic_equals_the_references(arr_name):
    """candidate_cycles and _pipeline_extra_cycles: the reference's
    arithmetic on the same MMOp, blocks and ArrayConfig."""
    from repro.core.energy import DEFAULT_ARRAY as J_ARRAY
    from repro.core.energy.workload import MMOp as JMMOp
    from repro.tune import oracle as jo

    j_arr = {"paper": J_ARRAY, "reference_tpu": jo.oracle_array(),
             "port_h100": dataclasses.replace(
                 J_ARRAY, **_fields(oracle_array()))}[arr_name]
    arr = dataclasses.replace(oracle_array(), **_fields(j_arr))
    for b, c, k, bits, count in ((12544, 512, 512, 1, 1),
                                 (196, 64, 196, 1, 512),
                                 (802816, 27, 64, 16, 1), (5, 3, 1, 16, 7)):
        mms = [cls("m", "FP", b, c, k, in_bits=bits, in_sparsity=0.8,
                   count=count) for cls in (JMMOp, MMOp)]
        assert _pipeline_extra_cycles(mms[1], arr) == \
            jo._pipeline_extra_cycles(mms[0], j_arr)
        for bm, bk, bc in ((256, 64, 128), (128, 64, 64), (b, 64, 128),
                           (512, 512, 1024)):
            assert candidate_cycles(mms[1], bm, bk, bc, arr) == \
                jo.candidate_cycles(mms[0], bm, bk, bc, j_arr)


def test_oracle_ranking_stable_across_runs():
    wl = _wl()
    a, b = oracle_rank(wl), oracle_rank(wl)
    assert a and a == b
    assert [c.cycles for c in a] == sorted(c.cycles for c in a)
    assert {(c.block_m, c.block_k, c.block_c) for c in a} == \
        {t.blocks for t in spike_matmul.TILES.values()}
    assert all(c.feasible and c.arm is None for c in a)


def test_oracle_fused_site_ranks_both_arms():
    for packed, n_pipe in ((True, 2), (False, 1)):
        wl = _wl(impl="fused_epilogue", shape=(4, 16, 128, 64),
                 trailing=True, packed=packed)
        ranked = oracle_rank(wl)
        assert {c.arm for c in ranked} == {"fused", "pipeline"}
        assert sum(c.arm == "pipeline" for c in ranked) == n_pipe
        for c in ranked:
            assert (c.block_m is None) == (c.arm == "fused" or not packed)
        keys = [(c.block_m, c.block_k, c.block_c, c.arm) for c in ranked]
        assert len(keys) == len(set(keys))


def test_oracle_empty_for_non_tunable():
    assert oracle_rank(_wl(impl="eager")) == []
    assert oracle_rank(_wl(impl="cuda")) == []
    assert oracle_rank(dataclasses.replace(_wl(), mm=None)) == []


def test_oracle_top_k_prefix():
    wl = _wl(impl="fused_epilogue", shape=(4, 16, 128, 64), trailing=True)
    for k in (1, 2, 3):
        assert oracle_rank(wl, top_k=k) == oracle_rank(wl)[:k]


# ---------------------------------------------------------------------------
# Measured sparsity: the same weights and images through both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sparsity():
    """The reference's probes, unregistered again afterwards: the registry
    of the reference is shared by every test that runs in this process.

    The reference adds each callback's count into its totals with
    ``acc[0] += float(nonzeros)``; XLA runs callbacks on several threads,
    and ``float`` of a device array can let another callback's addition in
    between the read and the write, which is then lost (about one run in
    five loses a few of the 10 ``pssa.lif`` mask counts at the smoke
    preset). The fixture converts the count before the addition and holds
    a lock over it, so that the reference counts every zero it sees."""
    from repro.core import policy as jpol
    import repro.tune.sparsity as js
    real, lock = js._record_host, threading.Lock()

    def record(site, kind, total, nonzeros):
        nz = float(nonzeros)
        with lock:
            real(site, kind, total, nz)
    js._record_host = record
    yield js
    js._record_host = real
    for op, impl in js.PROBE_OVERRIDES:
        jpol.unregister_kernel(op, impl)
    sys.modules.pop("repro.tune.sparsity", None)


@pytest.mark.parametrize("preset", ["spikingformer-smoke",
                                    "spikingformer-smoke-dvs"])
def test_measured_sparsity_agrees_with_the_references(jax_sparsity, preset):
    """The reference's ``measure_sparsity`` inputs (its key split,
    ``init_spikingformer`` and images), converted, through the port's
    probes under ``eager``: every site of one report is in the other, each
    zeros-fraction within 1e-3 (a spike may flip behind a reduction)."""
    from repro.core.spikingformer import init_spikingformer as j_init
    from repro_torch.tune.sparsity import sparsity_report

    torch.set_num_threads(1)
    jcfg = jax_cfg(f"{preset}@pallas-full")
    want = jax_sparsity.measure_sparsity(jcfg, batch=2, seed=0)
    pcfg = jcfg.with_policy(jax_sparsity.ExecutionPolicy(
        backend="jnp", overrides=jax_sparsity.PROBE_OVERRIDES))
    k_init, k_data = jax.random.split(jax.random.PRNGKey(0))
    params, state = j_init(k_init, pcfg)
    shape = (2, jcfg.image_size, jcfg.image_size, jcfg.in_channels)
    if jcfg.spike_input:
        x = jax.random.bernoulli(k_data, 0.5, (jcfg.time_steps,) + shape
                                 ).astype(jcfg.dtype)
    else:
        x = jax.random.uniform(k_data, shape, jcfg.dtype)
    tparams, tstate = from_jax(np_tree(params), np_tree(state), device="cpu")
    got = sparsity_report(tparams, tstate, torch.from_numpy(np.array(x)),
                          get_spikingformer_config(f"{preset}@eager"))
    gaps = {}
    for kind in ("operand", "spike", "mask"):
        g, w = getattr(got, kind), getattr(want, kind)
        assert set(g) == set(w), kind
        gaps.update({f"{kind}:{s}": abs(g[s] - w[s]) for s in g})
    assert set(got.totals) == set(want.totals)
    assert {k: v[1] for k, v in got.totals.items()} == \
        {k: v[1] for k, v in want.totals.items()}      # elements counted
    ga, wa = got.aggregate(), want.aggregate()
    for f in ("s_s", "s_smg", "s_pg"):
        gaps[f"aggregate:{f}"] = abs(getattr(ga, f) - getattr(wa, f))
    worst = max(gaps, key=gaps.get)
    print(f"largest gap {gaps[worst]:.3g} at {worst}")
    assert gaps[worst] <= 1e-3, (worst, gaps[worst])
    assert got.site_sparsity() == {**got.spike, **got.operand}


# ---------------------------------------------------------------------------
# Autotune and dispatch on the CPU (the plain versions, kind "cpu")
# ---------------------------------------------------------------------------

def test_smoke_tune_writes_one_entry_per_tunable_site(clean_table):
    from repro_torch.tune.autotune import tune_and_save

    cfg = get_spikingformer_config(SMOKE)
    rep = tune_and_save(cfg, clean_table, smoke=True, device="cpu")
    tunable = [w for w in site_workloads(cfg, 1) if w.tunable]
    assert rep.device_kind == "cpu"
    assert sorted(parse_key(k)[1] for k in rep.entries) == \
        sorted(w.site for w in tunable)
    assert all(k.startswith("cpu|") for k in rep.entries)
    for res in rep.results:
        assert res.winner in res.ranked[:2]            # smoke: top_k=2
        assert res.winner_us == min(us for _, us in res.timed) > 0
    for key, entry in rep.entries.items():
        assert entry.measured_us > 0
        if parse_key(key)[5]:                          # packed: measured
            assert entry.sparsity != pytest.approx(0.80)
    assert load_table(clean_table) == rep.entries
    assert json.loads(clean_table.read_text())["device_kind"] == "cpu"


def test_a_failing_candidate_raises():
    from repro_torch.tune.autotune import tune_site

    wl = _wl(impl="fused_epilogue", shape=(2, 16, 64, 32), trailing=True)

    def broken(*args, **kw):
        raise RuntimeError("injected launch failure")
    real = neuron_layer.neuron_layer_train_fwd
    neuron_layer.neuron_layer_train_fwd = broken
    try:
        with pytest.raises(RuntimeError, match="injected"):
            tune_site(wl, device="cpu")
    finally:
        neuron_layer.neuron_layer_train_fwd = real


@pytest.mark.parametrize("op,packed", [("linear_bn", True), ("conv", True),
                                       ("conv", False)])
def test_the_train_arms_are_timed_forward_and_backward(op, packed):
    """Dispatch takes a table's arm in train mode only, so the sweep times
    each arm of a neuron-layer site forward and backward: on the same
    operands the fused arm (its backward replays the pre-activation) and
    the pipeline arm give the gradients of w, gamma, beta and, for a
    spike input, x, equal within fp32 summation order (1e-5)."""
    from repro_torch.tune.autotune import _candidate

    wl = _wl(impl="fused_epilogue", op=op, shape=(2, 16, 64, 32),
             packed=packed, trailing=True)
    arms = {c.arm: c for c in oracle_rank(wl)}
    assert set(arms) == {"fused", "pipeline"}
    grads = {}
    for arm, cand in arms.items():
        call, operands = _candidate(wl, cand, torch.Generator().manual_seed(0),
                                    torch.device("cpu"))
        with torch.no_grad():                 # as the sweep calls it
            grads[arm] = call(*operands)
    assert len(grads["fused"]) == len(grads["pipeline"]) == \
        (4 if packed else 3)
    for a, b in zip(grads["fused"], grads["pipeline"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _model(seed=0, batch=2):
    cfg = get_spikingformer_config(SMOKE)
    params, state = init_spikingformer(torch.Generator().manual_seed(seed),
                                       cfg, "cpu")
    images = torch.rand((batch, cfg.image_size, cfg.image_size,
                         cfg.in_channels),
                        generator=torch.Generator().manual_seed(seed + 1))
    return cfg, params, state, images


def _train_forward(cfg, params, state, images):
    taps: list = []
    with torch.no_grad():
        logits, new_state = spikingformer_apply(params, state, images, cfg,
                                                train=True, taps=taps)
    return logits, taps


def _fused_key(cfg, site, batch=2):
    (wl,) = [w for w in site_workloads(cfg, batch) if w.site == site]
    return site_key(wl.site, wl.op, wl.impl, wl.shape, wl.packed, "cpu")


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[1], b[1])) and \
        torch.equal(a[0], b[0])


@pytest.mark.parametrize("site,pipeline", [("pssa.qkv", "cuda+spike_mm"),
                                           ("tokenizer.conv.1",
                                            "cuda_packed")])
def test_a_pipeline_entry_demotes_the_site(clean_table, caplog, site,
                                           pipeline):
    """A fused-epilogue entry whose arm is ``pipeline`` runs the site's
    pipeline (logged as expected) with the same spikes as a policy that
    pins the pipeline there; a site-level override pinning
    ``fused_epilogue`` beats the table."""
    cfg, params, state, images = _model()
    untuned = _train_forward(cfg, params, state, images)
    pinned = _train_forward(cfg.with_policy(cfg.policy.with_sites(
        {site: pipeline})), params, state, images)
    save_table(clean_table, {_fused_key(cfg, site): TunedBlocks(
        block_m=128, block_k=64, block_c=64, arm="pipeline")})
    tb.reload()
    seen = []
    real = ops.spike_matmul_train_op, ops.spike_patch_mm_train_op
    ops.spike_matmul_train_op = lambda s, w, tile=0: (
        seen.append(tile), real[0](s, w, tile))[1]
    ops.spike_patch_mm_train_op = lambda s, w, tile=0: (
        seen.append(tile), real[1](s, w, tile))[1]
    try:
        with caplog.at_level(logging.INFO, logger="repro_torch.execution"):
            tuned = _train_forward(cfg, params, state, images)
    finally:
        ops.spike_matmul_train_op, ops.spike_patch_mm_train_op = real
    demoted = [r for r in caplog.records
               if "tuned table prefers the pipeline arm" in r.message]
    assert demoted and all(r.levelno == logging.INFO for r in demoted)
    assert site in demoted[0].message
    assert _same(tuned, pinned)
    assert 2 in seen                       # the entry's tile reached it
    fused = cfg.with_policy(cfg.policy.with_sites({site: "fused_epilogue"}))
    assert _same(_train_forward(fused, params, state, images), untuned)


def test_a_demoted_conv_stage_lowers_its_input_once(clean_table,
                                                   monkeypatch):
    """A conv stage that a table demotes hands the pipeline the im2col
    patches it already made: one ``im2col`` a stage, as without a
    table."""
    from repro_torch.kernels import conv_spike

    cfg, params, state, images = _model()
    calls = []
    real = conv_spike.im2col
    monkeypatch.setattr(conv_spike, "im2col",
                        lambda *a, **kw: (calls.append(1), real(*a, **kw))[1])
    _train_forward(cfg, params, state, images)
    untuned = len(calls)
    save_table(clean_table, {_fused_key(cfg, "tokenizer.conv.1"): TunedBlocks(
        block_m=256, block_k=64, block_c=128, arm="pipeline")})
    tb.reload()
    calls.clear()
    _train_forward(cfg, params, state, images)
    assert len(calls) == untuned == cfg.tokenizer_stages


def test_a_spike_matmul_entry_forces_its_tile(clean_table):
    """An entry at a spike-matmul site hands its tile to the kernel wrapper;
    the spikes are the untuned forward's."""
    cfg, params, state, images = _model()
    untuned = _train_forward(cfg, params, state, images)
    (wl,) = [w for w in site_workloads(cfg, 2) if w.site == "pssa.proj"]
    save_table(clean_table, {site_key(wl.site, wl.op, wl.impl, wl.shape,
                                      wl.packed, "cpu"):
                             TunedBlocks(block_m=128, block_k=64,
                                         block_c=64)})
    tb.reload()
    seen = []
    real = spike_matmul.spike_matmul_packed

    def spy(packed, w, **kw):
        seen.append(kw.get("tile"))
        return real(packed, w, **kw)
    spike_matmul.spike_matmul_packed = spy
    try:
        tuned = _train_forward(cfg, params, state, images)
    finally:
        spike_matmul.spike_matmul_packed = real
    assert seen == [2, 0] * cfg.num_layers     # pssa.proj, then smlp.b
    assert _same(tuned, untuned)


def test_without_a_table_dispatch_is_unchanged(monkeypatch, tmp_path):
    """No table: every spike matmul gets tile 0 (the kernel's own rule),
    the same kernels run and the forward is bit-equal to one under a table
    that has entries only for another device kind."""
    monkeypatch.setenv(tb.ENV_VAR, "/nonexistent/tuned.json")
    tb.reload()
    cfg, params, state, images = _model()
    seen = []
    real = (spike_matmul.spike_matmul_packed,
            spike_matmul.spike_matmul_packed_batched)

    def spy(fn):
        def call(packed, w, **kw):
            seen.append(kw.get("tile"))
            return fn(packed, w, **kw)
        return call
    monkeypatch.setattr(spike_matmul, "spike_matmul_packed", spy(real[0]))
    monkeypatch.setattr(spike_matmul, "spike_matmul_packed_batched",
                        spy(real[1]))
    try:
        untuned = _train_forward(cfg, params, state, images)
        assert tb.active_table() == {}
    finally:
        tb.reload()
    assert seen and set(seen) == {0}
    other = {k.replace("cpu|", "NVIDIA-H100-80GB-HBM3|"): v
             for k, v in {_fused_key(cfg, "pssa.qkv"): TunedBlocks(
                 block_m=128, block_k=64, block_c=64, arm="pipeline")}
             .items()}
    path = tmp_path / "other_device.json"
    save_table(path, other)
    monkeypatch.setenv(tb.ENV_VAR, str(path))
    tb.reload()
    try:
        assert _same(_train_forward(cfg, params, state, images), untuned)
    finally:
        tb.reload()
