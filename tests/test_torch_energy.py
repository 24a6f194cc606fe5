"""The port's copy of the paper's energy model (``repro_torch.core.energy``)
against the reference (``repro.core.energy``), number for number: the same
inputs give equal float64 results (``==``), for every public function, and
the reference's paper-claim tests (``tests/test_energy_model.py``) hold on
the port."""
import dataclasses
import inspect
import types
from pathlib import Path

import pytest
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # bare env: deterministic fallback shim
    from _hypothesis_shim import given, settings, strategies as st

import repro.core.energy as J
import repro_torch.core.energy as P

ROOT = Path(__file__).resolve().parent.parent


def _port(obj):
    """A reference energy-model value rebuilt from the port's classes."""
    if isinstance(obj, list):
        return [_port(o) for o in obj]
    if isinstance(obj, J.Dataflow):
        return P.Dataflow(P.Inner(obj.inner.value), P.Outer(obj.outer.value))
    if dataclasses.is_dataclass(obj):
        cls = getattr(P, type(obj).__name__)
        return cls(**{f.name: _port(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    return obj


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_constants_are_the_papers_and_the_cards():
    for name in ("DEFAULT_ARRAY", "DEFAULT_MEM", "DEFAULT_OPS",
                 "DEFAULT_SPARSITY"):
        assert _fields(getattr(P, name)) == _fields(getattr(J, name))
    from repro_torch.core.energy import constants
    assert not [n for n in vars(constants) if n.startswith("TPU")]
    assert (constants.H100_PEAK_FLOPS_BF16, constants.H100_PEAK_FLOPS_FP32,
            constants.H100_HBM_BW) == (989e12, 67e12, 3.35e12)
    assert [df.name for df in P.ALL_DATAFLOWS] == \
        [df.name for df in J.ALL_DATAFLOWS]
    assert sorted(P.__all__) == sorted(J.__all__)


WORKLOADS = {
    "paper": {},
    "two_layers_sparse": {"num_layers": 2, "sparsity": dict(
        s_s=0.9, s_smg=0.3, s_pg=0.7)},
    "batch_4_t_2": {"BS": 4, "T": 2, "d_ff": 1536, "P": 7},
}
ARRAYS = {
    "default": {},
    "eq26_verbatim": {"fill_overlap": "none"},
    "serial_elementwise": {"pipeline_elementwise": False, "rows": 32,
                           "freq_hz": 1e9, "sram_w_bytes": 64 * 1024},
}


def _workload(pkg, spec):
    spec = dict(spec)
    if "sparsity" in spec:
        spec["sparsity"] = pkg.Sparsity(**spec["sparsity"])
    return pkg.SpikingWorkloadConfig(**spec)


@pytest.mark.parametrize("spike_mm_energy", ["add", "mac"])
@pytest.mark.parametrize("arr", sorted(ARRAYS))
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_simulator_sweep_number_for_number(workload, arr, spike_mm_energy):
    """Energy, latency and every stage and kind breakdown for all nine
    dataflows, and the Table IX metrics, equal the reference's."""
    sims = [pkg.E2ATSTSimulator(
        _workload(pkg, WORKLOADS[workload]),
        arr=dataclasses.replace(pkg.DEFAULT_ARRAY, **ARRAYS[arr]),
        spike_mm_energy=spike_mm_energy) for pkg in (J, P)]
    want, got = (s.sweep() for s in sims)
    assert list(got) == list(want) and len(got) == 9
    for name, w in want.items():
        g = got[name]
        assert g.dataflow == w.dataflow
        for prop in ("energy_j", "latency_s", "macs", "power_w",
                     "eff_tflops", "tflops_per_w"):
            assert getattr(g, prop) == getattr(w, prop), (name, prop)
        assert list(g.stages) == list(w.stages)
        for st_name, ws in w.stages.items():
            gs = g.stages[st_name]
            assert gs.energy_by_kind == ws.energy_by_kind
            assert (gs.compute_j, gs.memory_j, gs.latency_s, gs.macs,
                    gs.energy_j) == (ws.compute_j, ws.memory_j, ws.latency_s,
                                     ws.macs, ws.energy_j), (name, st_name)
    for df_j, df_p in zip(J.ALL_DATAFLOWS, P.ALL_DATAFLOWS):
        assert sims[1].table_ix(df_p) == sims[0].table_ix(df_j)
        assert sims[1].utilization(df_p) == sims[0].utilization(df_j)
    for metric in ("energy", "latency"):
        assert sims[1].optimal(metric).dataflow == \
            sims[0].optimal(metric).dataflow


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_training_workload_op_for_op(workload):
    mms_j, el_j = J.spikingformer_training_workload(
        _workload(J, WORKLOADS[workload]))
    mms_p, el_p = P.spikingformer_training_workload(
        _workload(P, WORKLOADS[workload]))
    assert [_fields(m) for m in mms_p] == [_fields(m) for m in mms_j]
    assert [_fields(e) for e in el_p] == [_fields(e) for e in el_j]
    assert [(m.macs, m.flops) for m in mms_p] == \
        [(m.macs, m.flops) for m in mms_j]
    layer = [("q", 196, 512, 512), ("ffn", 196, 512, 2048)]
    assert [_fields(m) for m in P.generic_mm_workload("vit", layer, 3, "BP")] \
        == [_fields(m) for m in J.generic_mm_workload("vit", layer, 3, "BP")]


mm_fields = st.builds(
    lambda b, c, k, bits, sp, count, stage: dict(
        name="p", stage=stage, B=b, C=c, K=k, in_bits=bits, in_sparsity=sp,
        count=count),
    st.integers(-2, 5000), st.integers(-2, 5000), st.integers(1, 5000),
    st.sampled_from([1, 16]), st.floats(0.0, 0.99), st.integers(1, 64),
    st.sampled_from(["FP", "BP", "WG"]))
arr_fields = st.builds(
    lambda rows, cols, fill, sram, dram: dict(
        rows=rows, cols=cols, fill_overlap=fill, sram_in_bytes=sram,
        sram_w_bytes=2 * sram, sram_out_bytes=sram,
        dram_bytes_per_cycle=dram),
    st.sampled_from([8, 64, 128, 256]), st.sampled_from([8, 64, 128]),
    st.sampled_from(["drain", "none"]),
    st.sampled_from([4096, 256 * 1024, 4 * 2 ** 20]),
    st.floats(8.0, 512.0))


@settings(max_examples=60, deadline=None)
@given(mm=mm_fields, arr=arr_fields,
       i=st.integers(0, len(J.ALL_DATAFLOWS) - 1))
def test_dataflow_and_costs_number_for_number(mm, arr, i):
    """mm_traffic, compute_cycles, utilization, mm_latency_cycles, mm_cost
    and best_dataflow over drawn ops (degenerate dims included) and
    arrays."""
    pair = [(pkg.MMOp(**mm), pkg.ALL_DATAFLOWS[i],
             dataclasses.replace(pkg.DEFAULT_ARRAY, **arr)) for pkg in (J, P)]
    (mj, dj, aj), (mp, dp, ap) = pair
    assert _fields(P.mm_traffic(mp, dp, ap)) == _fields(J.mm_traffic(mj, dj,
                                                                     aj))
    for fn in ("compute_cycles", "utilization", "mm_latency_cycles"):
        assert getattr(P, fn)(mp, dp, ap) == getattr(J, fn)(mj, dj, aj), fn
    for mode in ("add", "mac"):
        assert _fields(P.mm_cost(mp, dp, arr=ap, spike_mm_energy=mode)) == \
            _fields(J.mm_cost(mj, dj, arr=aj, spike_mm_energy=mode))
    for metric in ("latency", "dram"):
        assert P.best_dataflow([mp], ap, metric).name == \
            J.best_dataflow([mj], aj, metric).name


@pytest.mark.parametrize("kind", ["soma", "grad", "bn_fp", "bn_bp", "res"])
def test_elementwise_costs_number_for_number(kind):
    for n, d, s in ((1, 1, 1), (12544 * 512, 512, 12544), (77, 3, 1000)):
        ops = [pkg.ElemOp("e", "FP", kind, n_features=d, n_samples=s,
                          n_elems=n) for pkg in (J, P)]
        assert _fields(P.elem_cost(ops[1])) == _fields(J.elem_cost(ops[0]))
        assert P.elem_cost(ops[1]).total_j == J.elem_cost(ops[0]).total_j


@pytest.mark.parametrize("sparsity", [0.0, 0.15, 0.8, 0.999])
def test_inference_energy_number_for_number(sparsity):
    for ops_g in (0.5, 12.54, 17.6):
        for e_mac, e_ac in ((4.6, 0.9), (3.1, 0.1)):
            assert P.inference_energy_mj(ops_g, sparsity, e_mac, e_ac) == \
                J.inference_energy_mj(ops_g, sparsity, e_mac, e_ac)


# ---------------------------------------------------------------------------
# The reference's paper claims, run on the port: tests/test_energy_model.py
# with its imports of the reference's energy model pointed at the port's.
# ---------------------------------------------------------------------------

_CLAIMS = types.ModuleType("energy_model_claims_on_the_port")
exec(compile((ROOT / "tests" / "test_energy_model.py").read_text()
             .replace("repro.core.energy", "repro_torch.core.energy"),
             str(ROOT / "tests" / "test_energy_model.py"), "exec"),
     _CLAIMS.__dict__)
CLAIMS = sorted(n for n, f in vars(_CLAIMS).items()
                if n.startswith("test_") and callable(f))


@pytest.fixture(scope="module")
def port_sim():
    sim = P.E2ATSTSimulator()
    return sim, sim.sweep()


def test_every_reference_claim_is_run():
    assert len(CLAIMS) == 17
    assert _CLAIMS.E2ATSTSimulator is P.E2ATSTSimulator
    assert _CLAIMS.mm_traffic is P.mm_traffic


@pytest.mark.parametrize("claim", CLAIMS)
def test_paper_claim_holds_on_the_port(claim, port_sim, request):
    fn = getattr(_CLAIMS, claim)
    sim, sweep = port_sim
    given_ = {"sim": sim, "sweep": sweep}
    kwargs = {p: given_[p] if p in given_ else request.getfixturevalue(p)
              for p in inspect.signature(fn).parameters}
    fn(**kwargs)
