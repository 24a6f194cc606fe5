"""Tests for the port's kernel-contract verifier
(``repro_torch.analysis.contracts``), the counterparts of
``test_analysis_contracts.py``: the clean tree verifies without an error
while launching nothing and building nothing, and each doctored piece (a
backward with the wrong cotangent shape or dtype, a wrapper whose output
dtype drifts from its oracle, a missing or phantom declaration, an unstable
config factory, a launch plan past the card's limits) is caught under the
right ``audit.kernel.*`` check name."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch.analysis.contracts as contracts
import repro_torch.kernels.contract as kc
from repro_torch.analysis.contracts import (audit_kernel_coverage,
                                            audit_kernel_matrix,
                                            audit_kernel_vjps,
                                            audit_registry_retrace,
                                            launch_family_ran, run_contracts)
from repro_torch.analysis.report import exit_code
from repro_torch.kernels import KERNELS, build, launch_counts, ops
from repro_torch.kernels.build import Launch, PlannedCall

REPO = Path(__file__).parent.parent

SMOKE = ["spikingformer-smoke"]


def _errors(findings):
    return [f for f in findings if f.level == "error"]


def _decl(name: str) -> kc.KernelContract:
    return kc.kernel_contracts()[name]


# -- clean tree --------------------------------------------------------------

def test_clean_tree_verifies_without_errors_launches_or_builds(monkeypatch):
    """The acceptance bar: the smoke matrix passes, no kernel's launch count
    moves, and the library is never loaded (here, without a card, the
    launch family says in an info row that it did not run)."""
    def raiser(*a, **kw):
        raise AssertionError("build.load called by the contract verifier")

    monkeypatch.setattr(build, "load", raiser)
    before = launch_counts()
    findings = run_contracts(presets=SMOKE)
    assert _errors(findings) == [], \
        "\n".join(f.format() for f in _errors(findings))
    assert exit_code(findings) == 0
    assert launch_counts() == before
    if not torch.cuda.is_available():
        assert not launch_family_ran(findings)
        assert [f.where for f in findings
                if f.check == "audit.kernel.launch"] == ["not-run"]


def test_every_contract_meets_a_site_of_the_matrix():
    cases = contracts.kernel_cases(presets=SMOKE)
    assert {d.name for _, d, _ in cases} == set(kc.kernel_contracts())
    assert len(kc.kernel_contracts()) == 11


def test_registry_retrace_is_stable():
    findings = audit_registry_retrace(presets=SMOKE)
    assert _errors(findings) == [], \
        "\n".join(f.format() for f in _errors(findings))


# -- doctored pieces ---------------------------------------------------------

def test_bwd_cotangent_shape_mismatch_is_caught(monkeypatch):
    # the doctored backward returns dgamma as a (1, K) statistics row
    # instead of the (K,) parameter shape: the dropped-reshape bug class
    real = ops._BnTrain.backward

    def doctored(ctx, gy, g_mu, g_var):
        dx, dgamma, dbeta, *rest = real(ctx, gy, g_mu, g_var)
        return (dx, dgamma.reshape(1, -1), dbeta, *rest)

    monkeypatch.setattr(ops._BnTrain, "backward", staticmethod(doctored))
    findings = audit_kernel_vjps()
    errs = [f for f in _errors(findings) if f.check == "audit.kernel.vjp"]
    assert errs, "cotangent shape mismatch not flagged"
    assert all("bn_train_op" in f.where for f in errs)
    assert exit_code(findings) != 0


def test_bwd_dtype_drift_is_caught(monkeypatch):
    # the silent-upcast bug class: fp32 weight cotangents for bf16 primals.
    # Autograd would cast it back; the verifier calls backward directly.
    real = ops._SpikeMatmul.backward

    def doctored(ctx, g):
        d_spikes, d_w, *rest = real(ctx, g)
        return (d_spikes, d_w.float(), *rest)

    monkeypatch.setattr(ops._SpikeMatmul, "backward", staticmethod(doctored))
    findings = audit_kernel_vjps()
    errs = [f for f in _errors(findings) if f.check == "audit.kernel.vjp"]
    assert errs, "fp32 cotangent upcast not flagged"
    assert all("bfloat16" in f.where for f in errs)
    assert any("spike_matmul_train_op" in f.where for f in errs)


def test_dtype_drift_against_reference_is_caught(monkeypatch):
    # the doctored bn_fwd quietly emits fp16 activations; the oracle keeps
    # the input dtype, so parity must fail
    decl = _decl("bn_fwd")
    real_fn = decl.fn

    def drifted(*args, **kwargs):
        y, mu, sqrt_d = real_fn(*args, **kwargs)
        return y.half(), mu, sqrt_d

    monkeypatch.setitem(kc._CONTRACTS, "bn_fwd",
                        dataclasses.replace(decl, fn=drifted))
    findings = audit_kernel_matrix(presets=SMOKE, launches=False)
    errs = [f for f in _errors(findings)
            if f.check == "audit.kernel.parity"]
    assert errs, "fp16 output drift vs reference not flagged"
    assert all("bn_fwd" in f.where for f in errs)
    assert exit_code(findings) != 0


def test_missing_declaration_fails_coverage(monkeypatch):
    # spike_matmul_batched is the only declaration serving the packed
    # attention arms; dropping it strands both (op, impl) pairs
    monkeypatch.delitem(kc._CONTRACTS, "spike_matmul_batched")
    findings = audit_kernel_coverage()
    errs = [f for f in _errors(findings)
            if f.check == "audit.kernel.coverage"]
    assert any("attn_qk/cuda_packed" in f.where for f in errs)
    assert any("attn_av/cuda_packed" in f.where for f in errs)
    # and KERNELS' row for the batched kernel is no longer served whole
    assert any(f.where == "spike_matmul_packed_batched" for f in errs)


def test_phantom_serves_pair_fails_coverage(monkeypatch):
    decl = _decl("spike_matmul")
    monkeypatch.setitem(
        kc._CONTRACTS, "spike_matmul",
        dataclasses.replace(decl, serves=decl.serves + (("linear_bn",
                                                          "pallas"),)))
    findings = audit_kernel_coverage()
    errs = [f for f in _errors(findings)
            if f.check == "audit.kernel.coverage"]
    assert errs and any("pallas" in f.message for f in errs)


def test_declarations_and_the_kernel_table_agree(monkeypatch):
    """``KERNELS`` and the declarations are one table: a row whose
    ``serves`` the declarations do not add up to fails coverage."""
    assert _errors(audit_kernel_coverage()) == []
    row = dict(KERNELS["bn_fwd"])
    row["serves"] = row["serves"][:-1]
    monkeypatch.setitem(KERNELS, "bn_fwd", row)
    errs = _errors(audit_kernel_coverage())
    assert [f.where for f in errs] == ["bn_fwd"]


def test_unstable_registry_factory_is_caught(monkeypatch):
    # a factory whose lookups compare unequal: one plan per lookup
    import repro_torch.configs.registry as registry

    class Unstable:
        pass

    monkeypatch.setitem(registry._REGISTRY, "unstable-arch", None)
    real_get = registry.get_config
    monkeypatch.setattr(registry, "get_config",
                        lambda name: Unstable() if name == "unstable-arch"
                        else real_get(name))
    findings = audit_registry_retrace(presets=SMOKE)
    errs = [f for f in _errors(findings)
            if f.check == "audit.trace.registry"]
    assert errs and all("unstable-arch" in f.where for f in errs)


# -- the launch family, on faked plans (nothing is built) --------------------

def _launch(**kw) -> Launch:
    base = dict(grid=(4, 2, 1), block=(256, 1, 1), smem=0, opt_in=False,
                tile=(64, 64, 0), extent=(256, 100, 0),
                strided=(False, False, False), kernel=0)
    return Launch(**{**base, **kw})


FAKE_PLANS = {
    "grid.y 65,536": ([_launch(grid=(1, 65536, 1), tile=(256, 1, 0),
                               extent=(256, 65536, 0))], "grid.y = 65536"),
    "240 KB of shared memory": ([_launch(smem=240 * 1024, opt_in=True)],
                                "exceed the card's 232448"),
    "60 KB without the opt-in": ([_launch(smem=60 * 1024)],
                                 "without the opt-in"),
    "2,048 threads": ([_launch(block=(2048, 1, 1))], "2048 threads"),
    "grid.x past 2^31 - 1": ([_launch(grid=(2 ** 31, 2, 1),
                                      tile=(1, 64, 0),
                                      extent=(2 ** 31, 100, 0))],
                             "grid.x = 2147483648"),
    "an uncovered extent": ([_launch(grid=(3, 2, 1))], "cover 192"),
    "a block wholly outside": ([_launch(grid=(5, 2, 1))],
                               "wholly outside"),
    "an empty grid": ([_launch(grid=(0, 2, 1))], "empty grid"),
    "blocks along no output axis": ([_launch(grid=(4, 2, 3))],
                                    "cuts no output"),
    "no launch": ([], "makes no launch"),
}


@pytest.mark.parametrize("fault", sorted(FAKE_PLANS))
def test_launch_family_catches_a_faked_plan(monkeypatch, fault):
    launches, needle = FAKE_PLANS[fault]

    def reader(decl, args, fn_kwargs):
        if decl.name != "spike_matmul":
            return [PlannedCall("e2a_other", (_launch(),))]
        return [PlannedCall("e2a_spike_matmul", tuple(launches))]

    monkeypatch.setattr(contracts, "read_launches", reader)
    findings = audit_kernel_matrix(presets=SMOKE, launches=True)
    errs = [f for f in _errors(findings)
            if f.check == "audit.kernel.launch"]
    assert errs and all("spike_matmul" in f.where for f in errs), \
        [f.format() for f in errs]
    assert any(needle in f.message for f in errs), \
        [f.format() for f in errs]
    assert launch_family_ran(findings)


def test_launch_family_passes_a_good_plan(monkeypatch):
    monkeypatch.setattr(
        contracts, "read_launches",
        lambda decl, args, kw: [PlannedCall("e2a_x", (_launch(
            grid=(4, 2, 65535), tile=(64, 64, 1), extent=(256, 100, 65535),
            smem=200 * 1024, opt_in=True),))])
    findings = audit_kernel_matrix(presets=SMOKE, launches=True)
    assert _errors(findings) == [] and launch_family_ran(findings)


def test_a_wrapper_that_reaches_no_entry_point_is_caught(monkeypatch):
    monkeypatch.setattr(contracts, "read_launches", lambda *a: [])
    errs = _errors(audit_kernel_matrix(presets=SMOKE, launches=True))
    assert errs and all("reached no entry point" in f.message for f in errs)


def test_plan_launches_leaves_the_counts_as_they_were(monkeypatch):
    """A wrapper counts its call inside ``build.plan_launches()`` as a
    launch; none was made, so the block ends with the counts it began
    with."""
    from repro_torch.kernels import neuron_layer

    monkeypatch.setattr(build, "load", lambda *a, **kw: None)
    before = launch_counts()
    with build.plan_launches() as calls:
        neuron_layer.neuron_layer_eval.launches += 3
    assert calls == [] and launch_counts() == before


# -- the oracle hold (launched on the card; here on the plain versions) ------

def _first_cases() -> dict:
    out = {}
    for _, decl, case in contracts.kernel_cases(batch=1, presets=SMOKE):
        try:
            decl.build(case)
        except kc.SkipCase:
            continue
        out.setdefault(decl.name, (decl, case))
    return out


@pytest.mark.parametrize("name", sorted(kc.kernel_contracts()))
def test_every_contract_holds_against_its_oracle(name):
    """``hold_against_oracle`` on the CPU, where each wrapper takes its
    plain version: every contract passes, and a neuron layer's spikes are
    the oracle's outside the band."""
    decl, case = _first_cases()[name]
    row = contracts.hold_against_oracle(decl, case,
                                        torch.Generator().manual_seed(0))
    assert row["ok"], row
    if name.startswith("neuron_layer"):
        assert row["spikes"]["wrong"] == 0 and row["spikes"]["total"] > 0
        assert (row["max_abs_err"] is None) == (name == "neuron_layer_eval")
    else:
        assert row["spikes"] is None and row["max_abs_err"] is not None


def test_spike_verdict_is_exact_outside_the_band():
    """Against the oracle's LIF on a current ``y``: its own spikes pass; a
    whole column flipped fails; a membrane put on the threshold may go
    either way (the steps after it judged along the kernel's own reset);
    the same flip far from the threshold, or a value other than 0 and 1,
    fails."""
    from repro_torch.kernels.ref import lif_soma_fwd_ref

    y = torch.randn(4, 196, 64, generator=torch.Generator().manual_seed(0))
    y = y * 1.2 + 0.3
    tol = torch.full_like(y, 1e-4)
    s = lif_soma_fwd_ref(y)[0]
    clean = contracts.spike_verdict(s, y, tol)
    assert clean["wrong"] == 0 and clean["total"] == s.numel()
    column = s.clone()
    column[:, :, 5] = 1 - column[:, :, 5]
    assert contracts.spike_verdict(column, y, tol)["wrong"] >= 196

    y[0, 0, 0] = 1.0
    y_kernel = y.clone()
    y_kernel[0, 0, 0] -= 1e-6                 # rounds the other way
    s_kernel = lif_soma_fwd_ref(y_kernel)[0]
    assert s_kernel[0, 0, 0] == 0 and lif_soma_fwd_ref(y)[0][0, 0, 0] == 1
    near = contracts.spike_verdict(s_kernel, y, tol)
    assert near["wrong"] == 0 and near["in_band"] >= 1

    y[0, 0, 0] = 3.0
    far = lif_soma_fwd_ref(y)[0]
    far[0, 0, 0] = 0
    assert contracts.spike_verdict(far, y, tol)["wrong"] >= 1
    half = lif_soma_fwd_ref(y)[0]
    half[-1, 2, 3] = 0.5                     # the last step: no reset after it
    assert contracts.spike_verdict(half, y, tol)["wrong"] == 1


@pytest.mark.parametrize("name", ["neuron_layer_eval", "neuron_layer_train"])
def test_a_wrong_spike_column_fails_the_oracle_hold(name):
    """A neuron layer whose spikes have one column inverted fails
    ``hold_against_oracle`` (the fault a mismatch fraction would pass)."""
    decl, case = _first_cases()[name]

    def doctored(*args, **kw):
        out = decl.fn(*args, **kw)
        s = (out[0] if isinstance(out, tuple) else out).clone()
        s[..., 0] = 1 - s[..., 0]
        return (s, *out[1:]) if isinstance(out, tuple) else s

    row = contracts.hold_against_oracle(
        dataclasses.replace(decl, fn=doctored), case,
        torch.Generator().manual_seed(0))
    assert not row["ok"]
    assert row["spikes"]["wrong"] >= case.t * case.m // 2


# -- CLI ---------------------------------------------------------------------

def test_cli_exits_zero_and_writes_json(tmp_path):
    out = tmp_path / "findings.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--contracts",
         "--json", str(out)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    payload = json.loads(out.read_text())
    assert payload["counts"]["error"] == 0
    assert {"level", "check", "where", "message"} <= \
        set(payload["findings"][0])
    checks = {f["check"] for f in payload["findings"]}
    assert {"audit.kernel.coverage", "audit.kernel.parity",
            "audit.kernel.launch", "audit.kernel.vjp"} <= checks
