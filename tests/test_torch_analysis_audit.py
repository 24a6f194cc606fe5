"""Tests for the port's execution-plan auditor
(``repro_torch.analysis.audit``), the counterparts of
``test_analysis_audit.py``: the current tree passes clean, and each injected
regression (a typo'd site override, an undeclared % 8 packing demotion, a
launch over the card's shared memory, a serving-cache slot-axis mismatch, a
bad tuned-table entry) is caught with the right check name and level."""
import dataclasses
import json

import pytest
import torch.distributed as dist

import repro_torch.analysis.audit as audit
import repro_torch.models.lm as lm
from repro_torch.analysis.audit import (audit_breaker, audit_mesh_plans,
                                        audit_serving_caches,
                                        audit_spikingformer_plans,
                                        audit_tuned_table,
                                        fused_site_geometries, run_audit)
from repro_torch.configs.spikingformer import (SPIKINGFORMER_PRESETS,
                                               get_spikingformer_config)
from repro_torch.core.policy import known_site_keys, named_policy
from repro_torch.tune.table import TunedBlocks, save_table, site_key


def _errors(findings):
    return [f for f in findings if f.level == "error"]


def test_clean_tree_audits_without_errors():
    findings = run_audit()
    assert _errors(findings) == [], \
        "\n".join(f.format() for f in _errors(findings))
    assert not dist.is_initialized()   # the mesh audit's group is gone


def test_typod_site_override_is_caught():
    # strict=False is the forward-compat escape hatch on the policy, so a
    # misspelled site (pssa.kqv) survives construction: the auditor is the
    # backstop that still refuses it
    pol = dataclasses.replace(named_policy("cuda"), strict=False)
    pol = pol.with_sites({"pssa.kqv": "cuda+spike_mm"})
    findings = audit_spikingformer_plans(
        presets=["spikingformer-smoke"], policies={"typod": pol})
    errs = _errors(findings)
    assert errs and all(f.check == "audit.plan.overrides" for f in errs)
    assert any("pssa.kqv" in f.message for f in errs)


def test_unexpected_packing_demotion_is_caught(monkeypatch):
    # d_model=36 breaks the % 8 packing contract at the pssa/smlp sites in a
    # way execution_plan does NOT mark expected
    base = SPIKINGFORMER_PRESETS["spikingformer-smoke"]
    monkeypatch.setitem(SPIKINGFORMER_PRESETS, "spikingformer-doctored",
                        dataclasses.replace(base, d_model=36))
    findings = audit_spikingformer_plans(
        presets=["spikingformer-doctored"],
        policies={"cuda-full": named_policy("cuda-full")})
    errs = [f for f in _errors(findings) if f.check == "audit.plan.packing"]
    assert errs, "doctored d_model=36 demotion not flagged"


def test_shared_memory_over_the_card_is_warned(monkeypatch):
    """A site whose launch asks for more shared memory than a block may
    have is a warning (``--strict`` makes it an error); the reads come from
    the plan exports (faked here: nothing is built)."""
    monkeypatch.setattr(audit, "site_smem", lambda cfg, batch: {
        "tokenizer.conv.0": 240 * 1024, "pssa.qkv": 129024})
    findings = audit_spikingformer_plans(
        presets=["spikingformer-8-512"],
        policies={"cuda-full": named_policy("cuda-full")}, smem=True)
    warns = [f for f in findings
             if f.level == "warning" and f.check == "audit.plan.smem"]
    assert [f.where for f in warns] == \
        ["spikingformer-8-512@cuda-full/tokenizer.conv.0"]
    assert _errors(findings) == []


def test_shared_memory_check_says_when_it_did_not_run():
    findings = audit_spikingformer_plans(presets=["spikingformer-smoke"],
                                         smem=False)
    rows = [f for f in findings if f.check == "audit.plan.smem"]
    assert [(f.level, f.where) for f in rows] == [("info", "not-run")]


def test_fused_geometries_cover_registered_sites():
    cfg = get_spikingformer_config("spikingformer-smoke")
    geoms = fused_site_geometries(cfg, batch=1)
    known = known_site_keys()
    for site, shape in geoms.items():
        assert site in known, site
        assert len(shape) == 4 and all(d > 0 for d in shape), (site, shape)


def test_serving_cache_axis_mismatch_is_caught(monkeypatch):
    # claim the slot axis is 0 for every leaf: layer-stacked caches are
    # (L, slots, ...), so the audit must see shape[0] != slots (slots=3:
    # the reduced configs have 4 layers, the default slot count)
    real = lm.cache_batch_axes

    def all_axis_zero(cfg, cache):
        from repro_torch.core.spikingformer import tree_map
        return tree_map(lambda _: 0, real(cfg, cache))

    monkeypatch.setattr(lm, "cache_batch_axes", all_axis_zero)
    findings = audit_serving_caches(arch_names=["qwen3-0.6b"], slots=3)
    errs = _errors(findings)
    assert errs and all(f.check == "audit.serving.cache" for f in errs)


def test_serving_cache_audit_is_clean_on_real_helpers():
    findings = audit_serving_caches(arch_names=["qwen3-0.6b", "rwkv6-7b",
                                                "zamba2-2.7b",
                                                "whisper-large-v3"])
    assert _errors(findings) == [], \
        "\n".join(f.format() for f in _errors(findings))
    assert any("whisper-large-v3" == f.where and "skipped" in f.message
               for f in findings)


def _key(site="pssa.proj", op="linear_bn", impl="cuda+spike_mm",
         shape=(4, 196, 512, 512), packed=True):
    return site_key(site, op, impl, shape, packed, device_kind="cpu")


def test_tuned_table_audit(tmp_path):
    good = tmp_path / "good.json"
    save_table(good, {_key(): TunedBlocks(block_m=256, block_k=64,
                                          block_c=128)})
    findings = audit_tuned_table(str(good))
    assert _errors(findings) == [] and "1 entries, 0 invalid" in \
        findings[-1].message

    bad = tmp_path / "bad.json"
    save_table(bad, {
        _key(site="pssa.kqv"): TunedBlocks(arm="fused"),
        _key(shape=(4, 196, 36, 512)): TunedBlocks(),
        _key(op="bn", impl="cuda"): TunedBlocks(),
        _key(site="smlp.a", impl="fused_epilogue"): TunedBlocks(arm="maybe"),
        _key(site="smlp.b"): TunedBlocks(block_m=100, block_k=64,
                                         block_c=128),
    })
    errs = _errors(audit_tuned_table(str(bad)))
    text = "\n".join(f.format() for f in errs)
    for needle in ("unknown site 'pssa.kqv'", "% 8 != 0", "no block knobs",
                   "unknown arm 'maybe'", "no tile of the spike matmul"):
        assert needle in text, (needle, text)

    old = tmp_path / "old.json"
    old.write_text(json.dumps({"version": 0, "entries": {}}))
    assert [f.check for f in _errors(audit_tuned_table(str(old)))] == \
        ["audit.tune.table"]


def test_no_tuned_table_is_an_info(monkeypatch):
    from repro_torch.tune import table

    monkeypatch.delenv(table.ENV_VAR, raising=False)
    monkeypatch.setattr(table, "DEFAULT_PATH",
                        table.DEFAULT_PATH.with_name("absent.json"))
    findings = audit_tuned_table()
    assert [(f.level, f.where) for f in findings] == [("info", "-")]


@pytest.mark.parametrize("shapes,expect", [(((1, 1),), "info"),
                                           (((2, 4),), "skipped")])
def test_mesh_audit_renders_on_the_shapes_the_ranks_hold(shapes, expect):
    findings = audit_mesh_plans(presets=["spikingformer-smoke"],
                                mesh_shapes=shapes)
    assert _errors(findings) == []
    if expect == "skipped":
        assert all("skipped" in f.message for f in findings)
    else:
        assert [f.where for f in findings] == \
            ["spikingformer-smoke/mesh=(1,1)"]
    assert not dist.is_initialized()


def test_the_breaker_audit_reports_one_warning_a_trip_and_none_without():
    from repro_torch.chaos.inject import chaos
    from repro_torch.chaos.schedule import FaultSchedule, FaultSpec
    from repro_torch.core.policy import dispatch_site, reset_breaker

    reset_breaker()
    assert audit_breaker() == []
    try:
        with chaos(FaultSchedule(faults=tuple(
                FaultSpec(f"chaos.kernel.{s}", 0, "raise")
                for s in ("pssa.qkv", "smlp.a")))):
            for site in ("pssa.qkv", "smlp.a", "pssa.qkv"):
                dispatch_site(site, "linear_bn", "cuda", lambda: "kernel",
                              fallback_impl="eager",
                              fallback_invoke=lambda: "eager")
        rows = audit_breaker()
        assert [(f.check, f.level, f.where) for f in rows] == [
            ("audit.breaker", "warning", "pssa.qkv"),
            ("audit.breaker", "warning", "smlp.a")]
        assert rows[0].message.startswith(
            "impl 'cuda' (op linear_bn) tripped -> 'eager': ChaosKernelFault")
    finally:
        reset_breaker()
    assert audit_breaker() == []
