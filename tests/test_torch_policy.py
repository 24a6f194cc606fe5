"""The port's execution policy, registry and presets against the JAX
package's: same sites, same ops, same decisions, names mapped through
``IMPL_FROM_JAX`` / ``POLICY_FROM_JAX``."""
import dataclasses

import pytest

from _torch_port import POLICY_PAIRS, translate_impl, translate_note

from repro.configs.spikingformer import (SPIKINGFORMER_PRESETS as JAX_PRESETS,
                                         get_spikingformer_config as jax_cfg)
from repro.core import policy as jpol
from repro_torch.configs import (SPIKINGFORMER_PRESETS,
                                 get_spikingformer_config,
                                 list_spikingformer_configs)
from repro_torch.core import policy as tpol
from repro_torch.core.policy import (ExecutionPolicy, IMPL_FROM_JAX,
                                     POLICY_FROM_JAX, named_policy,
                                     plan_sites)

PRESETS = sorted(JAX_PRESETS)


def _rows(plan):
    return [(r.site, r.op, r.requested, r.effective, r.note, r.expected)
            for r in plan]


def _translated(plan):
    return [(r.site, r.op, translate_impl(r.requested),
             translate_impl(r.effective), translate_note(r.note), r.expected)
            for r in plan]


@pytest.mark.parametrize("jax_policy,port_policy", POLICY_PAIRS)
@pytest.mark.parametrize("preset", PRESETS)
def test_plan_rows_equal_reference(preset, jax_policy, port_policy):
    want = jax_cfg(f"{preset}@{jax_policy}").execution_plan()
    got = get_spikingformer_config(f"{preset}@{port_policy}").execution_plan()
    assert _rows(got) == _translated(want)


@pytest.mark.parametrize("jax_policy,port_policy", POLICY_PAIRS)
def test_plan_rows_equal_reference_under_time_chunk(jax_policy, port_policy):
    want = jax_cfg(f"spikingformer-smoke@{jax_policy}",
                   time_chunk=1).execution_plan()
    got = get_spikingformer_config(f"spikingformer-smoke@{port_policy}",
                                   time_chunk=1).execution_plan()
    assert _rows(got) == _translated(want)
    assert any(r.op == "lif_state" for r in got)


def test_presets_have_the_reference_fields():
    assert list_spikingformer_configs() == PRESETS
    skip = {"dtype", "policy", "lif"}
    for name in PRESETS:
        j, t = JAX_PRESETS[name], SPIKINGFORMER_PRESETS[name]
        for f in dataclasses.fields(t):
            if f.name not in skip:
                assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
        for f in ("alpha", "th_fire", "th_lo", "th_hi", "grad_scale",
                  "time_chunk"):
            assert getattr(t.lif, f) == getattr(j.lif, f)
        assert t.tokenizer_stage_channels() == j.tokenizer_stage_channels()
        assert t.param_count() == j.param_count()
        assert t.num_tokens == j.num_tokens


def test_describe_execution_is_the_reference_table():
    want = jax_cfg("spikingformer-8-512@pallas-full").describe_execution()
    want = want.split("\n\n")[0].splitlines()[1:]      # the plan table only
    got, tuned, sharding = get_spikingformer_config(
        "spikingformer-8-512@cuda-full").describe_execution().split("\n\n")
    got = got.splitlines()
    assert tuned.startswith("# TunedBlocks device=")   # the tuned block
    assert sharding == jax_cfg("spikingformer-8-512").describe_sharding()
    assert got[0] == "# ExecutionPolicy backend=cuda"
    assert got[1] == want[0] == "site,op,requested,effective,note"
    assert got[2:] == [translate_note(ln) for ln in want[1:]]


def test_every_reference_impl_has_a_counterpart():
    want = {(op, translate_impl(impl)) for op, impl in jpol.registered_kernels()}
    assert want <= set(tpol.registered_kernels())
    assert set(IMPL_FROM_JAX) == {i for _, i in jpol.registered_kernels()}


def test_default_impls_and_fallback_tables_match_reference():
    assert tpol.OPS == jpol.OPS
    for op in jpol.OPS:
        for jb, tb in (("jnp", "eager"), ("pallas", "cuda")):
            assert tpol.default_impl(op, tb) == \
                translate_impl(jpol.default_impl(op, jb))
        for jimpl, timpl in IMPL_FROM_JAX.items():
            for fn in ("packed_fallback", "fused_epilogue_fallback"):
                want = getattr(jpol, fn)(op, jimpl)
                got = getattr(tpol, fn)(op, timpl)
                assert got == (translate_impl(want) if want else None)


def test_named_policies_map_one_to_one():
    assert sorted(POLICY_FROM_JAX) == jpol.list_named_policies()
    assert sorted(POLICY_FROM_JAX.values()) == tpol.list_named_policies()
    for jname, tname in POLICY_FROM_JAX.items():
        j, t = jpol.named_policy(jname), named_policy(tname)
        assert t.backend == translate_impl(j.backend)
        assert t.overrides == tuple(sorted(
            (k, translate_impl(v)) for k, v in j.overrides))
    with pytest.raises(ValueError, match="unknown policy"):
        named_policy("pallas-full")


def test_resolution_precedence_site_group_op_backend():
    p = ExecutionPolicy(backend="cuda", overrides={
        "tokenizer.conv.2": "eager", "tokenizer.conv": "cuda_packed",
        "conv": "fused_epilogue", "pssa.qkv": "cuda+spike_mm"})
    assert p.resolve("tokenizer.conv.2", "conv") == "eager"         # site
    assert p.resolve("tokenizer.conv.1", "conv") == "cuda_packed"   # group
    assert p.resolve("other.conv", "conv") == "fused_epilogue"      # op
    assert p.resolve("pssa.qkv", "linear_bn") == "cuda+spike_mm"
    assert p.resolve("smlp.a", "linear_bn") == "cuda"               # backend
    assert p.resolve("attn_qk", "attn_qk") == "eager"  # cuda keeps einsum


def test_policy_is_hashable_and_canonical():
    a = ExecutionPolicy(backend="cuda", overrides={"bn": "eager",
                                                   "lif": "cuda"})
    b = ExecutionPolicy(backend="cuda", overrides=(("lif", "cuda"),
                                                   ("bn", "eager")))
    assert a == b and hash(a) == hash(b)
    assert a.with_sites({"bn": None}).overrides == (("lif", "cuda"),)
    assert ExecutionPolicy(strict=False, overrides={"x.y": "eager"}) == \
        ExecutionPolicy(strict=False, overrides={"x.y": "eager"})


def test_unknown_backend_site_and_impl_fail_early():
    with pytest.raises(ValueError, match="unknown backend"):
        ExecutionPolicy(backend="pallas")
    with pytest.raises(ValueError, match="name no registered site"):
        ExecutionPolicy(overrides={"pssa.qvk": "cuda"})
    cfg = get_spikingformer_config("spikingformer-smoke")
    with pytest.raises(KeyError, match="no implementation"):
        plan_sites(ExecutionPolicy(overrides={"lif": "bogus"}),
                   cfg.execution_site_specs())
    with pytest.raises(ValueError, match="match no site"):
        plan_sites(ExecutionPolicy(overrides={"lm.ffn": "cuda"}, strict=False),
                   cfg.execution_site_specs())


def test_plan_demotions_are_shape_driven():
    rows = {r.site: r for r in get_spikingformer_config(
        "spikingformer-8-512@cuda-full").execution_plan()}
    assert rows["attn_av"].effective == "eager"          # 196 % 8 != 0
    assert rows["attn_av"].expected
    assert rows["attn_qk"].effective == "cuda_packed"
    assert rows["pssa.proj"].effective == "cuda+spike_mm"  # no trailing LIF
    assert rows["smlp.b"].effective == "cuda+spike_mm"
    assert rows["tokenizer.conv.0"].effective == "fused_epilogue"
    assert "dense arm" in rows["tokenizer.conv.0"].note    # float image
    ragged = plan_sites(ExecutionPolicy(backend="cuda", overrides={
        "linear_bn": "cuda+spike_mm"}), [("smlp.a", "linear_bn", 20)])
    assert ragged[0].effective == "cuda" and not ragged[0].expected


def test_dispatch_lets_a_raising_kernel_raise():
    """No circuit breaker in the port: a kernel that raises is not demoted
    to the eager implementation."""
    @tpol.register_kernel("bn", "test-raises")
    def _boom(*args):
        raise RuntimeError("kernel failed")
    try:
        with pytest.raises(RuntimeError, match="kernel failed"):
            tpol.dispatch_kernel("tokenizer.bn", "bn", "test-raises")
        assert not hasattr(tpol, "dispatch_site")
    finally:
        tpol.unregister_kernel("bn", "test-raises")
    assert "test-raises" not in tpol.available_impls("bn")


def test_policy_suffix_kwarg_and_environment(monkeypatch):
    full = named_policy("cuda-full")
    assert get_spikingformer_config("spikingformer-smoke@cuda-full").policy \
        == full
    assert get_spikingformer_config("spikingformer-smoke",
                                    policy=full).policy == full
    monkeypatch.setenv("REPRO_BACKEND", "cuda")
    assert get_spikingformer_config("spikingformer-smoke").policy == \
        named_policy("cuda")
    assert tpol.default_policy() == named_policy("cuda")
    # an explicit suffix wins over the environment
    assert get_spikingformer_config("spikingformer-smoke@eager").policy == \
        named_policy("eager")
    monkeypatch.setenv("REPRO_BACKEND", "pallas-full")
    with pytest.raises(ValueError, match="unknown policy"):
        get_spikingformer_config("spikingformer-smoke")


def test_fallback_logging_levels(caplog):
    import logging
    cfg = get_spikingformer_config("spikingformer-8-512@cuda-full")
    tpol._reported_fallbacks.clear()
    with caplog.at_level(logging.INFO, logger="repro_torch.execution"):
        tpol.log_fallbacks(cfg.execution_plan())
        tpol.runtime_fallback("smlp.a", "cuda+spike_mm", "ragged -> dense")
    levels = {r.levelname for r in caplog.records}
    assert levels == {"INFO", "WARNING"}
    assert all(r.levelname == "INFO" for r in caplog.records
               if "attn_av" in r.getMessage())
