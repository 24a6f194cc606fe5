"""The port's LM zoo (dense family) against the JAX package, both on the
CPU: the registry, the shared layers, attention (full, sliding, chunked,
decode against both cache kinds and both cache-update arms), the spiking
LM's forward and decode, ``lif_decode_step`` and the ``SyntheticLM``
stream.

Parameters come from the reference's ``init_lm`` and go through
``repro_torch.convert.lm_from_jax``; inputs from numpy seeds. Tolerance
1e-5, scale-aware (max|a - b| <= 1e-5 * max(1, max|b|): the same fp32
products summed in another order); spikes of the branch neuron sit behind reductions, so they are
compared by mismatch fraction per layer beside the hidden states (at
these sizes no membrane sits within rounding of the threshold and the
fraction is 0). ``lif_decode_step`` is elementwise: spikes bitwise, u to
1e-6, as the reference holds its own two arms.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import POLICY_PAIRS, jax_branch_spikes, lm_cfgs, \
    lm_params, mismatch_fraction, np_tree, single_thread, \
    torch_branch_spikes

from repro.configs import registry as jreg
from repro.core.lif import LIFConfig as JLIFConfig
from repro.core.lif import lif_decode_step as jlif_decode_step
from repro.core.policy import named_policy as jnamed_policy
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro.train.data import DataConfig as JDataConfig
from repro.train.data import SyntheticLM as JSyntheticLM
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_from_jax
from repro_torch.core.lif import LIFConfig, lif_decode_step, lif_step
from repro_torch.core.policy import named_policy
from repro_torch.core.spikingformer import tree_leaves
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp
from repro_torch.train.data import DataConfig, SyntheticLM

single_thread()
KEY = jax.random.PRNGKey(0)
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    """max|got - want| <= atol * max(1, max|want|), the convention of the
    other port tests (absolute on O(1) values, relative above)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=atol * scale, rtol=0)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def _same(jv, tv, where):
    if dataclasses.is_dataclass(jv):
        assert dataclasses.is_dataclass(tv), where
        jf = {f.name for f in dataclasses.fields(jv)}
        assert jf == {f.name for f in dataclasses.fields(tv)}, where
        for f in sorted(jf):
            _same(getattr(jv, f), getattr(tv, f), f"{where}.{f}")
    elif isinstance(tv, torch.dtype):
        assert np.dtype(jv).name == str(tv).removeprefix("torch."), where
    else:
        assert jv == tv and type(jv) is type(tv), (where, jv, tv)


@pytest.mark.parametrize("size", ["published", "reduced"])
@pytest.mark.parametrize("name", jreg.ASSIGNED)
def test_registry_equals_reference(name, size):
    jcfg, tcfg = jreg.get_config(name), treg.get_config(name)
    if size == "reduced":
        jcfg, tcfg = jreg.reduced(jcfg), treg.reduced(tcfg)
    _same(jcfg, tcfg, name)
    _same(jcfg.attn, tcfg.attn, f"{name}.attn")
    assert jcfg.head_dim == tcfg.head_dim
    assert jcfg.param_count() == tcfg.param_count()
    _same(jcfg.with_model_shards(16), tcfg.with_model_shards(16), name)


def test_registry_lists_equal_reference():
    assert treg.list_configs() == jreg.list_configs()
    assert treg.ASSIGNED == jreg.ASSIGNED
    assert treg.LONG_CONTEXT == jreg.LONG_CONTEXT
    qwen = treg.get_config("qwen3-0.6b")
    assert (qwen.num_layers, qwen.d_model, qwen.n_heads, qwen.n_kv_heads,
            qwen.head_dim, qwen.d_ff, qwen.vocab_size, qwen.qk_norm,
            qwen.rope_theta, qwen.tie_embeddings, qwen.dtype) == \
        (28, 1024, 16, 8, 128, 3072, 151936, True, 1e6, True, torch.bfloat16)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_norms_rope_embedding_and_loss_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2.0, (2, 5, 4, 16)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.normal(0, 0.3, 16).astype(np.float32)
    _close(tcommon.rmsnorm({"scale": _t(scale)}, _t(x), 1e-6),
           jcommon.rmsnorm({"scale": scale}, x, 1e-6))
    _close(tcommon.layernorm({"scale": _t(scale), "bias": _t(bias)}, _t(x)),
           jcommon.layernorm({"scale": scale, "bias": bias}, x))
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    for theta in (1e4, 1e6):
        _close(tcommon.apply_rope(_t(x), _t(pos), theta),
               jcommon.apply_rope(x, pos, theta))
    table = rng.normal(0, 0.02, (50, 16)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 5)).astype(np.int32)
    emb = tcommon.embed({"table": _t(table)}, _t(toks), torch.float32)
    _close(emb, jcommon.embed({"table": table}, toks, jnp.float32), 0)
    h = rng.normal(0, 1, (2, 5, 16)).astype(np.float32)
    logits = tcommon.unembed({"table": _t(table)}, _t(h))
    _close(logits, jcommon.unembed({"table": table}, h))
    labels = rng.integers(0, 50, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.7).astype(np.float32)
    for m in (None, mask):
        _close(tcommon.cross_entropy_loss(
            logits, _t(labels), None if m is None else _t(m)),
            jcommon.cross_entropy_loss(np.asarray(logits.numpy()), labels, m))


def test_init_lm_tree_has_the_reference_keys_shapes_and_specs():
    jcfg, tcfg = lm_cfgs("qwen3-0.6b", "jnp")
    jp, jspecs = jcommon.split_tree(jlm.init_lm(KEY, jcfg))
    tp, tspecs = tcommon.split_tree(
        tlm.init_lm(torch.Generator().manual_seed(0), tcfg, "cpu"))
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(tree_leaves(tp)) == len(jleaves)
    for path, leaf in jleaves:
        node, spec = tp, tspecs
        jspec = jspecs
        for k in path:
            node, spec, jspec = node[k.key], spec[k.key], jspec[k.key]
        assert tuple(node.shape) == leaf.shape, path
        assert node.dtype == torch.float32
        assert spec == tuple(jspec), path


def test_swiglu_and_gelu_mlp_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 5, 16)).astype(np.float32)
    jp = np_tree(jcommon.split_tree(jmlp.init_swiglu(KEY, 16, 48))[0])
    tp = lm_from_jax(jp, device="cpu")
    _close(tmlp.swiglu(tp, _t(x)), jmlp.swiglu(jp, x))
    jp = np_tree(jcommon.split_tree(jmlp.init_gelu_mlp(KEY, 16, 48))[0])
    jp["b_in"] = rng.normal(0, 0.5, 48).astype(np.float32)
    _close(tmlp.gelu_mlp(lm_from_jax(jp, device="cpu"), _t(x)),
           jmlp.gelu_mlp(jp, x))


ATTN_CASES = {
    "gqa-qknorm": dict(n_heads=4, n_kv_heads=2, qk_norm=True),
    "mha-bias": dict(n_heads=4, n_kv_heads=4, qkv_bias=True),
    "sliding": dict(n_heads=4, n_kv_heads=2, sliding_window=3),
}


def _attn(case, **extra):
    kw = dict(d_model=32, d_head=8, rope_theta=1e4, **ATTN_CASES[case],
              **extra)
    jcfg, tcfg = jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)
    jp = np_tree(jcommon.split_tree(jattn.init_attention(KEY, jcfg))[0])
    rng = np.random.default_rng(2)
    for k in ("bq", "bk", "bv"):
        if k in jp:
            jp[k] = rng.normal(0, 0.3, jp[k].shape).astype(np.float32)
    return jcfg, tcfg, jp, lm_from_jax(jp, device="cpu")


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_and_flash_match_reference(case):
    jcfg, tcfg, jp, tp = _attn(case)
    x = np.random.default_rng(3).normal(0, 1, (2, 12, 32)).astype(np.float32)
    want = jattn.attention(jp, x, jcfg)
    _close(tattn.attention(tp, _t(x), tcfg), want)
    for chunk in (4, 5, 1024):      # 3 chunks, 2 ragged chunks, 1 chunk
        _close(tattn.flash_attention(tp, _t(x), tcfg, kv_chunk=chunk),
               jattn.flash_attention(jp, x, jcfg, kv_chunk=chunk))
    _close(tattn.flash_attention(tp, _t(x), tcfg, kv_chunk=4), want)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
def test_flash_core_matches_reference(causal, window):
    rng = np.random.default_rng(4)
    q, k = (rng.normal(0, 1, (2, 16, 3, 8)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(0, 1, (2, 16, 3, 6)).astype(np.float32)
    kw = dict(scale=8 ** -0.5, causal=causal, sliding_window=window,
              kv_chunk=4)
    _close(tattn.flash_core(_t(q), _t(k), _t(v), **kw),
           jattn.flash_core(q, k, v, **kw))


@pytest.mark.parametrize("scatter", [False, True])
@pytest.mark.parametrize("case", ["gqa-qknorm", "sliding"])
def test_attention_decode_matches_reference(case, scatter):
    """Ten decode steps of two rows at different positions: the dense cache
    (written at pos) and the sliding window's ring buffer (size 3, so it
    wraps), through the one-hot and the scatter update."""
    jcfg, tcfg, jp, tp = _attn(case, scatter_cache=scatter)
    max_seq = 16
    jc = jattn.init_kv_cache(2, jcfg, max_seq, jnp.float32)
    tc = tattn.init_kv_cache(2, tcfg, max_seq, torch.float32)
    assert tuple(tc["k"].shape) == jc["k"].shape
    rng = np.random.default_rng(5)
    pos = np.array([0, 3], np.int32)
    for _ in range(10):
        x = rng.normal(0, 1, (2, 1, 32)).astype(np.float32)
        jout, jc = jattn.attention_decode(jp, x, jc, pos, jcfg)
        tout, tc_new = tattn.attention_decode(tp, _t(x), tc, _t(pos), tcfg)
        assert tc_new["k"] is not tc["k"]          # functional update
        tc = tc_new
        _close(tout, jout)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])
        pos = pos + 1


# ---------------------------------------------------------------------------
# The spiking LM: forward, decode
# ---------------------------------------------------------------------------

TOKENS = np.array([[3, 7, 11, 2, 5, 9, 300, 41],
                   [8, 8, 1, 0, 511, 17, 5, 6]], np.int32)


@pytest.mark.parametrize("jax_policy", [None] + [j for j, _ in POLICY_PAIRS
                                                 if j != "pallas-full"])
def test_lm_forward_matches_reference(jax_policy):
    """Reduced qwen3-0.6b, without the LIF and with it under jnp/eager and
    pallas (interpret)/cuda (plain versions on the CPU): hidden states and
    prefill logits at 1e-5, branch spikes compared layer by layer."""
    jcfg, tcfg = lm_cfgs("qwen3-0.6b", jax_policy)
    jp, tp = lm_params(jcfg)
    jh, jaux = jlm.lm_forward(jp, {"tokens": TOKENS}, jcfg)
    th, taux = tlm.lm_forward(tp, {"tokens": _t(TOKENS)}, tcfg)
    mism = []
    if jax_policy is not None:
        mism = [mismatch_fraction(t, j) for t, j in
                zip(torch_branch_spikes(tp, _t(TOKENS), tcfg),
                    jax_branch_spikes(jp, TOKENS, jcfg))]
        assert len(mism) == jcfg.num_layers
    assert not any(mism), f"branch spike mismatch per layer {mism}"
    _close(th, jh)
    assert float(taux) == float(jaux) == 0.0
    _close(tlm.lm_prefill(tp, {"tokens": _t(TOKENS)}, tcfg),
           jlm.lm_prefill(jp, {"tokens": TOKENS}, jcfg))
    _close(tlm.lm_forward(tp, {"tokens": _t(TOKENS)}, tcfg, use_flash=True)[0],
           jh)


@pytest.mark.parametrize("jax_policy", [None, "jnp", "pallas"])
def test_lm_decode_step_matches_reference(jax_policy):
    """Six decode steps of two rows from the same cache: logits and every
    cache leaf (KV and, spiking, the (U, S) carry) at 1e-5."""
    jcfg, tcfg = lm_cfgs("qwen3-0.6b", jax_policy)
    jp, tp = lm_params(jcfg)
    jc = jlm.init_cache(jcfg, 2, 16, jnp.float32)
    tc = tlm.init_cache(tcfg, 2, 16, torch.float32, "cpu")
    assert [tuple(a.shape) for a in tree_leaves(tc)] == \
        [a.shape for a in jax.tree.leaves(jc)]
    pos = np.array([0, 2], np.int32)
    for t in range(6):
        tok = TOKENS[:, t:t + 1]
        jl, jc = jlm.lm_decode_step(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(pos), jcfg)
        tl, tc = tlm.lm_decode_step(tp, tc, _t(tok), _t(pos), tcfg)
        _close(tl, jl)
        for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
            _close(a, b)
        pos = pos + 1


@pytest.mark.parametrize("policy", ["eager", "cuda"])
def test_spiking_decode_matches_forward(policy):
    """The reference's own check, on the port: token-by-token decode of the
    spiking LM (the (U, S) carry in the cache) equals the full-sequence
    forward at 1e-5."""
    jcfg, _ = lm_cfgs("qwen3-0.6b", "jnp")
    tcfg = treg.reduced(treg.get_config("qwen3-0.6b")).replace(
        lif=LIFConfig(policy=named_policy(policy)))
    _, tp = lm_params(jcfg)
    toks = _t(TOKENS[:1])
    x, _ = tlm.lm_forward(tp, {"tokens": toks}, tcfg)
    want = tcommon.unembed(tp["embed"], x)[0]
    cache = tlm.init_cache(tcfg, 1, 32, torch.float32, "cpu")
    for t in range(toks.shape[1]):
        lg, cache = tlm.lm_decode_step(tp, cache, toks[:, t:t + 1],
                                       torch.tensor([t]), tcfg)
        np.testing.assert_allclose(lg[0].numpy(), want[t].numpy(),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("jax_policy", ["jnp", "pallas"])
def test_lif_decode_step_matches_reference(jax_policy):
    """The serving step's SOMA update: the port's (kernel wrapper's plain
    version under cuda, ``lif_step`` under eager) against the reference's
    (the Pallas carry kernel in interpret mode, or jnp)."""
    rng = np.random.default_rng(6)
    x = (rng.normal(0, 1, (4, 64)) * 2.0).astype(np.float32)
    u0 = rng.normal(0, 1, (4, 64)).astype(np.float32)
    s0 = (rng.random((4, 64)) > 0.5).astype(np.float32)
    jcfg = JLIFConfig(policy=jnamed_policy(jax_policy))
    tcfg = LIFConfig(policy=named_policy(dict(POLICY_PAIRS)[jax_policy]))
    js, (ju, jss) = jlif_decode_step(jnp.asarray(x), jnp.asarray(u0),
                                     jnp.asarray(s0), jcfg)
    ts, (tu, tss) = lif_decode_step(_t(x), _t(u0), _t(s0), tcfg)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tss.numpy(), np.asarray(jss))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-6, rtol=0)
    # A 1-D input folds to (1, D) and takes the same arm as a 2-D one; a
    # 0-D input has no feature axis and the kernel arm refuses it.
    s1, (u1, ss1) = lif_decode_step(_t(x[0]), _t(u0[0]), _t(s0[0]), tcfg)
    ru, rs = lif_step(_t(u0[0]), _t(s0[0]), _t(x[0]), tcfg)
    assert s1.shape == (64,)
    assert torch.equal(s1, rs) and torch.equal(ss1, rs) and torch.equal(u1, ru)
    np.testing.assert_array_equal(s1.numpy(), ts[0].numpy())
    if tcfg.policy.backend == "cuda":
        with pytest.raises(ValueError, match="0-D"):
            lif_decode_step(_t(x[0, 0]), _t(u0[0, 0]), _t(s0[0, 0]), tcfg)


def test_cuda_decode_carry_equals_lif_step_bitwise():
    """``_LifSomaCarry`` folds the carry into x[0] before the SOMA kernel:
    x + alpha*u0*(1-s0) against ``lif_step``'s alpha*u0*(1-s0) + x, the
    same operations in the same order, equal bit for bit (signed zeros
    aside, which no spike or later step can see)."""
    rng = np.random.default_rng(7)
    x = (rng.normal(0, 1, (8, 256)) * 2.0).astype(np.float32)
    x[0, :8] = [0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 2.0, 1e-30]
    u0 = rng.normal(0, 1, (8, 256)).astype(np.float32)
    u0[0, :8] = [-0.0, 0.0, 0.0, 2.0, 1.0, -1.0, 0.0, -1e-30]
    s0 = (rng.random((8, 256)) > 0.5).astype(np.float32)
    eager = LIFConfig()
    cuda = LIFConfig(policy=named_policy("cuda"))
    (es, (eu, _)), (cs, (cu, _)) = (
        lif_decode_step(_t(x), _t(u0), _t(s0), c) for c in (eager, cuda))
    assert torch.equal(es, cs) and torch.equal(eu, cu)


@pytest.mark.parametrize("name", ["rwkv6-7b", "zamba2-2.7b",
                                  "whisper-large-v3", "pixtral-12b"])
def test_unported_families_raise(name):
    cfg = treg.reduced(treg.get_config(name))
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: tlm.init_lm(gen, cfg, "cpu"),
                 lambda: tlm.init_cache(cfg, 1, 8, torch.float32, "cpu"),
                 lambda: tlm.lm_forward({}, {"tokens": _t(TOKENS)}, cfg)):
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            call()


def test_synthetic_lm_batches_are_the_reference_s():
    for kw in (dict(vocab_size=512, seq_len=16, global_batch=4),
               dict(vocab_size=151936, seq_len=64, global_batch=8, seed=3,
                    branching=2)):
        j, t = JSyntheticLM(JDataConfig(**kw)), SyntheticLM(DataConfig(**kw))
        np.testing.assert_array_equal(t.table, j.table)
        for step, host, count in ((0, 0, 1), (5, 1, 2)):
            jb, tb = j.batch(step, host, count), t.batch(step, host, count)
            assert sorted(tb) == sorted(jb)
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k])
                assert tb[k].dtype == jb[k].dtype


def test_shard_helpers_are_the_identity_on_one_device():
    x = torch.ones(2, 3)
    assert tcommon.shard(x, "data", None) is x
    assert tcommon.shard_batch(x, None) is x
    assert tcommon.mesh_axis_size("model") is None
