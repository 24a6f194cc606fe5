"""The port's multi-head latent attention (``repro_torch.models.mla``) and
the LM that needs both it and the mixture of experts
(``reduced(deepseek-v2-236b)``) against the JAX package, both on the CPU.

The reference's own parameters (converted by ``lm_from_jax``) and the same
numpy inputs go through both packages; fp32, tolerance 1e-5 scale-aware
(max|a - b| <= 1e-5 * max(1, max|b|)) unless stated.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (close_scaled, converted_leaves_match,
                         decode_equals_forward, decode_matches,
                         engine_tokens_match, family_loss_and_grads_match,
                         forward_matches, init_tree_matches, np_tree,
                         reset_equals_init, single_thread)

from repro.configs import registry as jreg
from repro.models import common as jcommon
from repro.models import mla as jmla
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_from_jax
from repro_torch.models import lm as tlm
from repro_torch.models import mla as tmla

single_thread()
KEY = jax.random.PRNGKey(0)
ARCH = "deepseek-v2-236b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _mla():
    """The reduced config's MLA (d 64, 4 heads, q_lora 32, kv_lora 16,
    nope 16 + rope 8, v 16) with the reference's parameters, the norms'
    scales drawn away from 1."""
    jcfg = jreg.reduced(jreg.get_config(ARCH)).mla
    tcfg = treg.reduced(treg.get_config(ARCH)).mla
    jp = np_tree(jcommon.split_tree(jmla.init_mla(KEY, jcfg))[0])
    rng = np.random.default_rng(0)
    for k in ("q_norm", "kv_norm"):
        jp[k]["scale"] = rng.uniform(0.5, 1.5, jp[k]["scale"].shape).astype(
            np.float32)
    return jcfg, tcfg, jp, lm_from_jax(jp, device="cpu")


def test_mla_config_and_tree_match_reference():
    jcfg, tcfg, jp, tp = _mla()
    assert (tcfg.qk_head, tcfg.kv_lora, tcfg.qk_rope) == (jcfg.qk_head, 16, 8)
    for k in ("w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "wo"):
        assert tuple(tp[k].shape) == jp[k].shape
    init = tmla.init_mla(torch.Generator().manual_seed(0), tcfg)
    assert {k: tuple(v.value.shape) for k, v in init.items()
            if k not in ("q_norm", "kv_norm")} == \
        {k: jp[k].shape for k in jp if k not in ("q_norm", "kv_norm")}


def test_latent_and_queries_match_reference():
    """The latent (c_kv, the one-head RoPE key) and the queries, at
    positions off the diagonal."""
    jcfg, tcfg, jp, tp = _mla()
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 6, 64)).astype(np.float32)
    pos = rng.integers(0, 200, (2, 6)).astype(np.int32)
    for got, want in zip((*tmla._latent(tp, _t(x), tcfg, _t(pos)),
                          *tmla._queries(tp, _t(x), tcfg, _t(pos))),
                         (*jmla._latent(jp, x, jcfg, pos),
                          *jmla._queries(jp, x, jcfg, pos))):
        assert tuple(got.shape) == want.shape
        close_scaled(got.numpy(), want)


@pytest.mark.parametrize("seq", [5, 16])
def test_mla_attention_and_flash_match_reference(seq):
    """The naive prefill, and the flash prefill at ``kv_chunk=8`` (two
    chunks at S = 16, one at S = 5), against the reference's each."""
    jcfg, tcfg, jp, tp = _mla()
    x = np.random.default_rng(2).normal(0, 1, (2, seq, 64)).astype(np.float32)
    want = jmla.mla_attention(jp, x, jcfg)
    close_scaled(tmla.mla_attention(tp, _t(x), tcfg).numpy(), want)
    close_scaled(tmla.mla_flash_attention(tp, _t(x), tcfg, kv_chunk=8)
                 .numpy(), jmla.mla_flash_attention(jp, x, jcfg, kv_chunk=8))
    close_scaled(tmla.mla_flash_attention(tp, _t(x), tcfg, kv_chunk=8)
                 .numpy(), want)


def test_mla_decode_matches_reference_token_by_token():
    """Ten absorbed decode steps of two rows at different positions from
    the same latent cache: the output and both cache leaves ("c", "kr")
    at 1e-5, the cache passed in left as it was; the rows' outputs also
    against the naive prefill's, at the positions decoded from 0."""
    jcfg, tcfg, jp, tp = _mla()
    jc = jmla.init_mla_cache(2, jcfg, 16, jnp.float32)
    tc = tmla.init_mla_cache(2, tcfg, 16, torch.float32)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    rng = np.random.default_rng(3)
    xs = rng.normal(0, 1, (2, 10, 64)).astype(np.float32)
    pos = np.array([0, 4], np.int32)
    outs = []
    for t in range(10):
        x = xs[:, t:t + 1]
        jout, jc = jmla.mla_decode(jp, x, jc, pos, jcfg)
        before = {k: v.clone() for k, v in tc.items()}
        tout, tc_new = tmla.mla_decode(tp, _t(x), tc, _t(pos), tcfg)
        assert all(torch.equal(tc[k], before[k]) for k in tc)
        tc = tc_new
        close_scaled(tout.numpy(), jout)
        for k in ("c", "kr"):
            close_scaled(tc[k].numpy(), jc[k])
        outs.append(tout[0, 0])
        pos = pos + 1
    close_scaled(torch.stack(outs).numpy(),
                 jmla.mla_attention(jp, xs[:1], jcfg)[0])


# ---------------------------------------------------------------------------
# The LM: reduced deepseek-v2-236b (MLA + MoE with shared experts)
# ---------------------------------------------------------------------------

def test_init_lm_tree_has_the_reference_keys_shapes_and_specs():
    init_tree_matches(ARCH)


def test_lm_from_jax_carries_the_mla_and_moe_leaves():
    keys = converted_leaves_match(ARCH)
    assert {"blocks/attn/w_uk", "blocks/attn/w_dkv", "blocks/ffn/router",
            "blocks/ffn/shared/w_gate", "blocks/ffn/w_down"} <= keys


@pytest.mark.parametrize("jax_policy", [None, "jnp", "pallas"])
def test_lm_forward_matches_reference(jax_policy):
    forward_matches(ARCH, jax_policy)


@pytest.mark.parametrize("jax_policy,at_init", [(None, False),
                                                ("jnp", False), (None, True)])
def test_lm_loss_and_gradients_match_reference(jax_policy, at_init):
    """``lm_loss`` and every gradient leaf (MLA's, the shared and routed
    experts', the router's) at the tolerances that
    ``_torch_port.GRAD_REL_L2_AT_INIT`` explains."""
    family_loss_and_grads_match(ARCH, jax_policy, at_init)


@pytest.mark.parametrize("jax_policy", [None, "jnp"])
def test_lm_decode_step_matches_reference(jax_policy):
    decode_matches(ARCH, jax_policy)


@pytest.mark.parametrize("policy", ["eager", "cuda"])
def test_spiking_decode_matches_forward(policy):
    decode_equals_forward(ARCH, policy)


@pytest.mark.parametrize("spiking", [False, True])
def test_reset_cache_slots_matches_init(spiking):
    reset_equals_init(ARCH, spiking)


@pytest.mark.parametrize("spiking", [False, True])
def test_engine_tokens_equal_the_reference_engine(spiking):
    engine_tokens_match(ARCH, spiking)


def test_mla_cache_layout_is_stacked_by_slot():
    """Every MLA cache leaf is (L, slots, ...): the engine's reset and
    slot views need no family case."""
    cfg = treg.reduced(treg.get_config(ARCH))
    cache = tlm.init_cache(cfg, 3, 16, torch.float32, "cpu")
    assert sorted(cache) == ["c", "kr"]
    assert tuple(cache["c"].shape) == (4, 3, 16, 16)
    assert tuple(cache["kr"].shape) == (4, 3, 16, 8)
    one = tlm.cache_slot_state(cache, 1, cfg)
    assert tuple(one["c"].shape) == (4, 16, 16)
