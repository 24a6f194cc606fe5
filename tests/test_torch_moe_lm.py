"""The moe family of the LM (``reduced(mixtral-8x7b)``: 4 layers, d 64, 8
experts top-2, capacity factor 8) against the JAX package, both on the
CPU. The layer itself is in ``test_torch_moe.py``.

The reference's own parameters (converted by ``lm_from_jax``) and the
same numpy inputs go through both packages; fp32, tolerance 1e-5
scale-aware (max|a - b| <= 1e-5 * max(1, max|b|)) unless stated.
"""
import pytest

from _torch_port import (converted_leaves_match, decode_equals_forward,
                         decode_matches, engine_tokens_match,
                         family_loss_and_grads_match, forward_matches,
                         init_tree_matches, reset_equals_init, single_thread)

single_thread()
ARCH = "mixtral-8x7b"


# ---------------------------------------------------------------------------
# The moe family of the LM: reduced mixtral-8x7b
# ---------------------------------------------------------------------------

def test_init_lm_tree_has_the_reference_keys_shapes_and_specs():
    init_tree_matches(ARCH)


def test_lm_from_jax_carries_the_moe_leaves():
    keys = converted_leaves_match(ARCH)
    assert {"blocks/ffn/router", "blocks/ffn/w_gate",
            "blocks/ffn/w_down"} <= keys


@pytest.mark.parametrize("jax_policy", [None, "jnp", "pallas"])
def test_lm_forward_matches_reference(jax_policy):
    forward_matches(ARCH, jax_policy)


@pytest.mark.parametrize("jax_policy,at_init", [(None, False),
                                                ("jnp", False), (None, True)])
def test_lm_loss_and_gradients_match_reference(jax_policy, at_init):
    """``lm_loss`` (the MoE aux loss weighted in) and every gradient leaf,
    the experts' and the router's included, at the tolerances that
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
