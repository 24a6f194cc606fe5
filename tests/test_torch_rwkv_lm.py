"""The rwkv family of the LM (``reduced(rwkv6-7b)``: 4 layers, d 64, 4
heads of 16, chunk 8) against the JAX package, both on the CPU: the
forward, and the loss with every gradient leaf. The layers, decode, the
cache and the engine are in ``test_torch_rwkv.py``.

The reference's own parameters (converted by ``lm_from_jax``) with the
leaves that the init leaves trivial drawn in numpy first
(``_torch_port.recurrent_params``, whose spread ``test_torch_rwkv.py``
asserts), the same numpy inputs. fp32, tolerance 1e-5 scale-aware
(max|a - b| <= 1e-5 * max(1, max|b|)); the gradients as
``_torch_port._lm_grads_close``. Sequences of 16 (two chunks) and 13 (not
a multiple of the chunk: one chunk, the reference's fallback).
"""
import pytest

from _torch_port import (RECURRENT_TOKENS, forward_matches, lm_batch,
                         lm_cfgs, lm_loss_and_grads_match, recurrent_params,
                         single_thread)

single_thread()
ARCH = "rwkv6-7b"
SEQS = sorted(RECURRENT_TOKENS)


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("jax_policy", [None, "jnp", "pallas"])
def test_lm_forward_matches_reference(jax_policy, seq):
    forward_matches(ARCH, jax_policy, recurrent_params,
                    RECURRENT_TOKENS[seq])


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("jax_policy", [None, "jnp", "pallas"])
def test_lm_loss_and_gradients_match_reference(jax_policy, remat):
    """``lm_loss`` and every gradient leaf (``mu``, ``u_bonus``,
    ``decay_bias``, the projections, the norms), with each layer recomputed
    in the backward under ``remat``."""
    jcfg, tcfg = lm_cfgs(ARCH, jax_policy)
    jcfg, tcfg = jcfg.replace(remat=remat), tcfg.replace(remat=remat)
    lm_loss_and_grads_match(jcfg, tcfg, lm_batch(seq=16),
                            params=recurrent_params(jcfg))
