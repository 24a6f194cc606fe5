"""The hybrid family of the LM (``reduced(zamba2-2.7b)``: 4 Mamba2 layers
in 2 groups, each group followed by the one weight-shared attention +
SwiGLU block; d 64, 8 SSD heads of 16, d_state 16, chunk 8) against the
JAX package, both on the CPU: the forward, and the loss with every
gradient leaf under ``remat`` or not. The mixer, the tree, decode, the
cache, the engine, checkpoints and C6 are in ``test_torch_ssm.py``.

The reference's own parameters (converted by ``lm_from_jax``) with the
leaves that the init leaves trivial drawn in numpy first
(``_torch_port.recurrent_params``, whose spread ``test_torch_ssm.py``
asserts) and the shared attention's query and key projections scaled by
``_torch_port.QK_SCALE``; the same numpy inputs. fp32, tolerance 1e-5
scale-aware (max|a - b| <= 1e-5 * max(1, max|b|)); the gradients as
``_torch_port._lm_grads_close``. Sequences of 16 (two chunks) and 13 (one
chunk, the reference's fallback).
"""
import numpy as np
import pytest
import torch

from _torch_port import (RECURRENT_TOKENS, forward_matches, lm_batch,
                         lm_cfgs, lm_loss_and_grads_match, recurrent_params,
                         single_thread)

from repro_torch.core.spikingformer import tree_leaves, tree_map
from repro_torch.models import lm as tlm

single_thread()
ARCH = "zamba2-2.7b"
SEQS = sorted(RECURRENT_TOKENS)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("jax_policy", [None, "jnp", "pallas"])
def test_lm_forward_matches_reference(jax_policy, seq):
    """Hidden states, prefill logits and the flash forward (the shared
    block's attention in chunks), branch spikes layer by layer."""
    forward_matches(ARCH, jax_policy, recurrent_params,
                    RECURRENT_TOKENS[seq])


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("jax_policy", [None, "jnp", "pallas"])
def test_lm_loss_and_gradients_match_reference(jax_policy, remat):
    """``lm_loss`` and every gradient leaf (the SSD's and the shared
    block's), with each group recomputed as a whole under ``remat``."""
    jcfg, tcfg = lm_cfgs(ARCH, jax_policy)
    jcfg, tcfg = jcfg.replace(remat=remat), tcfg.replace(remat=remat)
    lm_loss_and_grads_match(jcfg, tcfg, lm_batch(seq=16),
                            params=recurrent_params(jcfg))


def test_remat_recomputes_each_group_once(monkeypatch):
    """Under ``remat`` the two groups are checkpointed, not the Mamba2
    layers inside them a second time, and the gradients are bit-equal to
    those without."""
    jcfg, tcfg = lm_cfgs(ARCH, "jnp")
    _, tp = recurrent_params(jcfg)
    batch = {k: _t(v) for k, v in lm_batch(seq=16).items()}
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    grads = []
    for remat in (False, True):
        p = tree_map(lambda a: a.detach().requires_grad_(), tp)
        tlm.lm_loss(p, batch, tcfg.replace(remat=remat))[0].backward()
        grads.append([a.grad for a in tree_leaves(p)])
    assert len(calls) == 2
    assert all(torch.equal(a, b) for a, b in zip(*grads))
