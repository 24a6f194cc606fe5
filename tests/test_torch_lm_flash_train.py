"""The port's LM loss and its gradient with ``flash_train`` on (the chunked
attention in the training forward) against the JAX package's, both on the
CPU, at reduced ``qwen3-0.6b`` (4 layers, d 64) without the LIF and with
it under ``jnp``/``eager`` and ``pallas`` (interpret mode)/``cuda`` (the
kernels' plain versions). Tolerances as in ``test_torch_lm_train.py``:
1e-5 scale-aware where every layer's branch spikes agree (they do at these
sizes), else max(2 sqrt(f), 1e-4) relative L2 on the gradients.
"""
import pytest

from _torch_port import POLICY_PAIRS, lm_batch, lm_cfgs, \
    lm_loss_and_grads_match, single_thread

single_thread()


@pytest.mark.parametrize("jax_policy",
                         [None] + [j for j, _ in POLICY_PAIRS
                                   if j != "pallas-full"])
def test_flash_train_loss_and_every_gradient_leaf_match_reference(
        jax_policy):
    jcfg, tcfg = lm_cfgs("qwen3-0.6b", jax_policy)
    lm_loss_and_grads_match(jcfg.replace(flash_train=True),
                            tcfg.replace(flash_train=True), lm_batch())
