"""The port's LM loss and its gradient against the JAX package's, both on
the CPU (the train step is in ``test_torch_lm_train_step.py``), at reduced
``qwen3-0.6b`` (4 layers, d 64) without the LIF and with it under
``jnp``/``eager`` and ``pallas`` (interpret mode, so the reference's GRAD
is its Pallas ``lif_soma_bwd``)/``cuda`` (the kernels' plain versions).

Parameters come from the reference's ``init_lm`` through
``convert.lm_from_jax``, batches from ``SyntheticLM``. Tolerance: 1e-5,
scale-aware (max|a - b| <= 1e-5 * max(1, max|b|): the same fp32 products
summed in another order), on the loss, the metrics and every gradient
leaf, as long as every layer's branch spikes agree. Where a fraction f of
them differs, the gradients are held to max(2 sqrt(f), 1e-4) relative L2
instead (a flipped spike moves about sqrt(f) of a gradient's norm, as in
the Spikingformer's block check). At these sizes no membrane sits within
rounding of the threshold and f is 0.
"""
import numpy as np
import pytest
import torch

from _torch_port import POLICY_PAIRS, as_torch, lm_batch, lm_cfgs, \
    lm_loss_and_grads_match, lm_params, single_thread

from repro_torch.core.policy import named_policy
from repro_torch.core.spikingformer import tree_leaves, value_and_grad
from repro_torch.models import lm as tlm

single_thread()
#: None: no LIF; else the reference's policy (its port twin on our side).
POLICIES = [None] + [j for j, _ in POLICY_PAIRS if j != "pallas-full"]


CASES = [("plain", p) for p in POLICIES] + [("remat", p) for p in POLICIES] \
    + [("loss_mask", None), ("loss_mask", "pallas")]


@pytest.mark.parametrize("variant,jax_policy", CASES)
def test_lm_loss_and_every_gradient_leaf_match_reference(variant,
                                                         jax_policy):
    """``lm_loss`` and ``jax.value_and_grad(lm_loss)``: the loss, the three
    metrics and every gradient leaf, as they are (``plain``), with the
    layers' bodies rematerialised (``torch.utils.checkpoint`` /
    ``jax.checkpoint``) and with a loss mask on 60 % of the positions."""
    jcfg, tcfg = lm_cfgs("qwen3-0.6b", jax_policy)
    if variant == "remat":
        jcfg, tcfg = jcfg.replace(remat=True), tcfg.replace(remat=True)
    b = lm_batch()
    if variant == "loss_mask":
        b["loss_mask"] = (np.random.default_rng(1).random(b["labels"].shape)
                          < 0.6).astype(np.float32)
    lm_loss_and_grads_match(jcfg, tcfg, b)


@pytest.mark.parametrize("policy", ["eager", "cuda"])
def test_remat_on_and_off_give_bit_equal_gradients(policy):
    """The recomputation repeats the forward's operations on the same
    inputs, so rematerialising changes no bit of the loss or of any
    gradient leaf."""
    jcfg, tcfg = lm_cfgs("qwen3-0.6b", "jnp")
    _, tp = lm_params(jcfg)
    b = as_torch(lm_batch())
    out = {}
    for remat in (False, True):
        cfg = tcfg.replace(remat=remat, lif=tcfg.lif.with_policy(
            named_policy(policy)))
        out[remat] = value_and_grad(tlm.lm_loss, tp, b, cfg)
    (l0, _), g0 = out[False]
    (l1, _), g1 = out[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, c) for a, c in
               zip(tree_leaves(g0), tree_leaves(g1)))
