"""The VLM stub's merge in the port's ``lm_forward`` (``reduced(pixtral-12b)``:
4 dense layers, d 64, 4 heads of 16, 2 KV heads) against the JAX package,
both on the CPU: pre-embedded image patches replace the token embeddings
where ``patch_mask`` is set (reference ``lm.py:238-241``).

The reference's own parameters (converted by ``lm_from_jax``) with the
query and key projections scaled by ``_torch_port.QK_SCALE`` (the sharp
attention of the reference's init, see GRAD_REL_L2_AT_INIT), the same
numpy batch; fp32, tolerance 1e-5 scale-aware, the gradients as
``_torch_port._lm_grads_close``.
"""
import numpy as np
import pytest
import torch

from _torch_port import (as_torch, close_scaled, lm_batch, lm_cfgs,
                         lm_loss_and_grads_match, qk_scaled_params,
                         single_thread)

from repro.models import lm as jlm
from repro_torch.models import lm as tlm

single_thread()
ARCH = "pixtral-12b"


def _batch(patches: bool):
    """``SyntheticLM``'s batch 0 (4 x 16); with ``patches``, N(0, 0.5)
    patch embeddings at a third of the positions."""
    b = lm_batch(seq=16)
    if patches:
        rng = np.random.default_rng(5)
        b["patch_embeds"] = rng.normal(0, 0.5, (4, 16, 64)).astype(np.float32)
        b["patch_mask"] = rng.random((4, 16)) < 1 / 3
    return b


@pytest.mark.parametrize("patches", [False, True])
def test_lm_forward_merges_patches_as_the_reference(patches):
    jcfg, tcfg = lm_cfgs(ARCH, None)
    assert jcfg.vlm_stub and tcfg.vlm_stub
    jp, tp = qk_scaled_params(jcfg)
    b = _batch(patches)
    jh, _ = jlm.lm_forward(jp, b, jcfg)
    th, _ = tlm.lm_forward(tp, as_torch(b), tcfg)
    close_scaled(th.numpy(), jh)
    plain = tlm.lm_forward(tp, as_torch(_batch(False)), tcfg)[0]
    # the merge is in effect exactly where the mask is set
    moved = (th - plain).abs().amax(-1) > 0
    assert bool(moved.any()) == patches
    if patches:
        first = np.argmax(b["patch_mask"], axis=1)
        assert all(not moved[i, :first[i]].any() for i in range(4))


@pytest.mark.parametrize("patches", [False, True])
def test_lm_loss_and_gradients_with_patches_match_reference(patches):
    jcfg, tcfg = lm_cfgs(ARCH, None)
    lm_loss_and_grads_match(jcfg, tcfg, _batch(patches),
                            params=qk_scaled_params(jcfg))


def test_the_vlm_family_serves_through_the_dense_path():
    """No patches reach decode (the reference's stub merges in the
    forward only): the family decodes as a dense LM."""
    _, tcfg = lm_cfgs(ARCH, "jnp")
    _, tp = qk_scaled_params(lm_cfgs(ARCH, None)[0])
    cache = tlm.init_cache(tcfg, 1, 8, torch.float32, "cpu")
    logits, _ = tlm.lm_decode_step(tp, cache, torch.tensor([[3]]),
                                   torch.tensor([0]), tcfg)
    assert logits.shape == (1, 512) and bool(torch.isfinite(logits).all())
