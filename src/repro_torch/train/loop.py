"""The train-step factory (the counterpart of ``repro.train.loop``).

``make_train_step(cfg, opt_cfg)`` is the one factory for every family the
port trains:

* the decoder LMs and the encoder-decoder (an ``ArchConfig``):
  ``train_step(params, opt_state, batch) -> (params, opt_state,
  metrics)``, the gradient of :func:`repro_torch.models.lm.lm_loss` (of
  :func:`repro_torch.models.encdec.encdec_loss` for the audio family) and
  one AdamW update, with
  ``microbatches > 1`` accumulating the gradients of equal slices of the
  batch;
* the Spikingformer (``cfg.family == "vision"``): ``train_step(params,
  state, opt_state, images, labels) -> (params, state, opt_state,
  metrics)``, one BPTT step (:func:`repro_torch.core.spikingformer.
  spikingformer_grad_step`) and one AdamW update; ``state`` carries the BN
  running statistics.

The execution policy of ``cfg`` chooses the kernels at every site. Steps
are functional: they return new trees and leave their inputs as they were.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.spikingformer import (spikingformer_grad_step,
                                            tree_leaves, tree_map,
                                            value_and_grad)
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         adamw_update_)


def _loss_fn_for(cfg) -> Callable:
    if cfg.family == "audio":
        from repro_torch.models.encdec import encdec_loss
        return encdec_loss
    from repro_torch.models.lm import lm_loss
    return lm_loss


def _all_finite(loss, grads) -> torch.Tensor:
    """0-dim bool tensor: the loss and every floating grad leaf are finite.
    Reduced on the device, so the guard adds no host synchronisation."""
    finite = torch.isfinite(loss).all()
    for leaf in tree_leaves(grads):
        if leaf.is_floating_point():
            finite = finite & torch.isfinite(leaf).all()
    return finite


def _select_tree(finite, new, old):
    """``new`` where the step was finite, ``old`` otherwise, leaf by leaf:
    on a skipped step every leaf comes back bit-identical."""
    return tree_map(lambda n, o: torch.where(finite, n, o), new, old)


def make_train_step(cfg, opt_cfg: OptimizerConfig, microbatches: int = 1, *,
                    guard_nonfinite: bool = True,
                    donate: bool = False) -> Callable:
    """The train-step factory (LM and vision families).

    LM ``batch`` leaves have a leading dim ``global_batch``; with
    ``microbatches > 1`` it is split into ``microbatches`` equal slices
    whose gradients are added in order to zeros and divided by their
    number, the loss likewise, and the metrics are ``{"loss"}`` plus the
    optimizer's, as in the reference.

    ``guard_nonfinite`` (default on): when the loss or any gradient leaf is
    NaN/Inf, the parameter, (vision) BN-state and optimizer updates are
    suppressed leaf by leaf (state bit-identical to before the step) and
    ``metrics["nonfinite"]`` reports 1.0.

    ``donate`` (LM families): the step writes the new parameters and the
    optimizer's ``m`` and ``v`` into the leaves it was given
    (:func:`~repro_torch.train.optimizer.adamw_update_`), as the
    reference driver's step updates the buffers it donates; the results
    are the same bits, without a second copy of the state.
    """
    family = getattr(cfg, "family", None)
    if family == "vision":
        return _make_vision_train_step(cfg, opt_cfg, microbatches,
                                       guard_nonfinite)
    if family is None:
        raise ValueError(f"make_train_step takes an ArchConfig or a "
                         f"Spikingformer config (family 'vision'), got "
                         f"{type(cfg).__name__}")
    loss_fn = _loss_fn_for(cfg)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch,
                                                    cfg)
        else:
            mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                               *v.shape[1:]) for k, v in batch.items()}
            grads = tree_map(torch.zeros_like, params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(microbatches):
                (loss_i, _), g_i = value_and_grad(
                    loss_fn, params, {k: v[i] for k, v in mb.items()}, cfg)
                grads = tree_map(torch.add, grads, g_i)
                loss = loss + loss_i
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = {"loss": loss}
        finite = _all_finite(loss, grads) if guard_nonfinite else None
        if donate:
            new_params, new_opt, opt_metrics = adamw_update_(
                params, grads, opt_state, opt_cfg, keep=finite)
        else:
            new_params, new_opt, opt_metrics = adamw_update(
                params, grads, opt_state, opt_cfg)
            if guard_nonfinite:
                new_params = _select_tree(finite, new_params, params)
                new_opt = _select_tree(finite, new_opt, opt_state)
        metrics = {**metrics, **opt_metrics}
        if guard_nonfinite:
            metrics["nonfinite"] = 1.0 - finite.float()
        return new_params, new_opt, metrics

    return train_step


def _make_vision_train_step(cfg, opt_cfg: OptimizerConfig, microbatches: int,
                            guard_nonfinite: bool) -> Callable:
    """Fused BPTT + AdamW step for the Spikingformer."""
    if microbatches != 1:
        # Accumulating grads across microbatches would also have to merge
        # BN batch statistics; refuse rather than silently change the math.
        raise NotImplementedError(
            "microbatch accumulation is not supported on the vision path "
            "(BatchNorm statistics are per-global-batch); use time_chunk "
            "for activation-memory relief instead")

    def train_step(params, state, opt_state, images, labels):
        grads, new_state, metrics = spikingformer_grad_step(
            params, state, images, labels, cfg)
        new_params, new_opt, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg)
        metrics = {**metrics, **opt_metrics}
        if guard_nonfinite:
            finite = _all_finite(metrics["loss"], grads)
            new_params = _select_tree(finite, new_params, params)
            # BN running statistics ride the forward pass, so a poisoned
            # batch contaminates them too: roll them back with the rest.
            new_state = _select_tree(finite, new_state, state)
            new_opt = _select_tree(finite, new_opt, opt_state)
            metrics["nonfinite"] = 1.0 - finite.float()
        return new_params, new_state, new_opt, metrics

    return train_step


def make_spikingformer_train_step(cfg, opt_cfg: OptimizerConfig) -> Callable:
    """The factory's step for a Spikingformer config (the reference's name
    for the single-device entry point)."""
    return make_train_step(cfg, opt_cfg)


def make_eval_step(cfg) -> Callable:
    """``eval_step(params, batch) -> metrics``: the LM loss's metrics, no
    gradient."""
    loss_fn = _loss_fn_for(cfg)

    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(params, batch, cfg)
        return metrics

    return eval_step
