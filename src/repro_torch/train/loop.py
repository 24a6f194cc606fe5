"""The train-step factory, vision path (the counterpart of
``repro.train.loop.make_train_step`` for ``cfg.family == "vision"``).

``make_train_step(cfg, opt_cfg)`` returns ``train_step(params, state,
opt_state, images, labels) -> (params, state, opt_state, metrics)``: one
BPTT step of the Spikingformer (:func:`repro_torch.core.spikingformer.
spikingformer_grad_step`) and one AdamW update, with the execution policy
of ``cfg`` choosing the kernels at every site. ``state`` carries the BN
running statistics. The step is functional: it returns new trees and leaves
its inputs as they were.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.spikingformer import (spikingformer_grad_step,
                                            tree_leaves, tree_map)
from repro_torch.train.optimizer import OptimizerConfig, adamw_update


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
                    guard_nonfinite: bool = True) -> Callable:
    """The train-step factory (vision family).

    ``guard_nonfinite`` (default on): when the loss or any gradient leaf is
    NaN/Inf, the parameter, BN-state and optimizer updates are suppressed
    leaf by leaf (state bit-identical to before the step) and
    ``metrics["nonfinite"]`` reports 1.0.
    """
    if getattr(cfg, "family", None) != "vision":
        raise ValueError(f"make_train_step takes a Spikingformer config "
                         f"(family 'vision'), got {type(cfg).__name__}")
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
