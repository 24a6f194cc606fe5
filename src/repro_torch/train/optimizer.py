"""AdamW with global-norm gradient clipping and a warm-up + cosine schedule.

The counterpart of ``repro.train.optimizer`` (without the int8 gradient
compression of the data-parallel all-reduce, which belongs to the LM zoo's
slice). Plain tensor code: the reference has no kernel here either. The
optimizer state is ``{"m": tree, "v": tree, "step": int32 scalar}`` with the
structure of the parameters; leaves are visited in the reference pytree's
order, so sums over leaves add in the same order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core.spikingformer import tree_leaves, tree_map, \
    tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio * lr`` (fp32)."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def init_opt_state(params: Any) -> dict[str, Any]:
    device = tree_leaves(params)[0].device
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def _scalars(grads: Any, state: dict[str, Any], cfg: OptimizerConfig):
    """The step's (step, grad norm, clip factor, lr, bias corrections)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    lr = lr_schedule(cfg, step)
    return (step, gnorm, clip, lr, 1 - cfg.beta1 ** step.float(),
            1 - cfg.beta2 ** step.float())


def _leaf_update(p, g, m, v, clip, lr, bc1, bc2, cfg: OptimizerConfig,
                 decay: bool):
    """(p, m, v) after one AdamW step of one leaf (or of a slice of it:
    every operation is elementwise). ``decay``: the leaf is a matrix."""
    b1, b2 = cfg.beta1, cfg.beta2
    gf = g.float() * clip
    m_new = b1 * m.float() + (1 - b1) * gf
    v_new = b2 * v.float() + (1 - b2) * torch.square(gf)
    update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
    if decay:                                # decoupled decay, matrices only
        update = update + cfg.weight_decay * p.float()
    p_new = p.float() - lr * update
    return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)


def adamw_update(params: Any, grads: Any, state: dict[str, Any],
                 cfg: OptimizerConfig) -> tuple[Any, dict, dict]:
    """One AdamW step. Returns ``(new_params, new_state, metrics)``; the
    inputs are not modified."""
    step, gnorm, clip, lr, bc1, bc2 = _scalars(grads, state, cfg)
    out = [_leaf_update(p, g, m, v, clip, lr, bc1, bc2, cfg, p.ndim >= 2)
           for p, g, m, v in zip(
               tree_leaves(params), tree_leaves(grads),
               tree_leaves(state["m"]), tree_leaves(state["v"]))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                           for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}


#: Elements of a leaf that :func:`adamw_update_` updates at a time, so that
#: its temporaries are a few such slices, not a few copies of the largest
#: leaf (a stacked expert leaf of ``mixtral-8x7b`` is 1.9 GB a layer).
UPDATE_SLICE = 1 << 24


def _slices(*leaves: torch.Tensor):
    """Matching flat slices (views) of equally shaped contiguous leaves."""
    flat = [a.view(-1) for a in leaves]
    for i in range(0, flat[0].numel(), UPDATE_SLICE):
        yield tuple(a[i:i + UPDATE_SLICE] for a in flat)


def adamw_update_(params: Any, grads: Any, state: dict[str, Any],
                  cfg: OptimizerConfig, keep: torch.Tensor | None = None
                  ) -> tuple[Any, dict, dict]:
    """:func:`adamw_update` written into the leaves of ``params`` and of
    ``state``'s ``m`` and ``v`` (the reference driver donates these
    buffers to its step): the same operations on each element, so the
    same bits, a slice of ``UPDATE_SLICE`` elements at a time. ``keep``, a
    0-dim bool tensor: where it is False every leaf and the step counter
    stay as they were (the non-finite guard, decided on the device).
    Returns ``(params, new_state, metrics)``, the same leaf objects."""
    step, gnorm, clip, lr, bc1, bc2 = _scalars(grads, state, cfg)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        decay = p.ndim >= 2
        for ps, gs, ms, vs in _slices(p, g, m, v):
            new = _leaf_update(ps, gs, ms, vs, clip, lr, bc1, bc2, cfg,
                               decay)
            for dst, src in zip((ps, ms, vs), new):
                dst.copy_(src if keep is None else
                          torch.where(keep, src, dst))
    if keep is not None:
        step = torch.where(keep, step, state["step"])
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
