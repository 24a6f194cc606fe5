"""AdamW with global-norm gradient clipping, a warm-up + cosine schedule
and optional int8 gradient compression with error feedback.

The counterpart of ``repro.train.optimizer``. Plain tensor code: the
reference has no kernel here either. The optimizer state is ``{"m": tree,
"v": tree, "step": int32 scalar}`` with the structure of the parameters,
and ``"err"``, a tree of fp32 residuals, where compression is on (the
reference keeps ``"err": None`` otherwise, which its pytrees drop).
Leaves are visited in the reference pytree's order, so sums over leaves
add in the same order. With compression the metrics add ``err_norm``,
the residual's global norm.

Under a mesh (``mesh`` and ``specs`` given) the trees hold each rank's
shards (ZeRO-3 over the batch axes, tensor parallel over "model": moments
and ``err`` shard like the parameters): the gradient norm adds each
leaf's sum of squares over the ranks that split it (a replicated leaf
counted once), and compression takes each leaf's scale from its global
maximum and its noise from the full leaf's draw, so that the update is
the one-device update of the full leaves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

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
    # int8 stochastic-rounding gradient compression with error feedback,
    # applied to the reduced gradient before the norm, as in the reference
    compress_grads: bool = False


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio * lr`` (fp32)."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def init_opt_state(params: Any, compress: bool = False) -> dict[str, Any]:
    """Zero moments, step 0, and with ``compress`` a zero fp32 residual
    ``err`` per leaf."""
    device = tree_leaves(params)[0].device
    state = {"m": tree_map(torch.zeros_like, params),
             "v": tree_map(torch.zeros_like, params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if compress:
        state["err"] = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
    return state


def init_opt_specs(param_specs: Any) -> dict[str, Any]:
    """The optimizer state's specs: moments like the parameters, the step
    replicated, ``err`` as the reference lists it (``None``; the driver
    shards it like the moments)."""
    from repro_torch.launch.mesh import P
    return {"m": param_specs, "v": param_specs, "step": P(), "err": None}


def _sharded(spec, mesh) -> bool:
    """Whether a leaf with ``spec`` is split over the mesh's batch axes."""
    from repro_torch.launch.mesh import batch_dim
    return batch_dim(spec, mesh) is not None


def _model_sharded(spec, mesh) -> bool:
    """Whether a leaf with ``spec`` is split over a "model" axis of more
    than one rank."""
    from repro_torch.launch.mesh import model_dim
    return model_dim(spec, mesh) is not None


def _sum_where(v, mask, group):
    """``v`` with its ``mask``ed entries summed over ``group`` (one
    all-reduce of the vector)."""
    w = v * mask
    dist.all_reduce(w, group=group)
    return torch.where(mask, w, v)


def global_norm(tree: Any, mesh=None, specs: list | None = None
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, added in leaf order. With
    ``mesh``, ``tree`` holds shards whose specs (in leaf order) are
    ``specs``: each leaf's sum of squares is added over the batch group
    where it is split over the batch axes, then over the model group where
    it is split over "model" (one all-reduce of a vector of them each), a
    replicated leaf's is taken as it is, so at a world of 1 the norm is
    the one-device norm bit for bit."""
    sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if mesh is not None and sq:
        v = torch.stack(sq)
        v = _sum_where(v, torch.tensor([_sharded(s, mesh) for s in specs],
                                       device=v.device), mesh.batch_group)
        if getattr(mesh, "model_group", None) is not None:
            v = _sum_where(v, torch.tensor(
                [_model_sharded(s, mesh) for s in specs], device=v.device),
                mesh.model_group)
        sq = list(v.unbind())
    total = 0
    for x in sq:
        total = total + x
    return torch.sqrt(total)


def noise_generator(step: int, device) -> torch.Generator:
    """The compression noise's generator at ``step``, seeded from (17,
    step) as the reference folds ``step`` into ``PRNGKey(17)`` (the numbers
    differ from ``jax.random``'s)."""
    return torch.Generator(device=device).manual_seed((17 << 32) + step)


def compress_int8(g: torch.Tensor, err: torch.Tensor,
                  noise: torch.Tensor | None = None, *,
                  generator: torch.Generator | None = None, group=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastic int8 quantisation with error feedback: the dequantised
    gradient and the new residual (applied, as in the reference, to the
    reduced gradient before its norm). ``noise``
    is the rounding noise, uniform on [-0.5, 0.5), in ``g``'s shape; where
    it is not given it is drawn from ``generator``. With ``group`` the
    scale is the maximum over every rank's shard of the leaf."""
    gf = g.float() + err
    amax = torch.max(torch.abs(gf)) if gf.numel() else gf.new_zeros(())
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    if noise is None:
        noise = draw_noise(generator, gf.shape, gf.device)
    q = torch.clamp(torch.round(gf / scale + noise), -127, 127)
    deq = q * scale
    return deq, gf - deq


def draw_noise(gen: torch.Generator, shape, device) -> torch.Tensor:
    """One leaf's rounding noise, uniform on [-0.5, 0.5), from ``gen``."""
    return torch.rand(shape, generator=gen, device=device) - 0.5


def compress_tree(grads: Any, err: Any, step: int, mesh=None,
                  specs: list | None = None) -> tuple[Any, Any]:
    """:func:`compress_int8` over every leaf in leaf order, the noise of
    each drawn from :func:`noise_generator` at ``step``. With ``mesh`` the
    leaves are shards with ``specs``: a sharded leaf's noise is drawn at
    the full leaf's shape and sliced (over the batch and the model axes),
    and its scale is its maximum over the world (the ranks that hold the
    same slice hold the same values)."""
    leaves = tree_leaves(grads)
    gen = noise_generator(step, leaves[0].device) if leaves else None
    out = []
    for i, (g, e) in enumerate(zip(leaves, tree_leaves(err))):
        sharded = mesh is not None and (_sharded(specs[i], mesh) or
                                         _model_sharded(specs[i], mesh))
        if sharded:
            from repro_torch.launch.mesh import full_shape, local_shard
            noise = local_shard(draw_noise(gen, full_shape(g, specs[i], mesh),
                                           g.device), specs[i], mesh)
        else:
            noise = draw_noise(gen, g.shape, g.device)
        out.append(compress_int8(
            g, e, noise, group=dist.group.WORLD if sharded else None))
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def _compress(grads, state, cfg, mesh, specs):
    """(grads, new err): compressed where ``cfg.compress_grads`` and the
    state carries ``err``, as in the reference; else unchanged."""
    if not (cfg.compress_grads and state.get("err") is not None):
        return grads, state.get("err")
    return compress_tree(grads, state["err"], int(state["step"]) + 1, mesh,
                         specs)


def _scalars(grads: Any, state: dict[str, Any], cfg: OptimizerConfig,
             mesh=None, specs=None):
    """The step's (step, grad norm, clip factor, lr, bias corrections)."""
    step = state["step"] + 1
    gnorm = global_norm(grads, mesh, specs)
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
                 cfg: OptimizerConfig, mesh=None, specs: list | None = None
                 ) -> tuple[Any, dict, dict]:
    """One AdamW step. Returns ``(new_params, new_state, metrics)``; the
    inputs are not modified. ``mesh`` and ``specs`` (the leaves' specs in
    leaf order): the trees hold this rank's shards (see the module
    docstring)."""
    grads, new_err = _compress(grads, state, cfg, mesh, specs)
    step, gnorm, clip, lr, bc1, bc2 = _scalars(grads, state, cfg, mesh,
                                               specs)
    out = [_leaf_update(p, g, m, v, clip, lr, bc1, bc2, cfg, p.ndim >= 2)
           for p, g, m, v in zip(
               tree_leaves(params), tree_leaves(grads),
               tree_leaves(state["m"]), tree_leaves(state["v"]))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                           for i in range(3))
    new_state = {"m": new_m, "v": new_v, "step": step}
    metrics = {"grad_norm": gnorm, "lr": lr}
    if new_err is not None:
        new_state["err"] = new_err
        metrics["err_norm"] = global_norm(new_err, mesh, specs)
    return new_p, new_state, metrics


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
                  cfg: OptimizerConfig, keep: torch.Tensor | None = None,
                  mesh=None, specs: list | None = None
                  ) -> tuple[Any, dict, dict]:
    """:func:`adamw_update` written into the leaves of ``params`` and of
    ``state``'s ``m`` and ``v`` (the reference driver donates these
    buffers to its step): the same operations on each element, so the
    same bits, a slice of ``UPDATE_SLICE`` elements at a time. ``keep``, a
    0-dim bool tensor: where it is False every leaf and the step counter
    stay as they were (the non-finite guard, decided on the device), the
    residual ``err`` too. ``mesh`` and ``specs`` as in
    :func:`adamw_update`. Returns ``(params, new_state, metrics)``, the
    same leaf objects."""
    grads, new_err = _compress(grads, state, cfg, mesh, specs)
    if new_err is not None:
        for dst, src in zip(tree_leaves(state["err"]), tree_leaves(new_err)):
            dst.copy_(src if keep is None else torch.where(keep, src, dst))
    step, gnorm, clip, lr, bc1, bc2 = _scalars(grads, state, cfg, mesh,
                                               specs)
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
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    metrics = {"grad_norm": gnorm, "lr": lr}
    if new_err is not None:
        new_state["err"] = state["err"]
        metrics["err_norm"] = global_norm(state["err"], mesh, specs)
    return params, new_state, metrics
