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
are functional: they return new trees and leave their inputs as they were
(but for ``donate``).

``mesh=`` (a ``launch.mesh.Mesh``) makes the step ZeRO-3 data parallel
over the batch axes and tensor parallel over "model", the step XLA runs
for the reference on a mesh: the parameter, moment and ``err`` trees hold
this rank's shards of the leaves (``specs``, by default the plan of
``launch.specs``); the step all-gathers them over the batch group in leaf
order (a leaf's "model" slice stays the rank's: the modules compute on
it, ``models.common``'s region ops summing over the model group), runs
forward and backward on the rank's rows with the BatchNorm statistics of
the global batch (the ambient mesh reaches the BN sites),
weights each rank's gradient by its share of the global count (rows, or
tokens under a loss mask), so that the loss is the reference's mean over
the global batch, reduces it (``reduce_scatter_tensor`` for a sharded
leaf, ``all_reduce`` for a replicated one), and updates the shards. A
leaf replicated over "model" gets the same gradient on every model rank
(the region ops make each input's gradient whole), so nothing sums it
there. One non-finite flag, all-reduced with MAX over the world, makes
every rank skip a step together. At a world of 1 the step is the
mesh-less step bit for bit. On a model axis the Spikingformer and the
dense LM family are ported; the other families raise (ROADMAP A11c-2).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.core.spikingformer import (spikingformer_grad_step,
                                            tree_leaves, tree_map,
                                            tree_unflatten, value_and_grad)
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


def _any_rank_nonfinite(finite, mesh):
    """``finite`` of every rank: False where any rank's is False (one MAX
    all-reduce of the non-finite flag over the world)."""
    flag = (~finite).to(torch.float32)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return flag == 0


def check_model_axis(cfg, mesh) -> None:
    """Raises where ``cfg`` cannot be split over ``mesh``'s model axis: a
    family other than the Spikingformer and the dense LMs, an MoE with
    ``model_shards`` > 1 (ROADMAP A11c-2), or a Spikingformer whose heads,
    d_model or d_ff the axis does not divide."""
    m = mesh.shape.get("model", 1)
    if m == 1:
        return
    if getattr(cfg, "family", None) == "vision":
        cfg.check_model_shards(m)
        return
    if cfg.family == "audio":
        from repro_torch.models.common import refuse_model_axis
        refuse_model_axis(f"{cfg.name} (family audio)", m)
    from repro_torch.models.lm import check_lm_split
    check_lm_split(cfg, m)


class DataParallel:
    """The train step's view of a mesh: the parameter specs in leaf order,
    the all-gather over the batch group of a tree of shards and the
    reduction of its gradients. ``specs`` defaults to the plan of
    ``launch.specs`` for ``cfg`` on ``mesh``; :func:`check_model_axis`
    refuses what the model axis cannot split."""

    def __init__(self, cfg, mesh, specs=None):
        from repro_torch.launch import mesh as mesh_mod
        check_model_axis(cfg, mesh)
        if specs is None:
            from repro_torch.launch import specs as specs_mod
            if getattr(cfg, "family", None) == "vision":
                specs = specs_mod.spikingformer_structs(cfg, mesh)[1][0]
            else:
                specs = specs_mod.lm_specs(cfg, mesh)[1]
        self.mesh, self.specs, self._m = mesh, specs, mesh_mod
        self.world = dist.get_world_size(mesh.batch_group) \
            if mesh.batch_group is not None else 1
        self._list = None

    def spec_list(self, params) -> list:
        if self._list is None:
            self._list = self._m.spec_list(self.specs, params)
        return self._list

    def gather(self, params):
        return tree_unflatten(params, [
            self._m.gather_leaf(p, s, self.mesh) for p, s in
            zip(tree_leaves(params), self.spec_list(params))])

    def reduce(self, grads, params, weight):
        """Each rank's gradient times ``weight`` (a float, or a 0-d tensor),
        summed over the batch group: this rank's shard of each leaf."""
        out = []
        for g, s in zip(tree_leaves(grads), self.spec_list(params)):
            if not (isinstance(weight, float) and weight == 1.0):
                g = g * weight
            out.append(self._m.reduce_scatter_leaf(g, s, self.mesh))
        return tree_unflatten(params, out)

    def weighted_sum(self, x, weight):
        """sum over the ranks of ``x * weight`` (a 0-d tensor)."""
        out = (x * weight).contiguous()
        dist.all_reduce(out, group=self.mesh.batch_group)
        return out

    def token_share(self, batch):
        """This rank's share of the global batch's loss count: its tokens
        (under ``loss_mask``, the masked ones) over every rank's (at least
        1); a float where the count is known on the host."""
        if "loss_mask" not in batch:
            return 1.0 / self.world
        count = batch["loss_mask"].float().sum()
        total = count.clone()
        dist.all_reduce(total, group=self.mesh.batch_group)
        return count / torch.clamp(total, min=1.0)


def lm_grads(cfg, params, batch, microbatches: int = 1,
             dp: DataParallel | None = None):
    """``(loss, metrics, grads)`` of the LM (or encoder-decoder) loss:
    with ``microbatches > 1`` the gradients of equal slices of the batch
    added in order to zeros and divided by their number, the loss likewise
    and the metrics ``{"loss"}``, as in the reference. With ``dp``,
    ``params`` are this rank's shards and ``batch`` its rows: the returned
    gradients are the shards of the global batch's gradient, the loss and
    metrics the global ones."""
    if dp is None:
        return _lm_grads(cfg, params, batch, microbatches)
    from repro_torch.launch.mesh import use_mesh
    with use_mesh(dp.mesh):
        loss, metrics, grads = _lm_grads(cfg, dp.gather(params), batch,
                                         microbatches)
        weight = dp.token_share(batch)
        grads = dp.reduce(grads, params, weight)
        metrics = {k: dp.weighted_sum(v, weight) for k, v in metrics.items()}
    return metrics["loss"], metrics, grads


def _lm_grads(cfg, params, batch, microbatches):
    loss_fn = _loss_fn_for(cfg)
    if microbatches == 1:
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch, cfg)
        return loss, metrics, grads
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
    return loss, {"loss": loss}, grads


def vision_grads(cfg, params, state, images, labels,
                 dp: DataParallel | None = None):
    """``(grads, new_state, metrics)`` of one BPTT step
    (``spikingformer_grad_step``). With ``dp``, ``params`` are this rank's
    shards and ``images``/``labels`` its rows; the BN statistics are those
    of the global batch; each rank's loss, the mean over its rows, weighs
    1 / ranks, and the gradients come back as the shards of the sum."""
    if dp is None:
        return spikingformer_grad_step(params, state, images, labels, cfg)
    from repro_torch.launch.mesh import use_mesh
    with use_mesh(dp.mesh):
        grads, new_state, metrics = spikingformer_grad_step(
            dp.gather(params), state, images, labels, cfg)
        share = 1.0 / dp.world
        grads = dp.reduce(grads, params, share)
        metrics = {k: dp.weighted_sum(v, share) for k, v in metrics.items()}
    return grads, new_state, metrics


def _select_tree(finite, new, old):
    """``new`` where the step was finite, ``old`` otherwise, leaf by leaf:
    on a skipped step every leaf comes back bit-identical."""
    return tree_map(lambda n, o: torch.where(finite, n, o), new, old)


def make_train_step(cfg, opt_cfg: OptimizerConfig, microbatches: int = 1, *,
                    mesh=None, specs=None, guard_nonfinite: bool = True,
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

    ``mesh``: the ZeRO-3 data-parallel step of the module docstring, on the
    rank's rows of the batch (``train.data.place_batch``); ``specs`` the
    parameters' spec tree (default: the plan of ``launch.specs`` for
    ``cfg`` on ``mesh``). A family whose model axis is not ported raises
    ``NotImplementedError`` on a model axis of more than 1 (ROADMAP
    A11c-2).
    """
    family = getattr(cfg, "family", None)
    if family is None:
        raise ValueError(f"make_train_step takes an ArchConfig or a "
                         f"Spikingformer config (family 'vision'), got "
                         f"{type(cfg).__name__}")
    if family == "vision" and microbatches != 1:
        # Accumulating grads across microbatches would also have to merge
        # BN batch statistics; refuse rather than silently change the math.
        raise NotImplementedError(
            "microbatch accumulation is not supported on the vision path "
            "(BatchNorm statistics are per-global-batch); use time_chunk "
            "for activation-memory relief instead")
    dp = DataParallel(cfg, mesh, specs) if mesh is not None else None
    if family == "vision":
        return _make_vision_train_step(cfg, opt_cfg, guard_nonfinite, dp)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = lm_grads(cfg, params, batch, microbatches, dp)
        mesh_ = dp.mesh if dp is not None else None
        specs_ = dp.spec_list(params) if dp is not None else None
        finite = _all_finite(loss, grads) if guard_nonfinite else None
        if finite is not None and dp is not None:
            finite = _any_rank_nonfinite(finite, dp.mesh)
        if donate:
            new_params, new_opt, opt_metrics = adamw_update_(
                params, grads, opt_state, opt_cfg, keep=finite, mesh=mesh_,
                specs=specs_)
        else:
            new_params, new_opt, opt_metrics = adamw_update(
                params, grads, opt_state, opt_cfg, mesh_, specs_)
            if guard_nonfinite:
                new_params = _select_tree(finite, new_params, params)
                new_opt = _select_tree(finite, new_opt, opt_state)
        metrics = {**metrics, **opt_metrics}
        if guard_nonfinite:
            metrics["nonfinite"] = 1.0 - finite.float()
        return new_params, new_opt, metrics

    return train_step


def _make_vision_train_step(cfg, opt_cfg: OptimizerConfig,
                            guard_nonfinite: bool,
                            dp: DataParallel | None = None) -> Callable:
    """Fused BPTT + AdamW step for the Spikingformer."""

    def train_step(params, state, opt_state, images, labels):
        grads, new_state, metrics = vision_grads(cfg, params, state, images,
                                                 labels, dp)
        mesh_ = dp.mesh if dp is not None else None
        specs_ = dp.spec_list(params) if dp is not None else None
        new_params, new_opt, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg, mesh_, specs_)
        metrics = {**metrics, **opt_metrics}
        if guard_nonfinite:
            finite = _all_finite(metrics["loss"], grads)
            if dp is not None:
                finite = _any_rank_nonfinite(finite, dp.mesh)
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
