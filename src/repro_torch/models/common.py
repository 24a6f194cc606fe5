"""Shared model-building utilities (the counterpart of
``repro.models.common``): augmented parameter trees, norms, RoPE,
embeddings and the loss.

Convention, as in the reference: every ``init_*`` returns a tree whose
leaves are :class:`Leaf` ``(tensor, spec)`` pairs, and :func:`split_tree`
separates it into the parameter tree and the matching spec tree. A spec is
a tuple of mesh-axis names (``"model"``, ``("pod", "data")``) or ``None``
per dimension, the reference's ``PartitionSpec`` as a plain tuple; the
launch layer resolves them against a mesh (``repro_torch.launch.mesh``).

Initialisers draw from a ``torch.Generator`` on the generator's own device
and place the result on ``device``: the numbers differ from the
reference's ``jax.random`` ones, and parity tests convert the reference's
parameters instead (``repro_torch.convert.lm_from_jax``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from repro_torch.core.spikingformer import tree_leaves, tree_map, \
    tree_unflatten
from repro_torch.launch.mesh import (copy_to_model, model_coord,  # noqa: F401
                                     model_group, reduce_from_model)

# Logical -> physical axis naming, as in the reference.
BATCH = ("pod", "data")
MODEL = "model"


@dataclasses.dataclass
class Leaf:
    """A parameter leaf: the tensor plus its partition spec."""

    value: torch.Tensor
    spec: tuple


def split_tree(aug: Any) -> tuple[Any, Any]:
    """Augmented tree -> (params, specs)."""
    return tree_map(lambda l: l.value, aug), tree_map(lambda l: l.spec, aug)


def stack_layer_trees(augs: list[Any]) -> Any:
    """Stack per-layer augmented trees along a new leading (layer) axis;
    the layer axis is unsharded (it is looped over, never partitioned).

    The per-layer leaves are consumed: each one's ``value`` is dropped as
    soon as its stack exists, so the peak memory is the layers plus one
    leaf's stack, not twice the layers (a layer of ``deepseek-v2-236b`` is
    15.9 GB in fp32)."""
    def stack(*leaves: Leaf) -> Leaf:
        out = Leaf(torch.stack([l.value for l in leaves]),
                   (None, *leaves[0].spec))
        for l in leaves:
            l.value = None
        return out
    return tree_map(stack, *augs)


def layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a tree of stacked ``(L, ...)`` leaves (a view)."""
    return tree_map(lambda a: a[i], tree)


def lscan(cfg, f, init, xs, remat: bool | None = None):
    """The reference's ``lax.scan`` over the stacked layer axis, as a loop:
    ``carry, y = f(carry, layer(xs, i))`` for each layer ``i``; returns the
    last carry and the ``y`` trees stacked on a new leading axis (``None``
    where ``f`` returns ``None``).

    The stacked leaves are unbound once, so the backward stacks the layers'
    gradients in one pass instead of adding a full-size zero-padded copy per
    layer. With ``cfg.remat`` set (the reference wraps its scanned body in
    ``jax.checkpoint``) and gradients enabled, each layer's body runs under
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward instead of kept, and the gradients are the same. ``remat``
    overrides ``cfg.remat``: ``False`` for a loop inside a body that is
    already recomputed as a whole (the hybrid family's Mamba2 layers inside
    a group)."""
    if remat is None:
        remat = getattr(cfg, "remat", False)
    remat = remat and torch.is_grad_enabled()
    slices = [a.unbind(0) for a in tree_leaves(xs)]
    carry, ys = init, []
    for i in range(len(slices[0])):
        x_i = tree_unflatten(xs, [s[i] for s in slices])
        if remat:
            # No layer draws random numbers, so the RNG state is not saved.
            carry, y = torch.utils.checkpoint.checkpoint(
                f, carry, x_i, use_reentrant=False, preserve_rng_state=False)
        else:
            carry, y = f(carry, x_i)
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, tree_map(lambda *a: torch.stack(a), *ys)


def shard(x: torch.Tensor, *spec) -> torch.Tensor:
    """Sharding constraint: the identity. Each rank computes on its own rows
    (data) and on its slice of the model-parallel leaves, so an activation
    is already where the reference's constraint puts it; where XLA would
    insert a collective to get it there, the module calls the region ops
    (:func:`copy_to_model`, :func:`reduce_from_model`) itself."""
    return x


def refuse_model_axis(what: str, m: int | None = None) -> None:
    """Raises for a scheme or family whose compute split over the model
    axis is not ported (ROADMAP A11c-2), where the model axis (``m``
    ranks, default the ambient mesh's) has more than one rank; the port
    never computes such a model replicated in silence."""
    m = model_coord()[1] if m is None else m
    if m > 1:
        raise NotImplementedError(
            f"{what} on a model axis of {m} is ROADMAP A11c-2 (ported: the "
            f"Spikingformer and the dense family's 'heads' scheme)")


def shard_batch(x: torch.Tensor, *rest) -> torch.Tensor:
    """Constrain the leading dim over the batch axes: the identity, since
    each rank holds only its rows of the global batch
    (``train.data.place_batch``)."""
    return x


def mesh_axis_size(name: str) -> int | None:
    """Size of a mesh axis in the ambient mesh
    (``repro_torch.launch.mesh.use_mesh``), else ``None``, as the
    reference answers."""
    from repro_torch.launch.mesh import current_mesh
    mesh = current_mesh()
    return None if mesh is None else mesh.shape.get(name)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def normal_leaf(generator: torch.Generator, shape, spec: tuple,
                scale: float | None = None, dtype=torch.float32,
                device: str | torch.device = "cpu") -> Leaf:
    """N(0, 1) * scale, scale defaulting to fan_in^-1/2 (``shape[-2]``) for
    a matrix and 0.02 for a vector, as in the reference."""
    scale = shape[-2] ** -0.5 if scale is None and len(shape) >= 2 else \
        (scale if scale is not None else 0.02)
    if torch.device(device).type == "meta":     # shapes only: draw nothing
        return Leaf(torch.empty(shape, dtype=dtype, device="meta"),
                    tuple(spec))
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device).mul_(scale)
    return Leaf(w.to(device=device, dtype=dtype), tuple(spec))


def zeros_leaf(shape, spec: tuple, dtype=torch.float32,
               device: str | torch.device = "cpu") -> Leaf:
    return Leaf(torch.zeros(shape, dtype=dtype, device=device), tuple(spec))


def ones_leaf(shape, spec: tuple, dtype=torch.float32,
              device: str | torch.device = "cpu") -> Leaf:
    return Leaf(torch.ones(shape, dtype=dtype, device=device), tuple(spec))


def full_leaf(shape, value: float, spec: tuple, dtype=torch.float32,
              device: str | torch.device = "cpu") -> Leaf:
    return Leaf(torch.full(shape, value, dtype=dtype, device=device),
                tuple(spec))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, dtype=torch.float32, device="cpu"):
    return {"scale": ones_leaf((dim,), (None,), dtype, device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def init_layernorm(dim: int, dtype=torch.float32, device="cpu"):
    return {"scale": ones_leaf((dim,), (None,), dtype, device),
            "bias": zeros_leaf((dim,), (None,), dtype, device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(d_head: int, theta: float,
                     device: str | torch.device = "cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # (Dh/2,)
    angles = positions[..., None].float() * freqs              # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, ·)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(generator, vocab: int, d_model: int, dtype=torch.float32,
                   device="cpu"):
    return {"table": normal_leaf(generator, (vocab, d_model), (MODEL, None),
                                 scale=0.02, dtype=dtype, device=device)}


def _vocab_slice(table: torch.Tensor) -> tuple[int, int] | None:
    """(first row, rows) of this rank's part of a vocab-parallel table,
    ``None`` without a model group."""
    r, m = model_coord()
    if m == 1:
        return None
    return r * table.shape[0], table.shape[0]


def embed(params, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    """The rows of the table for ``tokens``. Vocab-parallel on a model
    axis: each rank looks up the tokens in its rows (zeros for the
    others') and the ranks' lookups are summed (:func:`reduce_from_model`)."""
    table = params["table"]
    part = _vocab_slice(table)
    if part is None:
        out = table[tokens.long()]
    else:
        lo, n = part
        local = tokens.long() - lo
        hit = (local >= 0) & (local < n)
        out = table[torch.where(hit, local, 0)] * hit[..., None].to(
            table.dtype)
        out = reduce_from_model(out)
    return out.to(dtype) if dtype is not None else out


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., V) logits, fp32 for a stable softmax. On a model
    axis each rank's (..., V/M), its rows of the table, as the reference
    constrains the logits."""
    if model_group() is not None:
        x = copy_to_model(x)
    return torch.matmul(x.float(), params["table"].float().t())


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Whole-vocabulary logits from each rank's (..., V/M) part (the
    caller's view of a vocab-parallel unembedding; no gradient)."""
    from repro_torch.launch.mesh import _gather_dim
    group = model_group()
    if group is None:
        return logits
    return _gather_dim(logits, logits.ndim - 1, group)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """logits (B, S, V) fp32; labels (B, S) int; mask optional (B, S). On a
    model axis the logits are each rank's (B, S, V/M): the log-sum-exp
    from the group's maximum and its sum of exponentials, the target's
    logit from the rank that holds it (both sums over the group by
    :func:`reduce_from_model`, so every rank holds the loss and its
    gradient reaches its own columns)."""
    group = model_group()
    if group is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        v = logits.shape[-1]
        lo = model_coord()[0] * v
        top = logits.detach().amax(-1)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        sumexp = reduce_from_model(torch.exp(logits - top[..., None]).sum(-1))
        logz = top + torch.log(sumexp)
        local = labels.long() - lo
        hit = (local >= 0) & (local < v)
        gold = torch.gather(logits, -1, torch.where(hit, local, 0)[..., None]
                            )[..., 0]
        gold = reduce_from_model(torch.where(hit, gold, 0.0))
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
