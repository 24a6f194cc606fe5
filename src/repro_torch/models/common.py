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
from repro_torch.launch.mesh import (copy_to_model, gather_seq,  # noqa: F401
                                     model_coord, model_group,
                                     reduce_from_model)

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


def matmul_whole(x: torch.Tensor, w: torch.Tensor, shape) -> torch.Tensor:
    """``x`` (..., K), whole on every rank, times this rank's slice of a
    (K, N) leaf of whole ``shape``: the whole (..., N) on every rank with
    no weight crossing the group (decode, whose activations are the small
    side): the partial products of the rank's K rows summed, or the
    products of its N columns all-gathered."""
    w = w.to(x.dtype)
    if tuple(w.shape) == tuple(shape):
        return torch.matmul(x, w)
    if w.shape[0] != shape[0]:
        n = w.shape[0]
        return reduce_from_model(torch.matmul(
            x.narrow(-1, model_coord()[0] * n, n), w))
    y = torch.matmul(x, w)
    return gather_seq(y, y.ndim - 1)


def rank_part(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """This model rank's ``n`` entries along ``dim`` of a tensor whole on
    every rank (the rank-major equal split); ``x`` itself where ``n`` is
    all of ``dim`` (a dim the axis does not split, or no model axis)."""
    if x.shape[dim] == n:
        return x
    return x.narrow(dim, model_coord()[0] * n, n)


def whole_part(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` whole along ``dim`` (``n`` entries): every model rank's part
    gathered (:func:`gather_seq`) where ``x`` holds the rank's, ``x``
    itself where it is whole (decode's activations; :func:`rank_part`'s
    inverse)."""
    return x if x.shape[dim] == n else gather_seq(x, dim)


def heads_on_axis(n: int, what: str) -> int:
    """This rank's share of ``n`` heads on the ambient model axis, whose
    size must divide them (``ValueError`` naming the dim and the axis, as
    ``lm.check_lm_split`` raises at the entry points)."""
    m = model_coord()[1]
    if n % m:
        raise ValueError(f"{what}'s {n} heads (dim 'heads') do not split "
                         f"over a model axis of {m}")
    return n // m


def cache_model_dim(shape, model: int, cache_shard: str = "auto"
                    ) -> int | None:
    """The dim of a decode-state leaf of ``shape`` (layer and batch axes
    first) that a model axis of ``model`` ranks splits, the reference's
    rule (``launch.specs.cache_structs``): a 5-D attention cache on its
    heads, else positions, else head_dim; a 4-D one (MLA's latent) on
    positions, else features; ``cache_shard="trailing"`` and any other
    leaf on the last dim that divides; ``None`` where none does."""
    nd = len(shape)
    if cache_shard == "auto" and nd == 5:
        order = (3, 2, 4)           # heads, seq, head_dim
    elif cache_shard == "auto" and nd == 4:
        order = (2, 3)              # seq, feature
    else:
        order = tuple(range(nd - 1, 1, -1))
    return next((i for i in order if shape[i] % model == 0 and
                 shape[i] >= model), None)


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


def table_shape(cfg) -> tuple[int, int]:
    """An LM's or encoder-decoder's embedding table's whole shape (V, D),
    which :func:`table_split` reads a rank's table against."""
    return cfg.vocab_size, cfg.d_model


def table_split(table: torch.Tensor, shape) -> str | None:
    """How this rank holds an embedding table of whole ``shape`` (V, D) on
    the ambient model axis: ``"vocab"`` (its V/M rows), ``"d"`` (its D/M
    columns: the plan's place where the axis does not divide the
    vocabulary) or ``None`` (whole, or no model axis, where ``shape`` is
    not read)."""
    if model_group() is None:
        return None
    if table.shape[0] != shape[0]:
        return "vocab"
    return "d" if table.shape[1] != shape[1] else None


def _vocab_slice(table: torch.Tensor) -> tuple[int, int] | None:
    """(first row, rows) of this rank's part of a vocab-parallel table,
    ``None`` without a model group."""
    r, m = model_coord()
    if m == 1:
        return None
    return r * table.shape[0], table.shape[0]


def embed(params, tokens: torch.Tensor, dtype=None, shape=None
          ) -> torch.Tensor:
    """The rows of the table for ``tokens`` (``shape``: the table's whole
    (V, D), :func:`table_split`, needed on a model axis). Vocab-parallel on a model axis: each
    rank looks up the tokens in its rows (zeros for the others') and the
    ranks' lookups are summed (:func:`reduce_from_model`). A table split
    on D: each rank's columns of the rows, gathered whole (their gradient
    the rank's columns of the replicated gradient)."""
    table = params["table"]
    split = table_split(table, shape)
    if split == "vocab":
        lo, n = _vocab_slice(table)
        local = tokens.long() - lo
        hit = (local >= 0) & (local < n)
        out = table[torch.where(hit, local, 0)] * hit[..., None].to(
            table.dtype)
        out = reduce_from_model(out)
    else:
        out = table[tokens.long()]
        if split == "d":
            out = gather_seq(out, out.ndim - 1)
    return out.to(dtype) if dtype is not None else out


def unembed(params, x: torch.Tensor, shape=None) -> torch.Tensor:
    """(..., D) -> (..., V) logits, fp32 for a stable softmax. On a model
    axis each rank's (..., V/M), its rows of the table, as the reference
    constrains the logits; with a table split on D (:func:`table_split`)
    the whole (..., V) on every rank, the partial products of the rank's
    D/M columns summed over the group (``shape``: the table's whole
    (V, D), needed on a model axis)."""
    table = params["table"]
    split = table_split(table, shape)
    if split == "vocab":
        x = copy_to_model(x)
    elif split == "d":
        n = table.shape[1]
        x = copy_to_model(x).narrow(-1, model_coord()[0] * n, n)
        return reduce_from_model(torch.matmul(x.float(), table.float().t()))
    return torch.matmul(x.float(), table.float().t())


def gather_vocab(logits: torch.Tensor, vocab: int | None = None
                 ) -> torch.Tensor:
    """Whole-vocabulary logits from each rank's (..., V/M) part (the
    caller's view of a vocab-parallel unembedding; no gradient); the
    logits themselves where they are whole (``vocab`` columns) already."""
    from repro_torch.launch.mesh import _gather_dim
    group = model_group()
    if group is None or logits.shape[-1] == vocab:
        return logits
    return _gather_dim(logits, logits.ndim - 1, group)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None,
                       vocab: int | None = None) -> torch.Tensor:
    """logits (B, S, V) fp32; labels (B, S) int; mask optional (B, S). On a
    model axis the logits are each rank's (B, S, V/M): the log-sum-exp
    from the group's maximum and its sum of exponentials, the target's
    logit from the rank that holds it (both sums over the group by
    :func:`reduce_from_model`, so every rank holds the loss and its
    gradient reaches its own columns). Logits of ``vocab`` columns are
    whole on every rank (a table split on D): the loss is computed whole
    there."""
    group = model_group()
    if group is None or logits.shape[-1] == vocab:
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
