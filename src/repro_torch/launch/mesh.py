"""Device meshes over ``torch.distributed`` (the counterpart of
``repro.launch.mesh``), the sharding plan's spec arithmetic and the
placement of leaves on a mesh.

Single pod : (data=16, model=16)           = 256 devices
Multi-pod  : (pod=2, data=16, model=16)    = 512 devices

The pod axis is an extra pure-data-parallel dimension; batch shards over
("pod", "data"). :class:`P` is the port's partition spec: a tuple of one
mesh axis, a tuple of axes, or ``None`` per dimension, printed as JAX
prints a ``PartitionSpec``.

Two kinds of mesh. An :class:`AbstractMesh` has axis names and sizes and
no ranks: spec resolution (:func:`sanitize_specs`, :func:`apply_fsdp`)
needs nothing else, so the production meshes of 256 and 512 devices are
abstract here. A :class:`Mesh` is laid over the ranks of an initialised
process group (:func:`init_distributed`) with
``torch.distributed.device_mesh.init_device_mesh``: rank r sits at the
row-major coordinates of r in ``axis_sizes``, and the batch group joins
the ranks that share every non-batch coordinate.

Placement (:func:`local_shard`, :func:`gather_leaf`,
:func:`reduce_scatter_leaf`): a leaf whose spec names a mesh axis on
dimension k is held by each rank as its contiguous slice of dimension k,
the slice of its coordinate along those axes (several axes: the first
major). The train step gathers and reduces over the batch axes only
(ZeRO-3): a dim split over "model" stays this rank's slice, the one its
modules compute on (tensor parallelism, Megatron's convention: the
region ops of ``models.common`` sum the partial results and the
gradients over :func:`model_group`). Where the resolved plan stores a
leaf on another dim than the one a module computes on (``sanitize_specs``
moved its "model" axis), :func:`gather_model` gathers it whole at use and
reduce-scatters its gradient back; a module that computes the whole of
a leaf on every rank (replicated work) takes it with ``summed=False``,
whose backward keeps the rank's slice of the whole, equal, gradient.

Every model runs on a model axis: the Spikingformer, and each LM family
and the encoder-decoder with the attention's (and MLA's) "heads", "seq"
and "none" schemes, the decode's heads, flash-decode ("seq") and
head_dim modes, the MoE's expert parallelism and the recurrent heads.
The sequence split has its region pair (:func:`split_seq`,
:func:`gather_seq`), the expert dispatch its :class:`AllToAll`, the
flash-decode merge :func:`all_reduce_max`, a statistic over every
rank's columns (RWKV's ``ln_x``) :class:`AllReduceSum`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import shutil
import tempfile
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

BATCH_AXES = ("pod", "data")


class P(tuple):
    """A partition spec: one entry per leading dimension of a leaf, each a
    mesh axis name, a tuple of names (sharded over their product, the
    first major) or ``None`` (replicated). A one-name tuple becomes the
    name, as in JAX; ``repr`` is JAX's, ``PartitionSpec(...)``."""

    def __new__(cls, *axes):
        def norm(a):
            if isinstance(a, (tuple, list)):
                a = tuple(a)
                return a[0] if len(a) == 1 else a
            return a
        return super().__new__(cls, tuple(norm(a) for a in axes))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def map_specs(fn: Callable, specs: Any, *trees: Any) -> Any:
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure
    (dicts and lists; a spec tree's tuples are leaves)."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_specs(fn, v, *(t[i] for t in trees))
                for i, v in enumerate(specs)]
    return fn(specs, *trees)


def spec_list(specs: Any, params: Any) -> list:
    """The specs of ``params``' leaves in leaf order (dict keys sorted, as
    ``core.spikingformer.tree_leaves`` visits them), matched by path."""
    from repro_torch.core.spikingformer import tree_paths

    def items(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from items(v, f"{prefix}{k}.")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from items(v, f"{prefix}{i}.")
        else:
            yield prefix[:-1], tree
    by_path = dict(items(specs))
    return [by_path[p] for p in tree_paths(params)]


def _axes(ax) -> tuple[str, ...]:
    return () if ax is None else (ax if isinstance(ax, tuple) else (ax,))


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no ranks."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


class Mesh(AbstractMesh):
    """An :class:`AbstractMesh` laid over the ranks of the default process
    group, whose size must be the mesh's. ``coords`` are this rank's
    coordinates; ``group(axis)`` the process group along one axis;
    ``batch_group`` the group over the batch axes present (``None`` where
    there are none); ``model_group`` the group along "model" (``None``
    where the axis is missing or of size 1: the region ops then launch
    nothing); ``device`` where this rank's tensors live."""

    def __init__(self, axis_sizes: tuple[int, ...],
                 axis_names: tuple[str, ...], device: torch.device):
        super().__init__(tuple(axis_names), tuple(axis_sizes))
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs an initialised process group: "
                               "call init_distributed() first")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, "
                             f"the process group has {world}")
        from torch.distributed.device_mesh import init_device_mesh
        object.__setattr__(self, "device", torch.device(device))
        object.__setattr__(self, "rank", dist.get_rank())
        object.__setattr__(self, "device_mesh", init_device_mesh(
            self.device.type, self.axis_sizes,
            mesh_dim_names=self.axis_names))
        object.__setattr__(self, "coords", {
            a: int(c) for a, c in zip(
                self.axis_names,
                np.unravel_index(self.rank, self.axis_sizes))})
        object.__setattr__(self, "batch_group", self._batch_group())
        object.__setattr__(self, "model_group",
                           self.group("model") if self.shape.get("model", 1)
                           > 1 else None)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def _batch_group(self):
        names = batch_axes(self)
        if not names:
            return None
        if len(names) == 1:
            return self.group(names[0])
        # pod and data together: one group per coordinate of the other
        # axes, made by every rank in the same order
        ranks = np.arange(self.size).reshape(self.axis_sizes)
        keep = [i for i, a in enumerate(self.axis_names) if a in names]
        other = [i for i in range(len(self.axis_names)) if i not in keep]
        ranks = ranks.transpose(other + keep).reshape(
            -1, math.prod(self.axis_sizes[i] for i in keep))
        mine = None
        for row in ranks:
            g = dist.new_group([int(r) for r in row])
            if self.rank in row:
                mine = g
        return mine

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production meshes, abstract: (data=16, model=16), or
    (pod=2, data=16, model=16)."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_test_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A (data, model) mesh over the process group, which
    :func:`init_distributed` starts (a world of 1 with no launcher) where
    none is running; ``device`` as :func:`init_distributed` takes it."""
    if not dist.is_initialized():
        init_distributed(device)
    return Mesh((data, model), ("data", "model"), _rank_device())


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in BATCH_AXES if a in mesh.axis_names)


# ---------------------------------------------------------------------------
# The ambient mesh (the counterpart of ``jax.set_mesh``)
# ---------------------------------------------------------------------------

_AMBIENT: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Makes ``mesh`` the ambient mesh while the block runs: the model
    reads axis sizes from it (``models.common.mesh_axis_size``) and the
    BatchNorm sites their statistics' group (:func:`batch_group`). Process
    wide, not per thread: the autograd engine's threads and a recomputed
    block see it too."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def current_mesh():
    """The ambient mesh, or ``None``."""
    return _AMBIENT[-1] if _AMBIENT else None


def batch_group():
    """The process group over which BatchNorm statistics are summed: the
    ambient :class:`Mesh`'s batch group, ``None`` without one (statistics
    of the rank's own rows, as on one device)."""
    mesh = current_mesh()
    return mesh.batch_group if isinstance(mesh, Mesh) else None


def model_group():
    """The process group along the ambient :class:`Mesh`'s "model" axis,
    ``None`` without one or where that axis has one rank (every region
    op and :func:`gather_model` is then the identity)."""
    mesh = current_mesh()
    return mesh.model_group if isinstance(mesh, Mesh) else None


def model_coord() -> tuple[int, int]:
    """(this rank's coordinate along "model", the axis size) of the
    ambient mesh; (0, 1) without a model group."""
    mesh = current_mesh()
    if not isinstance(mesh, Mesh) or mesh.model_group is None:
        return 0, 1
    return int(mesh.coords["model"]), mesh.shape["model"]


# ---------------------------------------------------------------------------
# The process group
# ---------------------------------------------------------------------------

_STORE_DIR: list[str] = []


def _rank_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def init_distributed(device=None) -> tuple[int, int, torch.device]:
    """Starts the default process group and returns ``(rank, world,
    device)``. ``device=None`` is the card (NCCL; raises without one);
    ``"cpu"`` takes gloo. One backend or the other, never a fallback.

    Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` set) it joins that world, each rank on the card of its
    ``LOCAL_RANK``. With none of them set it makes a world of 1 from a
    file store in a temporary directory, with no network. A group already
    running is returned as it is if its backend is the one asked for."""
    from repro_torch.core.backend import resolve_device
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group is "
                               f"running; {dev.type} needs {backend}")
        return dist.get_rank(), dist.get_world_size(), _rank_device()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        kw = {}
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", 0))
            torch.cuda.set_device(local)
            kw["device_id"] = torch.device("cuda", local)
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        path = tempfile.mkdtemp(prefix="repro_torch_pg_")
        _STORE_DIR.append(path)
        kw = {}
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
            kw["device_id"] = torch.device("cuda", dev.index or 0)
        dist.init_process_group(backend,
                                init_method=f"file://{path}/store",
                                rank=0, world_size=1, **kw)
    return dist.get_rank(), dist.get_world_size(), _rank_device()


def shutdown_distributed() -> None:
    """Destroys the default process group and the file store a world of 1
    was made from."""
    if dist.is_initialized():
        dist.destroy_process_group()
    while _STORE_DIR:
        shutil.rmtree(_STORE_DIR.pop(), ignore_errors=True)


# ---------------------------------------------------------------------------
# Spec resolution (pure functions of shapes and axis sizes)
# ---------------------------------------------------------------------------

def apply_fsdp(specs, shapes, mesh, min_elems: int = 1 << 20,
               axis: str = "data", scan_dims=None):
    """ZeRO-3 weight sharding: every large leaf gets one extra free dim
    sharded over the data axis (gathered just in time by the train step).
    Cuts parameter and AdamW-moment residency by the data-axis size.

    ``scan_dims`` (optional) is a tree of ints matching ``specs``: the
    number of leading scan dims of each leaf that are never sharded (the
    Spikingformer's stacked block leaves carry a leading L axis)."""
    if axis not in mesh.axis_names:
        return specs
    size = dict(zip(mesh.axis_names, mesh.axis_sizes))[axis]

    def fix(spec, leaf, n_scan=0):
        shape = tuple(leaf.shape)
        if spec is None or int(np.prod(shape)) < min_elems:
            return spec
        cur = list(spec) + [None] * (len(shape) - len(spec))
        used = {a for s in cur for a in _axes(s)}
        if axis in used:
            return spec
        # the largest unsharded, divisible dim
        best, best_dim = -1, -1
        for i, (ax, d) in enumerate(zip(cur, shape)):
            if i >= n_scan and ax is None and d % size == 0 and d > best:
                best, best_dim = d, i
        if best_dim < 0:
            return spec
        cur[best_dim] = axis
        return P(*cur)

    if scan_dims is None:
        return map_specs(fix, specs, shapes)
    return map_specs(fix, specs, shapes, scan_dims)


def sanitize_specs(specs, shapes, mesh):
    """Drop sharding on dims that do not divide evenly and on axes missing
    from the mesh; a dropped axis relocates to the rightmost free divisible
    dim of the same tensor (e.g. 20 attention heads on 16 shards fall back
    to head-dim parallelism instead of replicating the projection)."""
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))

    def norm(ax):
        axes = tuple(a for a in _axes(ax) if a in sizes)
        return axes, math.prod(sizes[a] for a in axes)

    def fix(spec, leaf):
        if spec is None:
            return None
        shape = tuple(leaf.shape)
        out, dropped = [], []
        for i, ax in enumerate(spec):
            if ax is None:
                out.append(None)
                continue
            axes, total = norm(ax)
            if not axes or i >= len(shape) or shape[i] % total != 0:
                out.append(None)
                dropped.append(ax)
            else:
                out.append(axes if len(axes) > 1 else axes[0])
        in_use = {a for f in out for a in _axes(f)}
        for ax in dropped:
            axes = tuple(a for a in norm(ax)[0] if a not in in_use)
            if not axes:
                continue
            total = math.prod(sizes[a] for a in axes)
            for i in range(len(out) - 1, -1, -1):
                if out[i] is None and i < len(shape) and \
                        shape[i] % total == 0 and shape[i] >= total:
                    out[i] = axes if len(axes) > 1 else axes[0]
                    in_use.update(axes)
                    break
        return P(*out)

    return map_specs(fix, specs, shapes)


def resolve_spec(spec, mesh):
    """A stored logical spec against ``mesh``: axes the mesh lacks are
    dropped (elastic restore onto another mesh)."""
    if spec is None:
        return None
    names = set(mesh.axis_names)

    def keep(ax):
        kept = tuple(a for a in _axes(ax) if a in names)
        return None if not kept else (kept if len(kept) > 1 else kept[0])
    return P(*(keep(ax) for ax in spec))


# ---------------------------------------------------------------------------
# Placement of one leaf
# ---------------------------------------------------------------------------

def _sharded_dims(spec, mesh) -> list[tuple[int, tuple[str, ...]]]:
    """(dim, axes) of every dim ``spec`` shards over axes of ``mesh`` (of
    any size: over an axis of 1 the one shard is the whole dim)."""
    if spec is None:
        return []
    return [(i, tuple(a for a in _axes(ax) if a in mesh.axis_names))
            for i, ax in enumerate(spec)
            if any(a in mesh.axis_names for a in _axes(ax))]


def _shard_index(axes: tuple[str, ...], mesh: Mesh) -> tuple[int, int]:
    """(this rank's shard index, shard count) over ``axes``, the first
    major."""
    idx, n = 0, 1
    for a in axes:
        size = mesh.shape[a]
        idx, n = idx * size + int(mesh.coords[a]), n * size
    return idx, n


def full_shape(shard: torch.Tensor, spec, mesh: Mesh) -> tuple[int, ...]:
    """The shape of the leaf whose shard on this rank is ``shard``."""
    shape = list(shard.shape)
    for dim, axes in _sharded_dims(spec, mesh):
        shape[dim] *= _shard_index(axes, mesh)[1]
    return tuple(shape)


def local_shard(full: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``full`` under ``spec`` (a contiguous copy,
    never a view that would keep the whole leaf's storage alive, or
    ``full`` itself where nothing is sharded)."""
    out = full
    for dim, axes in _sharded_dims(spec, mesh):
        idx, n = _shard_index(axes, mesh)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"divide over {axes} ({n} shards)")
        step = out.shape[dim] // n
        out = out.narrow(dim, idx * step, step)
    return out if out is full else out.clone(
        memory_format=torch.contiguous_format)


def batch_dim(spec, mesh: Mesh) -> int | None:
    """The one dim ``spec`` shards over the batch axes (``None`` where there
    is none). A dim over "model" is left alone (its slice stays on the
    rank); several dims over the batch axes, or one over batch and model
    axes together, raise. A dim over some of the batch axes ("data" on a
    mesh with "pod": the reference's plan) is split over those and
    replicated over the others (:func:`batch_groups`)."""
    dims = [dim for dim, axes in _sharded_dims(spec, mesh)
            if any(a in BATCH_AXES for a in axes)]
    if len(dims) > 1:
        raise NotImplementedError(
            f"spec {spec!r} shards {len(dims)} dims over the batch axes")
    if dims and any(a not in BATCH_AXES and mesh.shape[a] > 1
                    for a in _axes(spec[dims[0]]) if a in mesh.shape):
        raise NotImplementedError(
            f"spec {spec!r} shards dim {dims[0]} over batch and model axes "
            f"together")
    return dims[0] if dims else None


def model_dim(spec, mesh) -> int | None:
    """The dim ``spec`` splits over a "model" axis of more than one rank,
    ``None`` where there is none."""
    for dim, axes in _sharded_dims(spec, mesh):
        if "model" in axes and mesh.shape["model"] > 1:
            return dim
    return None


def batch_groups(spec, mesh: Mesh):
    """``(dim, split, rest)`` of a leaf: its batch dim (:func:`batch_dim`),
    the process group over the batch axes of more than one rank that dim
    is split over (the batch group where it is all of them), and the group
    over the mesh's other batch axes of more than one rank, over which the
    leaf is replicated (``None`` where there is none). A dim over batch
    axes of one rank only is no split: ``(None, None, None)``."""
    dim = batch_dim(spec, mesh)
    if dim is None:
        return None, None, None
    live = tuple(a for a in batch_axes(mesh) if mesh.shape[a] > 1)
    split = tuple(a for a in live if a in _axes(spec[dim]))
    rest = tuple(a for a in live if a not in split)
    if not split:
        return None, None, None
    if not rest:
        return dim, mesh.batch_group, None
    return dim, mesh.group(split[0]), mesh.group(rest[0])


def gather_leaf(shard: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The leaf gathered over the batch axes its batch dim is split over
    (``all_gather_into_tensor``, :func:`batch_groups`): whole but for a
    dim over "model", which stays this rank's slice; ``shard`` itself
    where nothing is split over the batch axes."""
    dim, split, _ = batch_groups(spec, mesh)
    if dim is None:
        return shard
    return _gather_dim(shard, dim, split)


def reduce_scatter_leaf(grad: torch.Tensor, spec, mesh: Mesh
                        ) -> torch.Tensor:
    """The sum over the batch group of every rank's gradient (of the
    leaf as :func:`gather_leaf` gives it): this rank's shard of it
    (``reduce_scatter_tensor`` over the axes the leaf is split over, then
    ``all_reduce`` over the batch axes it is replicated over), or all of
    it (``all_reduce``; ``grad`` itself over a batch group of one rank)
    where the leaf is not split over the batch axes."""
    dim, split, rest = batch_groups(spec, mesh)
    if dim is None:
        if mesh.batch_group is None or \
                dist.get_world_size(mesh.batch_group) == 1:
            return grad
        out = grad.contiguous()
        dist.all_reduce(out, group=mesh.batch_group)
        return out
    out = _scatter_dim(grad, dim, split)
    if rest is not None:
        dist.all_reduce(out, group=rest)
    return out


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous() if dim else out


def _scatter_dim(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = g.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous() if dim else out


def gather_full(shard: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from every rank's slice: gathered over the batch
    group (:func:`gather_leaf`), then along its "model" dim over the model
    group (checkpoints write whole leaves)."""
    out = gather_leaf(shard, spec, mesh)
    dim = model_dim(spec, mesh)
    return out if dim is None else _gather_dim(out, dim, mesh.model_group)


class _GatherModel(torch.autograd.Function):
    """All-gather along ``dim`` over the model group; the backward sums
    every rank's gradient of the whole leaf and keeps this rank's slice
    (``reduce_scatter_tensor``)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_dim(g, ctx.dim, ctx.group), None, None


def gather_model(x: torch.Tensor, shape, summed: bool = True
                 ) -> torch.Tensor:
    """The leaf of whole shape ``shape`` from this rank's slice ``x``, for
    a module that computes on another slice than the plan stores (the
    stored spec's "model" dim is the one dim where ``x`` is short of
    ``shape``): all-gathered over the ambient model group, its gradient
    reduce-scattered back. ``x`` itself where it is whole already.

    ``summed=False`` is for replicated work, where every model rank
    computes the whole gradient of the leaf: the backward keeps the
    rank's slice of it (:func:`gather_seq`'s), where a sum would make it
    M times too large."""
    shape = tuple(shape)
    if tuple(x.shape) == shape:
        return x
    dims = [i for i, (a, b) in enumerate(zip(x.shape, shape)) if a != b]
    group = model_group()
    if group is None or len(dims) != 1 or \
            x.shape[dims[0]] * dist.get_world_size(group) != shape[dims[0]]:
        raise ValueError(f"a slice {tuple(x.shape)} is not one rank's part "
                         f"of {shape} along the model axis")
    if not summed:
        return _GatherSeq.apply(x, dims[0], group)
    return _GatherModel.apply(x, dims[0], group)


# ---------------------------------------------------------------------------
# Differentiable collectives: the BN statistics' sum and the model axis's
# region ops (Megatron's f and g)
# ---------------------------------------------------------------------------

class AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over a process group, differentiable: each rank's
    tensor reaches every rank's sum, so its gradient is the sum of every
    rank's gradient of the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return AllReduceSum.apply(g, ctx.group), None


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group (each rank's partial gradient of a replicated input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group forward (the row-parallel product's
    partial sums); identity backward (the sum is replicated, and so is its
    gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Enter a model-parallel region: ``x`` is replicated over the model
    group and each rank computes on its columns; the gradient of ``x`` is
    summed over the group. The identity, launching nothing, without a
    model group."""
    group = model_group()
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Leave a model-parallel region: the sum of every rank's partial
    ``x`` (all-reduce), whose gradient is each rank's as it is. The
    identity, launching nothing, without a model group."""
    group = model_group()
    return x if group is None else _ReduceFromModel.apply(x, group)


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """:class:`AllReduceSum` over the ambient model group: a statistic
    whose users differ by rank (RWKV's ``ln_x`` over the rank's columns),
    so its backward sums too. The identity without a model group."""
    group = model_group()
    return x if group is None else AllReduceSum.apply(x, group)


# ---------------------------------------------------------------------------
# The sequence split, the expert all-to-all and the flash-decode merge
# ---------------------------------------------------------------------------

class _GatherSeq(torch.autograd.Function):
    """All-gather along ``dim`` over the group; the backward keeps the
    rank's own part of the gradient (which is equal on every rank after a
    region: a sum would count it M times)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


class _SplitSeq(torch.autograd.Function):
    """The rank's equal part along ``dim``; the backward all-gathers every
    rank's part of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = x.shape[dim] // dist.get_world_size(group)
        return x.narrow(dim, dist.get_rank(group) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.dim, ctx.group), None, None


def gather_seq(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Leave a sequence-split region: every model rank's part of ``x``
    along ``dim`` (the rank-major all-gather), whose gradient is the
    rank's part of the (replicated) gradient. The identity, launching
    nothing, without a model group."""
    group = model_group()
    return x if group is None else _GatherSeq.apply(x, dim, group)


def split_seq(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Enter a sequence-split region: this model rank's equal part of the
    replicated ``x`` along ``dim``; the backward all-gathers the parts'
    gradients. The identity without a model group."""
    group = model_group()
    if group is None:
        return x
    m = dist.get_world_size(group)
    if x.shape[dim] % m:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {m} model ranks")
    return _SplitSeq.apply(x, dim, group)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class AllToAll(torch.autograd.Function):
    """``all_to_all_single`` with equal splits over a group: part i of
    dim 0 goes to rank i, which holds it at place r (the sender's rank).
    The exchange is its own transpose, so the backward sends the gradient
    back by the same all-to-all."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all_model(x: torch.Tensor) -> torch.Tensor:
    """:class:`AllToAll` over the ambient model group, ``x`` of shape
    (M, ...) (a contiguous buffer, its M parts of equal size); ``x``
    itself without a model group."""
    group = model_group()
    return x if group is None else AllToAll.apply(x, group)


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the ambient model group (no gradient:
    the flash-decode merge's row maximum); ``x`` without a model group."""
    group = model_group()
    if group is None:
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out
