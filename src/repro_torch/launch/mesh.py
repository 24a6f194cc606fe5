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
major). The train step gathers and reduces over the batch axes only; the
model axis is ROADMAP A11c.
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
    there are none); ``device`` where this rank's tensors live."""

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
    or ``full`` itself where nothing is sharded)."""
    out = full
    for dim, axes in _sharded_dims(spec, mesh):
        idx, n = _shard_index(axes, mesh)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"divide over {axes} ({n} shards)")
        step = out.shape[dim] // n
        out = out.narrow(dim, idx * step, step)
    return out if out is full else out.contiguous()


def batch_dim(spec, mesh: Mesh) -> int | None:
    """The one dim ``spec`` shards over the batch axes (``None`` where there
    is none). Raises for a dim split over a model axis of more than one
    device, or for several dims over the batch axes (ROADMAP A11c)."""
    dims = []
    for dim, axes in _sharded_dims(spec, mesh):
        if any(a not in BATCH_AXES and mesh.shape[a] > 1 for a in axes):
            raise NotImplementedError(
                f"spec {spec!r} splits dim {dim} over the model axis: "
                f"gathering and reducing it is ROADMAP A11c")
        if any(a in BATCH_AXES for a in axes):
            dims.append(dim)
    if len(dims) > 1:
        raise NotImplementedError(
            f"spec {spec!r} shards {len(dims)} dims over the batch axes")
    if dims and tuple(a for a in _axes(spec[dims[0]]) if a in BATCH_AXES
                      and mesh.shape.get(a, 1) > 1) != tuple(
            a for a in batch_axes(mesh) if mesh.shape[a] > 1):
        raise NotImplementedError(
            f"spec {spec!r} shards dim {dims[0]} over some of the batch "
            f"axes {batch_axes(mesh)} only")
    return dims[0] if dims else None


def gather_leaf(shard: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The full leaf from every rank's shard (``all_gather_into_tensor``
    over the batch group); ``shard`` itself where the leaf is
    replicated."""
    dim = batch_dim(spec, mesh)
    if dim is None:
        return shard
    n = dist.get_world_size(mesh.batch_group)
    src = shard.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src, group=mesh.batch_group)
    return out.movedim(0, dim).contiguous() if dim else out


def reduce_scatter_leaf(grad: torch.Tensor, spec, mesh: Mesh
                        ) -> torch.Tensor:
    """The sum over the batch group of every rank's full gradient, this
    rank's shard of it (``reduce_scatter_tensor``), or all of it
    (``all_reduce``) where the leaf is replicated."""
    dim = batch_dim(spec, mesh)
    if dim is None:
        out = grad.contiguous()
        dist.all_reduce(out, group=mesh.batch_group)
        return out
    n = dist.get_world_size(mesh.batch_group)
    src = grad.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.reduce_scatter_tensor(out, src, group=mesh.batch_group)
    return out.movedim(0, dim).contiguous() if dim else out
