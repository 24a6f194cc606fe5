"""Checkpoints with atomic publication, retention and integrity checks (the
counterpart of ``repro.train.checkpoint``, in its on-disk format).

Format: one directory ``step_<N:08d>`` per step, one ``.npy`` per tree leaf
named by its tree path (``blocks/attn/wq`` -> ``blocks__attn__wq.npy``;
dict keys in sorted order, list items by index, ``None`` leaves dropped, as
``jax.tree_util`` flattens) and an ``index.json`` with each leaf's file,
shape, dtype and CRC32 and the logical partition specs by path. A bfloat16
leaf is stored as the reference stores it: two raw bytes per element under
the ``<V2`` descriptor, ``"bfloat16"`` in the index. A checkpoint written
by either package therefore restores in the other.

Writes go to ``<dir>.tmp`` (every file fsync'd, ``index.json`` last and
itself through a temporary file and a rename), and the directory is renamed
into place: a kill at any byte of a save leaves either the previous
checkpoints intact or the new step fully published. Saves can run on a
background thread, which gets a host copy of every leaf before it starts.
Retention keeps the newest ``keep`` steps.

:func:`restore_checkpoint` re-checksums every leaf as it loads and raises
:class:`CheckpointCorruptError` on a mismatch; :func:`restore_latest_good`
walks the retained steps newest first and falls back, with a warning, past
any step that fails to restore. Leaves are restored onto the devices of the
``like`` tree's leaves.

Elastic restore: leaves are stored whole, so a checkpoint written on one
mesh restores onto any mesh, or onto none. Under a mesh
(``launch.mesh.Mesh``), :func:`save_checkpoint` gathers every sharded
leaf (each rank takes part in the all-gather), rank 0 writes, on its
thread as without a mesh, and the ranks meet at a barrier once the write
is done (:func:`finish_save`); :func:`restore_checkpoint` reads the whole
leaves on every rank and keeps each rank's slice, its spec re-resolved
against the new mesh: from ``specs`` when given, else from the specs the
writer stored, matched by path name, axes the mesh lacks dropped.

:func:`reshape_moe_layout` relays an MoE expert leaf between model-axis
sizes on the host, as the reference's does (its known fault with
``w_down`` at E < M included: ROADMAP C5). :func:`restore_checkpoint`
given ``moe_experts`` relays every stacked expert leaf written at another
model-axis size to the restoring mesh's: a reshape where the experts
divide over both sizes; where either size exceeds the expert count,
``w_down`` comes back with C5's layout, as the reference's would.

The reference's fault-injection hooks (``chaos.inject.ckpt_fault``) sit
where it puts them: right after a step's atomic publish, in the writing
process alone, and at the top of :func:`verify_checkpoint` and
:func:`restore_checkpoint`; each is a no-op without an active schedule.
Under a mesh every rank reads the one shared step, and every rank holds the
same schedule: the read hook runs on rank 0 alone, so a fault damages the
file once, and the ranks meet at a barrier before any opens a leaf
(:func:`restore_checkpoint`). :func:`restore_latest_good` then settles each step
for all ranks at once, so no rank resumes a step another refused.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.chaos import inject as _chaos

#: numpy's descriptor for a bfloat16 array as the reference writes it; a
#: bfloat16 leaf lives on the host as raw two-byte ``V2`` elements.
_BF16_DESCR = "<V2"
_BF16_HOST = np.dtype("V2")


class CheckpointCorruptError(RuntimeError):
    """A retained checkpoint failed its integrity check (CRC mismatch,
    unreadable array file, missing leaf)."""

    def __init__(self, step: int, detail: str):
        super().__init__(f"checkpoint step {step} corrupt: {detail}")
        self.step = step
        self.detail = detail


class CheckpointWriteTimeout(RuntimeError):
    """The final async checkpoint writer did not finish within the join
    timeout: the run's last state may not be on disk."""


def _crc32(arr: np.ndarray) -> str:
    return f"{zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF:08x}"


def _fsync_write(path: str, write_fn) -> None:
    """Write via ``write_fn(f)`` and fsync before close, so the atomic
    directory rename cannot publish names whose bytes are still in flight."""
    with open(path, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())


def _flatten_with_paths(tree: Any, prefix: str = "",
                        spec_leaves: bool = False) -> list[tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree_util`` order. Value trees drop
    ``None``; spec trees (``spec_leaves``) keep it and take a tuple, a
    partition spec, as a leaf."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _flatten_with_paths(
            tree[k], f"{prefix}{k}/", spec_leaves)]
    if isinstance(tree, list) or (isinstance(tree, tuple)
                                  and not spec_leaves):
        return [pair for i, v in enumerate(tree) for pair in
                _flatten_with_paths(v, f"{prefix}{i}/", spec_leaves)]
    if tree is None and not spec_leaves:
        return []
    return [(prefix[:-1], tree)]


def _rebuild(like: Any, leaves: dict[str, Any], prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return None if like is None else leaves[prefix[:-1]]


def _host_copy(leaf: torch.Tensor) -> np.ndarray:
    """A host array that owns its bytes; a bfloat16 tensor as raw ``V2``
    elements."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_HOST)
    return t.numpy()


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _BF16_HOST else str(arr.dtype)


def _save_npy(f, arr: np.ndarray) -> None:
    if arr.dtype != _BF16_HOST:
        np.save(f, arr)
        return
    np.lib.format.write_array_header_1_0(
        f, {"descr": _BF16_DESCR, "fortran_order": False,
            "shape": arr.shape})
    f.write(np.ascontiguousarray(arr).tobytes())


def bf16_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host array of two-byte bfloat16 elements (raw ``V2`` as this
    module reads them, or the reference's ``ml_dtypes.bfloat16``) -> a
    ``torch.bfloat16`` tensor on the host owning a copy of the same bits,
    through an int16 view (numpy has no bfloat16 of its own)."""
    return torch.from_numpy(
        np.ascontiguousarray(arr).view(np.int16).copy()).view(torch.bfloat16)


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = bf16_tensor(arr)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _spec_map(specs: Any) -> dict[str, list]:
    """Name -> the spec as ``index.json`` holds it: one entry per axis,
    an axis of several mesh axes as a list, ``None`` (replicated) as []."""
    return {name: [list(ax) if isinstance(ax, tuple) else ax
                   for ax in (spec or [])]
            for name, spec in _flatten_with_paths(specs, spec_leaves=True)}


def _as_spec(stored):
    """A spec as ``index.json`` (or :func:`_spec_map`) holds it -> a
    ``launch.mesh.P`` (``None`` for a replicated leaf)."""
    from repro_torch.launch.mesh import P
    return P(*(tuple(ax) if isinstance(ax, list) else ax
               for ax in stored)) if stored else None


def save_checkpoint(directory: str, step: int, tree: Any,
                    specs: Any | None = None, keep: int = 3,
                    async_save: bool = False,
                    mesh=None) -> threading.Thread | None:
    """Atomically persist ``tree`` under ``directory/step_<N>``; with
    ``async_save`` on a thread that is returned (join it before relying
    on the step). With ``mesh``, ``tree`` holds this rank's shards under
    ``specs``: every rank calls this (the leaves are gathered), rank 0
    writes, and the others return ``None`` at once; a synchronous save
    ends with every rank at a barrier after the write, an asynchronous one
    at :func:`finish_save`."""
    spec_map = _spec_map(specs) if specs is not None else {}
    if mesh is not None:
        from repro_torch.launch.mesh import gather_full
        host_leaves = []
        for name, leaf in _flatten_with_paths(tree):
            full = gather_full(leaf, _as_spec(spec_map.get(name)), mesh)
            if mesh.rank == 0:
                host_leaves.append((name, _host_copy(full)))
        if mesh.rank != 0:
            if not async_save:
                finish_save(None, mesh)
            return None
    else:
        host_leaves = [(name, _host_copy(leaf))
                       for name, leaf in _flatten_with_paths(tree)]

    def write():
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            # A crashed earlier writer for this same step: start clean
            # rather than merging stale leaf files into the new set.
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        index = {"step": step, "leaves": {}, "specs": spec_map}
        for name, arr in host_leaves:
            fname = name.replace("/", "__") + ".npy"
            _fsync_write(os.path.join(tmp, fname),
                         lambda f, a=arr: _save_npy(f, a))
            index["leaves"][name] = {"file": fname,
                                     "shape": list(arr.shape),
                                     "dtype": _dtype_name(arr),
                                     "crc": _crc32(arr)}
        # index.json last, via its own temp+rename: its presence implies
        # every leaf file (and its checksum) is already durable.
        ipath = os.path.join(tmp, "index.json")
        _fsync_write(ipath + ".tmp",
                     lambda f: f.write(json.dumps(index).encode()))
        os.replace(ipath + ".tmp", ipath)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                        # atomic publish
        _fsync_dir(directory)
        _chaos.ckpt_fault(final, step, "write")
        _apply_retention(directory, keep)

    if async_save:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    if mesh is not None:
        finish_save(None, mesh)
    return None


def finish_save(writer: threading.Thread | None, mesh=None,
                timeout: float | None = None) -> bool:
    """Waits for ``writer`` (a thread :func:`save_checkpoint` returned, or
    ``None``) up to ``timeout`` seconds, then, with ``mesh``, for every rank
    at a barrier: past it the step is on disk for all of them. Returns
    False where the writer is still running (no barrier is entered)."""
    if writer is not None:
        writer.join(timeout=timeout)
        if writer.is_alive():
            return False
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier()
    return True


def _fsync_dir(directory: str) -> None:
    """Make a directory rename durable (no-op where a directory cannot be
    opened)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def retained_steps(directory: str) -> list[int]:
    """All published step numbers, ascending (empty when the directory does
    not exist)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def _apply_retention(directory: str, keep: int) -> None:
    for step in retained_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{step:08d}"),
                      ignore_errors=True)


def latest_step(directory: str) -> int | None:
    steps = retained_steps(directory)
    return steps[-1] if steps else None


def verify_checkpoint(directory: str, step: int) -> list[str]:
    """Integrity-check one retained step without building tensors.

    Returns the list of bad leaf names (CRC mismatch, unreadable or missing
    file); empty means the step is restorable. Leaves without a ``crc``
    entry verify by loadability alone.
    """
    path = os.path.join(directory, f"step_{step:08d}")
    _chaos.ckpt_fault(path, step, "read")
    try:
        with open(os.path.join(path, "index.json")) as f:
            index = json.load(f)
    except (OSError, ValueError):
        return ["index.json"]
    bad = []
    for name, meta in index.get("leaves", {}).items():
        try:
            arr = np.load(os.path.join(path, meta["file"]))
        except (OSError, ValueError, KeyError):
            bad.append(name)
            continue
        crc = meta.get("crc")
        if crc is not None and _crc32(arr) != crc:
            bad.append(name)
    return bad


def _relay_moe(name: str, arr: np.ndarray, new_m: int,
               num_experts: int) -> np.ndarray:
    """A stacked expert leaf ``(L, M, E_loc, ., .)`` (``.../ffn/w_gate``,
    ``w_up``, ``w_down``) relaid layer by layer from its written model-axis
    size to ``new_m`` (:func:`reshape_moe_layout`); any other leaf, or one
    written at ``new_m``, as it is."""
    if arr.ndim != 5 or arr.shape[1] == new_m or not name.endswith(
            ("ffn/w_gate", "ffn/w_up", "ffn/w_down")):
        return arr
    return np.stack([reshape_moe_layout(a, arr.shape[1], new_m,
                                        num_experts) for a in arr])


def restore_checkpoint(directory: str, step: int, like: Any, mesh=None,
                       specs: Any | None = None,
                       moe_experts: int | None = None) -> Any:
    """Restore step ``step`` into the structure of ``like`` (a tree of
    tensors), each leaf on the device of ``like``'s leaf at the same path.
    Leaves are matched by path name, never by order; every one is
    re-checksummed. With ``mesh`` each leaf is this rank's slice under its
    spec re-resolved against ``mesh``: from ``specs`` when given, else the
    writer's specs from the index (matched by path; axes the mesh lacks
    dropped; a leaf without one whole). ``moe_experts`` (an MoE LM's
    expert count): the expert leaves written at another model-axis size
    are relaid to ``mesh``'s (1 without a mesh) first (the module
    docstring says where that inherits ROADMAP C5). With ``mesh`` the ranks
    share the file and hold the same fault schedule: rank 0 alone runs the
    read hook, so a fault damages the file once (two ranks flipping one
    byte would undo each other, two truncating would halve it twice), and
    every rank waits at a barrier until the damage is done."""
    new_m = mesh.shape.get("model", 1) if mesh is not None else 1
    path = os.path.join(directory, f"step_{step:08d}")
    if mesh is None or mesh.rank == 0:
        _chaos.ckpt_fault(path, step, "read")
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier()
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    spec_map = _spec_map(specs) if specs is not None else \
        index.get("specs", {})
    loaded = {}
    for name, leaf in _flatten_with_paths(like):
        meta = index["leaves"][name]
        try:
            arr = np.load(os.path.join(path, meta["file"]))
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(
                step, f"leaf {name!r} unreadable: {e}") from None
        crc = meta.get("crc")
        if crc is not None and _crc32(arr) != crc:
            raise CheckpointCorruptError(
                step, f"leaf {name!r} CRC mismatch (stored {crc}, "
                      f"loaded {_crc32(arr)})")
        if moe_experts is not None:
            arr = _relay_moe(name, arr, new_m, moe_experts)
        t = _to_tensor(arr, meta.get("dtype", ""), leaf.device)
        if mesh is not None:
            from repro_torch.launch.mesh import local_shard, resolve_spec
            t = local_shard(t, resolve_spec(_as_spec(spec_map.get(name)),
                                            mesh), mesh)
        loaded[name] = t
    return _rebuild(like, loaded)


def restore_latest_good(directory: str, like: Any, mesh=None,
                        specs: Any | None = None,
                        moe_experts: int | None = None
                        ) -> tuple[int | None, Any]:
    """Restore the newest retained step that passes its integrity checks.

    Walks retained steps newest first; a step that fails (CRC mismatch,
    truncated or missing file, unreadable index) is skipped with a warning
    and the previous retained step is tried. Also sweeps dead ``*.tmp``
    directories of crashed writers (safe here: a restore implies no save is
    in flight). Returns ``(step, tree)``, or ``(None, None)`` when no
    restorable checkpoint exists. ``mesh``, ``specs`` and ``moe_experts``
    as in :func:`restore_checkpoint`; with ``mesh`` every rank calls it,
    and after each step the ranks agree on its outcome (one MAX all-reduce
    of a "this step failed" flag): a step any rank failed to restore is
    refused by all of them.
    """
    if os.path.isdir(directory):
        for d in os.listdir(directory):
            if d.startswith("step_") and d.endswith(".tmp"):
                shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    for step in reversed(retained_steps(directory)):
        tree, error = None, None
        try:
            tree = restore_checkpoint(directory, step, like, mesh, specs,
                                      moe_experts)
        except (CheckpointCorruptError, OSError, ValueError, KeyError) as e:
            error = e
        if mesh is not None:
            # a step any rank failed is refused by all: MAX of the flag
            import torch.distributed as dist
            failed = torch.tensor([float(error is not None)],
                                  device=mesh.device)
            dist.all_reduce(failed, op=dist.ReduceOp.MAX)
            if failed.item() and error is None:
                error = CheckpointCorruptError(
                    step, "another rank failed to restore it")
        if error is None:
            return step, tree
        warnings.warn(
            f"checkpoint step {step} in {directory} failed to restore "
            f"({error}); falling back to the previous retained step",
            RuntimeWarning, stacklevel=2)
    return None, None


def reshape_moe_layout(w: np.ndarray, old_m: int, new_m: int,
                       num_experts: int) -> np.ndarray:
    """Relay an MoE physical layout (M, E_loc, D, F_loc) between meshes with
    different model-axis sizes (elastic rescale), on the host.

    The reference's function, operation for operation. Like it, this takes
    F as the last axis; ``w_down`` is (M, E_loc, F_loc, D), so at E < M its
    relay joins the slices along D (ROADMAP C5), as the reference's does.
    """
    m, el, d, fl = w.shape
    if m != old_m:
        raise ValueError(f"leaf has {m} model shards, not {old_m}")
    tp_old = max(1, old_m // num_experts)
    # back to logical (E, D, F)
    if num_experts >= old_m:
        logical = w.reshape(old_m * el, d, fl)
    else:
        logical = w.reshape(num_experts, tp_old, d, fl).transpose(0, 2, 1, 3) \
            .reshape(num_experts, d, tp_old * fl)
    # to the new physical layout
    tp_new = max(1, new_m // num_experts)
    el_new = max(1, num_experts // new_m)
    f = logical.shape[-1]
    if num_experts >= new_m:
        return logical.reshape(new_m, el_new, d, f)
    return logical.reshape(num_experts, d, tp_new, f // tp_new) \
        .transpose(0, 2, 1, 3).reshape(new_m, 1, d, f // tp_new)
