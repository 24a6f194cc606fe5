"""Dry run of every (architecture x input-shape) cell on a mesh of H100s:
does it fit on a card, and what bounds it (compute, memory or
collectives)? Results go to ``experiments/torch/dryrun/<mesh>/``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b --all-shapes

The counterpart of ``repro.launch.dryrun``, by another method. The
reference compiles each cell with XLA for a mesh of TPUs and reads the
compiler's cost and memory analyses and the collectives of its HLO. The
port has no compiler to ask: it **runs the step once, at full depth, on
``meta`` tensors** (shapes and dtypes, no storage), as one rank of a fake
process group of the mesh's size (``torch.testing``'s ``fake`` backend: the
collectives are dispatched and do nothing), and counts as it goes
(:class:`StepCounter`):

* flops: ``torch.utils.flop_counter.FlopCounterMode`` over the dispatched
  products, plus, at each kernel site, the dense 2 * M * C * K of the
  product the kernel forms (as XLA counts the reference's dot; a spike
  product's sparse count belongs to the kernel table in PERF.md). On
  ``meta`` the kernel wrappers allocate their kernels' outputs and report
  the site (``repro_torch.kernels.meta_site``), launching nothing;
* bytes: the operands plus the results of every dispatched op, a kernel
  site counting as one op (its operands plus its results). Allocations,
  views and collectives move none. An unfused count, as XLA's "bytes
  accessed" is one over its fusions;
* collectives: the bytes of each collective's result, by the reference's
  kinds (:func:`collective_bytes`);
* peak bytes per rank: the bytes of the storages alive at once through the
  step, each rounded up to 512 bytes as the CUDA caching allocator rounds,
  the inputs (parameters, optimizer state, the rank's rows, the cache)
  counted from the start.

The meshes: the production ones, ``pod16x16`` (data 16, model 16) and
``pod2x16x16`` (pod 2, data 16, model 16), and the same with the model
axis at 1, ``data16`` (the default) and ``pod2xdata16`` (``--multi-pod``).
Every cell runs on a model axis (every attention scheme, MLA, the MoE's
all-to-all, the recurrent heads, the encoder-decoder).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.specs import SHAPES, input_specs

OUT_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "experiments", "torch",
    "dryrun"))

# NVIDIA H100 SXM (80 GB HBM3) constants, the published ones (per card)
PEAK_FLOPS = 989e12       # dense bf16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12   # fp32 outside the tensor cores (the port: TF32 off)
HBM_BW = 3.35e12          # HBM3, bytes/s
HBM_BYTES = 80e9          # HBM3 capacity
ICI_BW = 450e9            # NVLink 4, bytes/s a direction, within a node
NODE_GPUS = 8             # GPUs an NVLink node joins
IB_BW = 50e9              # one 400 Gb/s NDR port a GPU, between nodes

#: The meshes a cell runs on: name -> (axis names, sizes).
MESHES = {"data16": (("data", "model"), (16, 1)),
          "pod2xdata16": (("pod", "data", "model"), (2, 16, 1)),
          "pod16x16": (("data", "model"), (16, 16)),
          "pod2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def peak_flops(dtype: torch.dtype) -> float:
    """The card's peak for products in ``dtype``: the tensor cores' dense
    rate for bf16 and fp16, else fp32's outside them (the port keeps TF32
    off)."""
    return PEAK_FLOPS if dtype in (torch.bfloat16, torch.float16) \
        else PEAK_FLOPS_FP32


def link_bw(devices: int) -> float:
    """Bytes/s a GPU's collectives move: NVLink 4 (``ICI_BW``) on a mesh
    that fits in one node of ``NODE_GPUS``, else one NDR port (``IB_BW``),
    which a ring across nodes is bound by."""
    return ICI_BW if devices <= NODE_GPUS else IB_BW


# ---------------------------------------------------------------------------
# The fake process group and the meshes on it
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(size: int):
    """The default process group for the block: rank 0 of ``size`` on the
    ``fake`` backend (its collectives do nothing), destroyed on the way
    out, so that nothing stays initialised. Refuses to start where a group
    is running."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is running: the dry run makes "
                           "its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_shape(mesh_name: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """(axis names, sizes) of a dry-run mesh."""
    if mesh_name not in MESHES:
        raise ValueError(f"unknown mesh {mesh_name!r}; one of "
                         f"{sorted(MESHES)}")
    return MESHES[mesh_name]


def make_mesh(mesh_name: str):
    """The named mesh over the running (fake) group, its tensors on
    ``meta``: its batch and model groups are made on the fake backend
    too."""
    from repro_torch.launch.mesh import Mesh
    names, sizes = mesh_shape(mesh_name)
    return Mesh(sizes, names, torch.device("meta"))


# ---------------------------------------------------------------------------
# Counting a step
# ---------------------------------------------------------------------------

#: The collectives the port dispatches (``all_gather_into_tensor``,
#: ``all_reduce``, ``reduce_scatter_tensor``, ``all_to_all_single``) -> the
#: reference's kinds; any other one raises rather than go uncounted.
COLLECTIVE_KINDS = {"_allgather_base_": "all-gather",
                    "allreduce_": "all-reduce",
                    "_reduce_scatter_base_": "reduce-scatter",
                    "alltoall_base_": "all-to-all"}

#: Ops that move no bytes: allocations, and views the schema does not mark.
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "empty_permuted", "lift_fresh",
             "_unsafe_view"}
ALLOC_ROUND = 512


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes ``t`` spans: its elements, a broadcast (stride 0) dim
    counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts what the ops dispatched inside it do (see the module
    docstring): ``bytes``, ``collectives`` ({kind: bytes}), ``kernel_flops``
    and ``kernel_sites`` ({kernel: calls}) at the wrappers' ``meta``
    branches, and the live bytes of storages (``live``, ``peak``), which
    :meth:`hold` seeds with the inputs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0.0
        self.collectives: dict[str, float] = {}
        self.kernel_flops: dict[str, float] = {}
        self.kernel_sites: dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._sizes: dict[int, int] = {}

    def hold(self, tree) -> int:
        """Counts the storages of ``tree``'s tensors as live (from now
        until they are freed); returns their bytes."""
        return sum(self._track(t) for t in _tensors(tree))

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return 0
        n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def storages(self) -> set[int]:
        return set(self._sizes)

    def _site(self, name, operands, results, flops) -> None:
        self.kernel_sites[name] = self.kernel_sites.get(name, 0) + 1
        self.kernel_flops[name] = self.kernel_flops.get(name, 0.0) + flops
        self.bytes += sum(tensor_bytes(t) for t in operands) + \
            sum(tensor_bytes(t) for t in _tensors(results))

    def __enter__(self):
        from repro_torch import kernels
        kernels.META_OBSERVERS.append(self._site)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch import kernels
        kernels.META_OBSERVERS.remove(self._site)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "c10d":
            if name not in COLLECTIVE_KINDS:
                raise NotImplementedError(f"the dry run counts no c10d.{name}")
            # the result: the output operand, or the tensors an all-reduce
            # writes in place; both are the first argument
            kind = COLLECTIVE_KINDS[name]
            self.collectives[kind] = self.collectives.get(kind, 0.0) + \
                sum(tensor_bytes(t) for t in _tensors(args[0]))
        elif not (func.is_view or name in _NO_BYTES):
            self.bytes += sum(tensor_bytes(t) for t in _tensors(args)) + \
                sum(tensor_bytes(t) for t in _tensors(kwargs)) + \
                sum(tensor_bytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._track(t)
        return out


def count_step(fn, args: tuple) -> dict:
    """Runs ``fn(*args)`` once on ``meta`` tensors and counts it: ``flops``
    (the dispatched products plus the kernel sites'), ``bytes``,
    ``collectives`` ({kind: bytes}), ``argument`` (the bytes of ``args``),
    ``output`` (of the results that are not ``args``' storages), ``peak``
    (live bytes at most, ``args`` included), ``kernel_sites`` ({kernel:
    calls}), ``kernel_flops`` ({kernel: its sites' product flops}) and
    ``seconds``."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = StepCounter()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, counter:
        argument = counter.hold(args)
        inputs = counter.storages()
        out = fn(*args)
        output = sum(-(-t.untyped_storage().nbytes() // ALLOC_ROUND)
                     * ALLOC_ROUND for t in {
                         id(t.untyped_storage()): t
                         for t in _tensors(out)}.values()
                     if id(t.untyped_storage()) not in inputs)
    seconds = time.perf_counter() - t0
    del out
    return {"flops": float(flops.get_total_flops())
            + sum(counter.kernel_flops.values()),
            "bytes": counter.bytes, "collectives": counter.collectives,
            "argument": argument, "output": output, "peak": counter.peak,
            "kernel_sites": counter.kernel_sites,
            "kernel_flops": counter.kernel_flops, "seconds": seconds}


def collective_bytes(fn, *args, **kwargs) -> dict[str, float]:
    """``fn(*args, **kwargs)`` run under the counter: the bytes of each
    collective kind's results (the reference's convention: an all-gather's
    gathered tensor, a reduce-scatter's shard, an all-reduce's tensor)."""
    counter = StepCounter()
    with counter:
        fn(*args, **kwargs)
    return counter.collectives


def shard_args(structs, specs, mesh):
    """This rank's shard of each struct under its spec (the whole struct
    without a mesh)."""
    from repro_torch.launch.mesh import Mesh, local_shard, map_specs
    if not isinstance(mesh, Mesh):
        return structs
    return tuple(map_specs(lambda spec, leaf: local_shard(leaf, spec, mesh),
                           sp, st) for st, sp in zip(structs, specs))


# ---------------------------------------------------------------------------
# The cell
# ---------------------------------------------------------------------------

def model_flops(cfg, shape_name) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference), N = the active
    parameters (a MoE's inactive experts taken out), as in the reference.
    A Spikingformer (which the reference does not count): 2 x the
    multiply-adds of the paper's training step (E2ATST Fig. 12, the
    blocks' products of FP, BP and WG; ``core.energy.workload``), at the
    cell's batch."""
    sh = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if getattr(cfg, "family", None) == "vision":
        from repro_torch.core.energy.workload import (
            SpikingWorkloadConfig, spikingformer_training_workload)
        mms, _ = spikingformer_training_workload(SpikingWorkloadConfig(
            num_layers=cfg.num_layers, h=cfg.n_heads, d_model=cfg.d_model,
            d_ff=cfg.d_ff, P=cfg.patch_grid, T=cfg.time_steps,
            BS=sh.batch))
        return float(sum(op.flops for op in mms))
    n_params = cfg.param_count()
    if cfg.moe is not None:
        inactive = 3 * cfg.d_model * cfg.moe.d_ff_expert * \
            (cfg.moe.num_experts - cfg.moe.top_k) * cfg.num_layers
        n_params -= inactive
    toks = sh.batch * (sh.seq if sh.kind != "decode" else 1)
    per_tok = 6 * n_params if sh.kind == "train" else 2 * n_params
    return per_tok * toks


def product_dtype(cfg) -> torch.dtype:
    """The dtype of the cell's products: its parameters'."""
    return getattr(cfg, "dtype", torch.float32)


def roofline(counts: dict, dtype: torch.dtype, devices: int) -> dict:
    """The three terms of a counted step on the H100 and the largest."""
    compute_s = counts["flops"] / peak_flops(dtype)
    memory_s = counts["bytes"] / HBM_BW
    collective_s = sum(counts["collectives"].values()) / link_bw(devices)
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s,
            "bound": max(("compute", compute_s), ("memory", memory_s),
                         ("collective", collective_s),
                         key=lambda kv: kv[1])[0]}


def cell_result(arch: str, shape_name, cfg, counts: dict, mesh_name: str,
                devices: int) -> dict:
    """The reference's keys for a counted cell, plus ``fits``,
    ``kernel_sites`` and the peak the roofline was taken at."""
    mf = model_flops(cfg, shape_name)
    flops = counts["flops"]
    peak = counts["peak"]
    return {
        "arch": arch,
        "shape": shape_name if isinstance(shape_name, str) else
        dataclasses.asdict(shape_name),
        "mesh": mesh_name, "devices": devices,
        "compile_s": round(counts["seconds"], 1),
        "bytes_per_device": {
            "argument": counts["argument"], "output": counts["output"],
            "temp": peak - counts["argument"], "peak": peak},
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": counts["bytes"],
        "collective_bytes_per_device": counts["collectives"],
        "roofline": roofline(counts, product_dtype(cfg), devices),
        "model_flops_global": mf,
        "model_flops_per_device": mf / devices,
        "useful_flops_ratio": (mf / devices) / flops if flops else None,
        "fits": peak <= HBM_BYTES,
        "peak_flops": peak_flops(product_dtype(cfg)),
        "link_bw": link_bw(devices),
        "kernel_sites": counts["kernel_sites"],
    }


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             out_dir: str) -> dict:
    """Counts one cell on ``mesh`` (a :class:`~repro_torch.launch.mesh.
    Mesh` over the running fake group, :func:`make_mesh`) and writes
    ``<arch>__<shape>.json`` in ``out_dir``. The keys are the reference's,
    counted as the module docstring says: ``hlo_flops_per_device`` and
    ``hlo_bytes_per_device`` over the dispatched ops, the collectives' by
    kind, ``compile_s`` the seconds of the counted run,
    ``bytes_per_device`` the inputs (``argument``), the results that are
    new storages (``output``), the peak less the inputs (``temp``) and the
    peak; plus ``fits`` (peak <= ``HBM_BYTES``)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch).with_model_shards(mesh.shape.get("model", 1))
    fn, structs, specs = input_specs(cfg, shape_name, mesh)
    args = shard_args(structs, specs, mesh)
    del structs
    counts = count_step(fn, args)
    result = cell_result(arch, shape_name, cfg, counts, mesh_name, mesh.size)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape_name}.json"), "w") as f:
        json.dump(result, f, indent=2)
    return result


def dry_run_cell(arch: str, shape_name: str, mesh_name: str,
                 out_dir: str) -> dict:
    """:func:`run_cell` inside a fake group of the mesh's size, made and
    destroyed around it."""
    size = math.prod(mesh_shape(mesh_name)[1])
    with fake_world(size):
        return run_cell(arch, shape_name, make_mesh(mesh_name), mesh_name,
                        out_dir)


def cells_for(arch: str) -> list[str]:
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        shapes.append("long_500k")
    return shapes


def main(argv=None) -> None:
    from repro_torch.configs.registry import ASSIGNED
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--all-shapes", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None, choices=sorted(MESHES),
                    help="default data16; --multi-pod: pod2xdata16")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    mesh_name = args.mesh or ("pod2xdata16" if args.multi_pod else "data16")
    out_dir = args.out or os.path.join(OUT_DIR, mesh_name)

    if args.all:
        targets = [(a, s) for a in ASSIGNED for s in cells_for(a)]
    elif args.all_shapes:
        targets = [(args.arch, s) for s in cells_for(args.arch)]
    else:
        targets = [(args.arch, args.shape)]

    ok, fail = 0, 0
    for arch, shape in targets:
        marker = os.path.join(out_dir, f"{arch}__{shape}.json")
        if os.path.exists(marker):
            print(f"[skip] {arch} x {shape} (cached)")
            ok += 1
            continue
        try:
            r = dry_run_cell(arch, shape, mesh_name, out_dir)
            rl = r["roofline"]
            print(f"[ok] {arch} x {shape}: peak="
                  f"{r['bytes_per_device']['peak'] / 1e9:.2f}GB "
                  f"fits={r['fits']} "
                  f"compute={rl['compute_s']:.2e}s mem={rl['memory_s']:.2e}s "
                  f"coll={rl['collective_s']:.2e}s bound={rl['bound']} "
                  f"(trace {r['compile_s']}s)", flush=True)
            ok += 1
        except Exception as e:
            fail += 1
            print(f"[FAIL] {arch} x {shape}: {type(e).__name__}: "
                  f"{str(e)[:300]}", flush=True)
            traceback.print_exc()
    print(f"dry-run complete: {ok} ok, {fail} failed")
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
