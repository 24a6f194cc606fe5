"""Baseline and named variants of three cells, each counted by the dry run
(``launch.dryrun.count_step``) on ``data16`` and appended to
``experiments/torch/perf/<cell>.json`` (the counterpart of
``repro.launch.perf``).

Cells (the reference's):
  qwen3-0.6b  x train_4k   - flash attention in training, remat
  pixtral-12b x decode_32k - where the cache shards, how it is updated
  spikingformer x train    - the paper's own model, global batch 2048

  PYTHONPATH=src python -m repro_torch.launch.perf --cell qwen3 [--variant flash_train]

The reference re-lowers each variant with XLA; here each runs once on
``meta`` tensors under a fake group of the mesh's size. On a model axis
of 1 the pixtral ``baseline`` (the cache's trailing dim on the model axis)
and ``seq_sharded_cache`` (its heads or sequence) place the cache alike,
so they count the same.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch.dryrun import (HBM_BW, count_step, fake_world,
                                       link_bw, make_mesh, mesh_shape,
                                       peak_flops, shard_args)
from repro_torch.launch.specs import ShapeSpec, input_specs

OUT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                   "..", "experiments", "torch", "perf"))


def _terms(flops, bytes_, coll, dtype=torch.bfloat16, devices=16):
    total_coll = sum(coll.values())
    return {"compute_s": flops / peak_flops(dtype),
            "memory_s": bytes_ / HBM_BW,
            "collective_s": total_coll / link_bw(devices),
            "hlo_flops": flops, "hlo_bytes": bytes_,
            "collective_bytes": coll}


def _measure(cfg, shape, mesh) -> dict:
    """One counted run of ``cfg``'s cell ``shape`` on ``mesh``."""
    fn, structs, specs = input_specs(cfg, shape, mesh)
    counts = count_step(fn, shard_args(structs, specs, mesh))
    out = _terms(counts["flops"], counts["bytes"], counts["collectives"],
                 getattr(cfg, "dtype", torch.float32), mesh.size)
    out["peak_bytes"] = counts["peak"]
    out["kernel_sites"] = counts["kernel_sites"]
    return out


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def measure_lm(cfg, shape_name: str, mesh) -> dict:
    """The three terms and the peak of an LM cell at full depth."""
    return _measure(cfg, shape_name, mesh)


LM_VARIANTS = {
    "qwen3": {
        "arch": "qwen3-0.6b", "shape": "train_4k",
        "variants": {
            "baseline": lambda c: c,
            # training attention materialises (B, H, S, S) scores three
            # times (forward, recompute, backward); flash chunks do not
            "flash_train": lambda c: c.replace(flash_train=True),
            # no recompute: one forward fewer, the activations stored
            "flash_no_remat": lambda c: c.replace(flash_train=True,
                                                  remat=False),
        },
    },
    "pixtral": {
        "arch": "pixtral-12b", "shape": "decode_32k",
        "variants": {
            # the cache's trailing dim on the model axis, one-hot update
            "baseline": lambda c: c.replace(cache_shard="trailing"),
            # heads (or the sequence) on the model axis
            "seq_sharded_cache": lambda c: c.replace(cache_shard="auto"),
            # a scatter writes the one new row instead of the whole cache
            "scatter_cache": lambda c: c.replace(cache_shard="auto",
                                                 scatter_cache=True),
        },
    },
}


# ---------------------------------------------------------------------------
# Spikingformer cell (the paper's model at pod scale)
# ---------------------------------------------------------------------------

def spiking_cfg(**kw):
    """``spikingformer-8-512`` under ``cuda-full`` with blocks recomputed
    in the backward, in fp32 (the kernels' dtype; the reference's cell is
    bf16), with ``kw`` replaced."""
    from repro_torch.configs.spikingformer import get_spikingformer_config
    base = dict(remat=True)
    base.update(kw)
    return dataclasses.replace(
        get_spikingformer_config("spikingformer-8-512@cuda-full"), **base)


SPIKING_VARIANTS = {
    "baseline": dict(),
    # eq. 10 has no softmax: (QK^T)V reassociates exactly to Q(K^T V)
    "reassoc_qkv": dict(qk_first=False),
    # no recompute of the blocks in the backward
    "no_remat": dict(remat=False),
    "reassoc_no_remat": dict(qk_first=False, remat=False),
}


def measure_spiking(cfg, mesh, global_batch: int = 2048) -> dict:
    """The three terms and the peak of the vision train step (gradient and
    AdamW, data parallel over ``mesh``) at ``global_batch`` images."""
    return _measure(cfg, ShapeSpec("train", 0, global_batch), mesh)


def _counted(mesh_name: str, measure):
    """``measure(mesh)`` inside a fake group of the mesh's size."""
    with fake_world(math.prod(mesh_shape(mesh_name)[1])):
        return measure(make_mesh(mesh_name))


def run_cell(cell: str, variant: str | None, multi_pod: bool = False,
             out_dir: str = OUT) -> dict:
    mesh_name = "pod2xdata16" if multi_pod else "data16"
    os.makedirs(out_dir, exist_ok=True)
    results = {}
    if cell == "spikingformer":
        variants = SPIKING_VARIANTS if variant is None else \
            {variant: SPIKING_VARIANTS[variant]}
        for name, kw in variants.items():
            t0 = time.time()
            m = _counted(mesh_name, lambda mesh: measure_spiking(
                spiking_cfg(**kw), mesh))
            m["compile_s"] = round(time.time() - t0, 1)
            results[name] = m
            print(f"[{cell}:{name}] compute={m['compute_s']:.3e}s "
                  f"mem={m['memory_s']:.3e}s coll={m['collective_s']:.3e}s "
                  f"peak={m['peak_bytes'] / 1e9:.2f}GB", flush=True)
        path = os.path.join(out_dir, "spikingformer__train.json")
    else:
        spec = LM_VARIANTS[cell]
        cfg0 = get_config(spec["arch"])
        variants = spec["variants"] if variant is None else \
            {variant: spec["variants"][variant]}
        for name, tf in variants.items():
            t0 = time.time()
            m = _counted(mesh_name, lambda mesh: measure_lm(
                tf(cfg0), spec["shape"], mesh))
            m["compile_s"] = round(time.time() - t0, 1)
            results[name] = m
            print(f"[{cell}:{name}] compute={m['compute_s']:.3e}s "
                  f"mem={m['memory_s']:.3e}s coll={m['collective_s']:.3e}s "
                  f"peak={m['peak_bytes'] / 1e9:.2f}GB", flush=True)
        path = os.path.join(out_dir, f"{spec['arch']}__{spec['shape']}.json")
    existing = json.load(open(path)) if os.path.exists(path) else {}
    existing.update(results)
    with open(path, "w") as f:
        json.dump(existing, f, indent=2)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True,
                    choices=["qwen3", "pixtral", "spikingformer"])
    ap.add_argument("--variant", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    run_cell(args.cell, args.variant, args.multi_pod)


if __name__ == "__main__":
    main()
