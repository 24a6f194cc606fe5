"""Synthetic data streams: deterministic, host-shardable, learnable.

A copy of ``repro.train.data``'s two streams (numpy, the same seeds), so
both packages see identical batches: batch ``step`` of host ``host_index``
draws from ``numpy.random.default_rng((seed, step, host_index))``.

Under data parallelism every rank draws the whole global batch,
``batch(step)``, as the reference's single-host driver does, and
:func:`place_batch` gives it its rows: the same stream on any number of
ranks. ``batch(step, host_index, host_count)`` draws another stream, one
per host, for runs across hosts that each load only their own rows.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    branching: int = 4          # candidate next-tokens per token


class SyntheticLM:
    """Deterministic bigram-process token stream: a fixed (vocab,
    branching) transition table drawn from the dataset seed generates
    sequences whose next-token distribution is low-entropy."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.table = rng.integers(
            0, cfg.vocab_size,
            size=(cfg.vocab_size, cfg.branching)).astype(np.int32)

    def batch(self, step: int, host_index: int = 0,
              host_count: int = 1) -> dict[str, np.ndarray]:
        cfg = self.cfg
        local = cfg.global_batch // host_count
        rng = np.random.default_rng((cfg.seed, step, host_index))
        toks = np.empty((local, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=local)
        choices = rng.integers(0, cfg.branching, size=(local, cfg.seq_len))
        for t in range(cfg.seq_len):
            toks[:, t + 1] = self.table[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def iterator(self, start_step: int = 0, host_index: int = 0,
                 host_count: int = 1) -> Iterator[dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step, host_index, host_count)
            step += 1


@dataclasses.dataclass(frozen=True)
class VisionDataConfig:
    image_size: int
    num_classes: int
    global_batch: int
    channels: int = 3
    seed: int = 1234
    # Emit {0,1} spike frames (DVS-style event data) by thresholding the
    # blob images; models with ``spike_input=True`` pack the first stage's
    # raw values, so their stream must be binary.
    spikes: bool = False


class SyntheticVision:
    """Deterministic quadrant-blob classification stream (learnable).

    Each image is Gaussian noise plus a bright blob in one of four
    quadrants; the label is the quadrant. Each host generates only its
    slice of the global batch, keyed by (seed, step, host_index).
    """

    def __init__(self, cfg: VisionDataConfig):
        self.cfg = cfg

    def batch(self, step: int, host_index: int = 0,
              host_count: int = 1) -> dict[str, np.ndarray]:
        cfg = self.cfg
        local = cfg.global_batch // host_count
        size = cfg.image_size
        rng = np.random.default_rng((cfg.seed, step, host_index))
        labels = rng.integers(0, min(4, cfg.num_classes),
                              size=local).astype(np.int32)
        imgs = rng.normal(0, 0.1, size=(local, size, size,
                                        cfg.channels)).astype(np.float32)
        half = size // 2
        for i, lab in enumerate(labels):
            y0 = (int(lab) // 2) * half
            x0 = (int(lab) % 2) * half
            imgs[i, y0:y0 + half, x0:x0 + half] += 1.0
        if cfg.spikes:   # blob pixels (~1.0) fire, background noise doesn't
            imgs = (imgs > 0.5).astype(np.float32)
        return {"images": imgs, "labels": labels}

    def iterator(self, start_step: int = 0, host_index: int = 0,
                 host_count: int = 1) -> Iterator[dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step, host_index, host_count)
            step += 1


def place_batch(batch: dict[str, np.ndarray], mesh=None, device=None
                ) -> dict[str, torch.Tensor]:
    """A host batch as tensors on the device: whole on ``device`` without a
    mesh; with one, this rank's rows of the global batch (its contiguous
    slice of the leading dim by its coordinate over the batch axes, pod
    major) on the mesh's device, as the reference's ``place_batch`` shards
    the leading dim over ("pod", "data")."""
    if mesh is None:
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    from repro_torch.launch.mesh import P, batch_axes, local_shard
    spec = P(batch_axes(mesh) or None)
    return {k: local_shard(torch.from_numpy(v), spec, mesh).to(mesh.device)
            for k, v in batch.items()}
