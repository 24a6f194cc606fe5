"""Analytic candidate oracle over the paper's dataflow model, on the card.

The counterpart of ``repro.tune.oracle``. The spike matmul of
``csrc/spike_matmul.cu`` is output-stationary streaming the contraction
axis (a block keeps its ``bm x bn`` accumulators while it walks C in
``bk`` chunks), i.e. the paper's ``OS_C`` dataflow with the *kernel tile*
playing the role of the PE array. So a candidate ``(block_m, block_k,
block_c)`` is scored by eq. 26-28 + the uniform bandwidth bound
(:func:`~repro_torch.core.energy.dataflow.mm_latency_cycles`) on an array of
``rows=block_m, cols=block_k``, plus a fixed per-step overhead that
penalizes small contraction chunks; :func:`candidate_cycles` and
:func:`_pipeline_extra_cycles` are the reference's arithmetic unchanged.

What is the card's and not the TPU's: the array (:func:`oracle_array`, the
H100's published peaks), the candidates (the two tiles of
``csrc/spike_mma_mainloop.cuh``, ``spike_matmul.TILES``, not a grid of
block sizes: the kernel's contraction chunk is fixed per tile) and the
feasibility test (the tile's shared memory against the card's per-block
limit). The oracle is pure arithmetic: deterministic and total-ordered
(ties break on the block tuple), so the timed sweep measures only its
top-K.

For trailing-LIF sites the neuron layer adds an *arm* axis: ``fused`` (one
``neuron_layer_train`` call over all T*M rows, its product on the Large
tile; ``block_m`` None as in the reference) vs ``pipeline`` (the spike
matmul on either tile, then ``bn_fwd`` and ``lif_soma_fwd``, paying the
(T, M, K) pre-activation round trip through device memory that the fused
arm's SOMA pass also makes, but the reference's model charges only the
pipeline). A dense site's pipeline multiplies with ``torch.matmul`` and
has no tile: one candidate with no blocks.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.energy.constants import (
    DEFAULT_ARRAY, H100_HBM_BW, H100_L2_BYTES, H100_PEAK_FLOPS_BF16,
    H100_SM_CLOCK_HZ, H100_SMEM_BYTES_PER_CLOCK, H100_SMEM_PER_BLOCK,
    H100_SMS, ArrayConfig)
from repro_torch.core.energy.dataflow import (Dataflow, Inner, Outer,
                                              best_dataflow,
                                              mm_latency_cycles)
from repro_torch.core.energy.workload import MMOp
from repro_torch.kernels.spike_matmul import TILES
from repro_torch.tune.table import TunedBlocks
from repro_torch.tune.workloads import SiteWorkload

#: Fixed cost charged per grid step (one tile's visit of one contraction
#: chunk). Penalizes degenerate small chunks the bandwidth terms alone
#: would rank as free.
GRID_STEP_OVERHEAD_CYCLES = 128.0

#: Bf16 tensor-core passes per exact fp32 product: the kernel splits every
#: weight into three bf16 planes (``spike_matmul.split_bf16x3``).
MMA_PASSES = 3

#: The tile the fused arm's product runs on (``ZTile`` of
#: ``csrc/neuron_layer.cu``, the ``Large`` tile).
FUSED_TILE = 1

_OS_C = Dataflow(Inner.OS, Outer.C)


@dataclasses.dataclass(frozen=True)
class OracleCandidate:
    """One scored candidate; ``block_m is None`` on the fused train arm
    (all T*M rows in one call) and every block None on a dense pipeline."""

    block_m: int | None
    block_k: int | None
    block_c: int | None
    arm: str | None
    cycles: float
    smem_bytes: int
    feasible: bool

    def as_tuned(self, *, measured_us: float | None = None,
                 sparsity: float | None = None) -> TunedBlocks:
        return TunedBlocks(block_m=self.block_m, block_k=self.block_k,
                           block_c=self.block_c, arm=self.arm,
                           oracle_cycles=self.cycles,
                           measured_us=measured_us, sparsity=sparsity)

    def sort_key(self):
        return (self.cycles, self.block_m or 0, self.block_k or 0,
                self.block_c or 0, self.arm or "")


def oracle_array() -> ArrayConfig:
    """The H100 as one scoring array: the Large tile's outputs as the PE
    array, clocked so that it does the card's dense bf16 peak over the
    kernel's three passes, device memory and shared memory at their
    published rates per such cycle, and the L2 split into the three SRAM
    banks (the candidate feasibility check guards shared memory
    separately)."""
    big = TILES[FUSED_TILE]
    freq = H100_PEAK_FLOPS_BF16 / MMA_PASSES / (big.bm * big.bn * 2)
    smem_rate = H100_SMS * H100_SMEM_BYTES_PER_CLOCK * H100_SM_CLOCK_HZ
    bank = H100_L2_BYTES // 3
    return dataclasses.replace(
        DEFAULT_ARRAY, rows=big.bm, cols=big.bn, freq_hz=freq,
        sram_in_bytes=bank, sram_w_bytes=bank, sram_out_bytes=bank,
        dram_bytes_per_cycle=H100_HBM_BW / freq,
        sram_bytes_per_cycle=smem_rate / freq)


def candidate_cycles(mm: MMOp, bm: int, bk: int, bc: int,
                     arr: ArrayConfig) -> float:
    """Latency of ``mm`` under OS_C with (bm, bk) as the stationary tile
    and the contraction streamed in bc-chunks."""
    eff_bm = max(1, min(bm, mm.B))
    eff_bk = max(1, min(bk, mm.K))
    eff_bc = max(1, min(bc, mm.C))
    tile_arr = dataclasses.replace(arr, rows=eff_bm, cols=eff_bk)
    base = mm_latency_cycles(mm, _OS_C, tile_arr)
    steps = (math.ceil(mm.B / eff_bm) * math.ceil(mm.K / eff_bk) *
             math.ceil(mm.C / eff_bc) * mm.count)
    return base + steps * GRID_STEP_OVERHEAD_CYCLES


def _pipeline_extra_cycles(mm: MMOp, arr: ArrayConfig) -> float:
    """The (T, M, K) fp16 pre-activation round trip through device memory
    (write by the matmul, read back by BN/SOMA) that the pipeline arm pays."""
    bits = 2 * mm.B * mm.K * mm.out_bits * mm.count
    return bits / 8 / arr.dram_bytes_per_cycle


def oracle_rank(wl: SiteWorkload, arr: ArrayConfig | None = None,
                top_k: int | None = None) -> list[OracleCandidate]:
    """Rank feasible candidates for one site, best first.

    Empty for non-tunable sites (dense/eager impls have no knob). The
    ordering is a pure function of the workload — stable across runs.
    """
    if not wl.tunable or wl.mm is None:
        return []
    arr = arr if arr is not None else oracle_array()
    mm = wl.mm
    cands: list[OracleCandidate] = []

    def tiled(tile, arm, extra=0.0):
        cands.append(OracleCandidate(
            tile.bm, tile.bn, tile.bk, arm,
            candidate_cycles(mm, tile.bm, tile.bn, tile.bk, arr) + extra,
            tile.smem, tile.smem <= H100_SMEM_PER_BLOCK))

    if wl.impl != "fused_epilogue" or not wl.trailing_lif:
        for tile in TILES.values():
            tiled(tile, None)
    else:
        big = TILES[FUSED_TILE]
        # fused arm: one call over all T*M rows, its product on Large
        cands.append(OracleCandidate(
            None, big.bn, big.bk, "fused",
            candidate_cycles(mm, mm.B, big.bn, big.bk, arr), big.smem,
            big.smem <= H100_SMEM_PER_BLOCK))
        extra = _pipeline_extra_cycles(mm, arr)
        if wl.packed:       # pipeline arm: the spike matmul on either tile
            for tile in TILES.values():
                tiled(tile, "pipeline", extra)
        else:               # dense pipeline: torch.matmul, no tile
            cands.append(OracleCandidate(
                None, None, None, "pipeline",
                candidate_cycles(mm, big.bm, big.bn, big.bk, arr) + extra,
                0, True))

    # dedupe duplicates, keep feasible, stable total order
    seen: set[tuple] = set()
    ranked = []
    for c in sorted(cands, key=OracleCandidate.sort_key):
        key = (c.block_m, c.block_k, c.block_c, c.arm)
        if key in seen or not c.feasible:
            continue
        seen.add(key)
        ranked.append(c)
    return ranked[:top_k] if top_k else ranked


def oracle_best_dataflow(wl: SiteWorkload) -> str:
    """The paper-model dataflow choice for this site's training MMs on the
    paper's 64x64 array."""
    from repro_torch.tune.workloads import training_mms

    mms = training_mms(wl)
    return best_dataflow(mms).name if mms else "-"
