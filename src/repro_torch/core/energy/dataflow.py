"""Systolic-array dataflow model (E2ATST §V, eq. 26-28, Fig. 8).

Nine dataflow schemes = internal stationarity {IS, WS, OS} x external
partition loop {B, C, K} for an MM of shape (B, C) x (C, K) -> (B, K) on a
D_row x D_col array.

* Internal mode fixes which two dims are spatially unrolled ("D1"/"D2") and
  which dim streams temporally through the array (the ``T`` of eq. 26):
      OS: (B, K) stationary, stream C     (psums stay in the PEs)
      WS: (C, K) stationary, stream B
      IS: (B, C) stationary, stream K
* The external loop dim decides DRAM<->SRAM reuse: whichever operand's reuse
  distance exceeds its SRAM bank must be re-fetched per outer tile.

Latency follows eq. 26/27 (wavefront fill + stream) combined with the uniform
memory-bandwidth bound of [31] (ZigZag's latency model): the realized cycle
count of an MM is max(compute cycles, DRAM stream cycles, SRAM stream cycles).
"""
from __future__ import annotations

import dataclasses
import logging
import math
from enum import Enum

from repro_torch.core.energy.constants import ArrayConfig, DEFAULT_ARRAY
from repro_torch.core.energy.workload import MMOp

logger = logging.getLogger(__name__)

#: Degenerate shapes already warned about (once per distinct shape, not per
#: call — ``best_dataflow`` scores nine dataflows over the same op list).
_WARNED_DEGENERATE: set[tuple[str, int, int, int, int]] = set()


def _sanitized(mm: MMOp) -> MMOp:
    """Clamp degenerate MM dims so the eq. 26-28 model stays well-defined.

    Shapes with a zero/negative dim (or count) would make ``compute_cycles``
    return 0, ``utilization`` divide by zero, and ``mm_latency_cycles`` rank
    the op as free — a nonsense ordering in ``best_dataflow``. Such shapes
    carry no real work, so clamp every dim to >= 1 (one element still costs a
    wavefront fill) and say so once per shape at WARNING level.
    """
    dims = (mm.B, mm.C, mm.K, mm.count)
    if min(dims) >= 1:
        return mm
    key = (mm.name, *dims)
    if key not in _WARNED_DEGENERATE:
        _WARNED_DEGENERATE.add(key)
        logger.warning(
            "degenerate MM shape for %r: B=%d C=%d K=%d count=%d; clamping "
            "dims to >= 1 so cycle counts stay positive and utilization "
            "bounded (eq. 26-28 assume at least one element per dim)",
            mm.name, mm.B, mm.C, mm.K, mm.count)
    return dataclasses.replace(
        mm, B=max(1, mm.B), C=max(1, mm.C), K=max(1, mm.K),
        count=max(1, mm.count))


class Inner(str, Enum):
    IS = "IS"
    WS = "WS"
    OS = "OS"


class Outer(str, Enum):
    B = "B"
    C = "C"
    K = "K"


@dataclasses.dataclass(frozen=True)
class Dataflow:
    inner: Inner
    outer: Outer

    @property
    def name(self) -> str:
        return f"{self.inner.value}_{self.outer.value}"


ALL_DATAFLOWS = tuple(Dataflow(i, o) for i in Inner for o in Outer)


@dataclasses.dataclass(frozen=True)
class Traffic:
    """Bit counts moved per memory level for one MM op."""

    dram_r: float = 0.0
    dram_w: float = 0.0
    sram_in_r: float = 0.0     # input operand bank (1-bit for spikes)
    sram_in_w: float = 0.0
    sram_w_r: float = 0.0      # weight bank
    sram_w_w: float = 0.0
    sram_out_r: float = 0.0    # output / psum bank
    sram_out_w: float = 0.0
    reg_r: float = 0.0
    reg_w: float = 0.0

    def __add__(self, o: "Traffic") -> "Traffic":
        return Traffic(*[a + b for a, b in
                         zip(dataclasses.astuple(self),
                             dataclasses.astuple(o))])


def _tiles(mm: MMOp, arr: ArrayConfig) -> tuple[int, int, int]:
    return (math.ceil(mm.B / arr.rows), math.ceil(mm.C / arr.rows),
            math.ceil(mm.K / arr.cols))


def compute_cycles(mm: MMOp, df: Dataflow, arr: ArrayConfig) -> float:
    """eq. 27: (2 D_row + D_col + T - 2) x (stationary tile count)."""
    mm = _sanitized(mm)
    n_b, n_c, n_k = _tiles(mm, arr)
    if arr.fill_overlap == "drain":
        fill = arr.rows + arr.cols - 2
    else:  # "none": eq. 26 verbatim
        fill = 2 * arr.rows + arr.cols - 2
    if df.inner is Inner.OS:
        tiles, stream = n_b * n_k, mm.C
    elif df.inner is Inner.WS:
        tiles, stream = n_c * n_k, mm.B
    else:  # IS
        tiles, stream = n_b * n_c, mm.K
    return (fill + stream) * tiles * mm.count


def utilization(mm: MMOp, df: Dataflow, arr: ArrayConfig) -> float:
    """eq. 28, clamped into (0, 1].

    Shapes smaller than one array tile still pay a full wavefront fill, so
    the raw ratio is already < 1 there; the clamp guards the opposite edge
    (a count/dim clamp in :func:`_sanitized` raising ``macs`` past ``t``)
    and rounding noise.
    """
    mm = _sanitized(mm)
    t = compute_cycles(mm, df, arr)
    return min(1.0, mm.macs / (t * arr.rows * arr.cols))


def _outer_chunks(mm: MMOp, df: Dataflow, arr: ArrayConfig) -> int:
    """Number of outer-loop chunks: the outer dim is split so that the two
    operands having that dim stay resident in their SRAM banks per chunk."""
    def chunk(limit_a: float, limit_b: float, dim: int) -> int:
        c = max(64, int(min(limit_a, limit_b)))
        return max(1, math.ceil(dim / c))

    if df.outer is Outer.B:
        return chunk(arr.sram_in_bytes * 8 / max(1, mm.C * mm.in_bits),
                     arr.sram_out_bytes * 8 / max(1, mm.K * mm.out_bits),
                     mm.B)
    if df.outer is Outer.C:
        return chunk(arr.sram_in_bytes * 8 / max(1, mm.B * mm.in_bits),
                     arr.sram_w_bytes * 8 / max(1, mm.K * mm.w_bits),
                     mm.C)
    return chunk(arr.sram_w_bytes * 8 / max(1, mm.C * mm.w_bits),
                 arr.sram_out_bytes * 8 / max(1, mm.B * mm.out_bits),
                 mm.K)


def mm_traffic(mm: MMOp, df: Dataflow, arr: ArrayConfig) -> Traffic:
    """Three-level traffic for one MM under a dataflow (bits).

    DRAM: compulsory traffic, plus a blocking penalty on the operand that
    does NOT carry the outer dim (it is reused across outer chunks and must
    be re-fetched whenever it overflows its bank). Each inner mode waives
    the penalty of its *matched* outer dim — the dim it streams through the
    array can be chunk-looped inside a tile visit, keeping the stationary
    operand in the PEs (OS_C: psums never spill; WS_B: weights never
    re-fetched; IS_K: inputs never re-fetched).

    SRAM->array: per-tile-visit streaming. The stationary operand of the
    inner mode is read once per visit; the streamed operands are re-read
    once per tile in the orthogonal dim. OS has zero psum SRAM traffic.

    Registers: one read per operand and one write per result per MAC; spike
    operands gate the MAC, so register traffic scales by (1 - sparsity).
    """
    mm = _sanitized(mm)
    n_b, n_c, n_k = _tiles(mm, arr)
    cnt = mm.count
    in_bits = mm.B * mm.C * mm.in_bits * cnt
    w_bits = mm.C * mm.K * mm.w_bits * cnt
    out_bits = mm.B * mm.K * mm.out_bits * cnt

    # ---------------- DRAM <-> SRAM ----------------
    in_fits = mm.B * mm.C * mm.in_bits <= arr.sram_in_bytes * 8
    w_fits = mm.C * mm.K * mm.w_bits <= arr.sram_w_bytes * 8
    out_fits = mm.B * mm.K * mm.out_bits <= arr.sram_out_bytes * 8
    # Fig. 3 fusion: the MM / BN / SOMA / GRAD modules chain on-chip. An
    # operand whose per-instance tensor fits its SRAM bank never leaves the
    # chip between producer and consumer (e.g. the per-slice N x N attention
    # intermediates). WG outputs (weight gradients) always persist to DRAM.
    dram_r = (0.0 if in_fits else in_bits) + w_bits    # weights come from DRAM
    dram_w = out_bits if (mm.stage == "WG" or not out_fits) else 0.0
    n_chunks = _outer_chunks(mm, df, arr)
    if df.outer is Outer.B and not w_fits and df.inner is not Inner.WS:
        dram_r += (n_chunks - 1) * w_bits
    elif df.outer is Outer.K and not in_fits and df.inner is not Inner.IS:
        dram_r += (n_chunks - 1) * in_bits
    elif df.outer is Outer.C and not out_fits and df.inner is not Inner.OS:
        spill = (n_chunks - 1) * out_bits
        dram_r += spill
        dram_w += spill

    # ---------------- SRAM <-> array ----------------
    if df.inner is Inner.OS:
        sram_in_r = in_bits * n_k
        sram_w_r = w_bits * n_b
        sram_out_w = out_bits
        sram_out_r = 0.0
    elif df.inner is Inner.WS:
        sram_w_r = w_bits                   # stationary: one load per tile
        sram_in_r = in_bits * n_k
        sram_out_w = out_bits * n_c         # cross-C-tile psum accumulation
        sram_out_r = out_bits * (n_c - 1)
    else:  # IS
        sram_in_r = in_bits                 # stationary
        sram_w_r = w_bits * n_b
        sram_out_w = out_bits * n_c
        sram_out_r = out_bits * (n_c - 1)
    sram_in_w = in_bits                 # filled from DRAM (refetches excluded:
    sram_w_w = w_bits                   #  they refill the same lines)
    dense = 1.0 - mm.in_sparsity
    reg_r = mm.macs * (mm.in_bits + mm.w_bits) * dense
    reg_w = mm.macs * mm.out_bits * dense
    return Traffic(
        dram_r=dram_r, dram_w=dram_w,
        sram_in_r=sram_in_r, sram_in_w=sram_in_w, sram_w_r=sram_w_r,
        sram_w_w=sram_w_w, sram_out_r=sram_out_r, sram_out_w=sram_out_w,
        reg_r=reg_r, reg_w=reg_w)


def mm_latency_cycles(mm: MMOp, df: Dataflow, arr: ArrayConfig) -> float:
    """Uniform latency model [31]: max of compute and memory stream bounds."""
    comp = compute_cycles(mm, df, arr)
    tr = mm_traffic(mm, df, arr)
    dram_cycles = (tr.dram_r + tr.dram_w) / 8 / arr.dram_bytes_per_cycle
    sram_bits = (tr.sram_in_r + tr.sram_in_w + tr.sram_w_r + tr.sram_w_w +
                 tr.sram_out_r + tr.sram_out_w)
    sram_cycles = sram_bits / 8 / arr.sram_bytes_per_cycle
    return max(comp, dram_cycles, sram_cycles)


def best_dataflow(mms: list[MMOp], arr: ArrayConfig = DEFAULT_ARRAY,
                  metric: str = "latency") -> Dataflow:
    """Pick the dataflow minimizing summed latency (or DRAM traffic)."""
    def score(df: Dataflow) -> float:
        if metric == "latency":
            return sum(mm_latency_cycles(m, df, arr) for m in mms)
        tr = Traffic()
        for m in mms:
            tr = tr + mm_traffic(m, df, arr)
        return tr.dram_r + tr.dram_w
    return min(ALL_DATAFLOWS, key=score)
