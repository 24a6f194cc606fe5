"""Bit-packed spike matmul kernels for Hopper, 2-D and batched.

Replaces ``repro.kernels.spike_matmul.spike_matmul_packed``
(``_spike_mm_kernel``) and ``spike_matmul_packed_batched``
(``_spike_bmm_kernel``). The spike operand crosses device memory packed at
1 bit/element and is expanded inside the kernel, right before the product.

Packing is along the contraction dim C (LSB-first within each byte):
    packed[m, c8] = sum_{b=0..7} spikes[m, 8*c8 + b] << b

Both entry points launch the one kernel of ``csrc/spike_matmul.cu``. The
TPU kernel walked C as a sequential grid axis with an accumulator revisited
across steps; here a block loops over C itself and masks ragged tiles, so no
block size has to divide anything. Every operand is handed over with its
element strides, so a transposed K^T, per-head slices and a weight shared by
all batches (``expand``, stride 0) are read in place.

The products run on the tensor cores (``mma.sync`` bf16 -> fp32) and still
give fp32 results: a spike is exactly 0 or 1 in bf16, and the kernel splits
each fp32 weight into three bf16 planes whose sum is the weight exactly
(:func:`split_bf16x3` is the plain version of that split). Each spike
fragment meets the three planes in three MMAs that add into fp32
accumulators (hi in one, mid and lo in a second, added at the end). The
products are exact, the sums are not rounded as fp32 FMAs round them: an
MMA truncates the sum it adds to. So the result differs from an fp32
product in the order of the sums and in that truncation; where every
partial sum is exact (integer and dyadic weights) it gives the same bits.
Bound on this card: three dense bf16 passes (3 * 2MCK operations) at the
projection sites, the weight's and the output's bytes at ``attn_qk``.

The plain PyTorch versions unpack and call ``torch.matmul``. The wrappers
use them for CPU tensors only.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build

#: The kernel's batch index rides ``blockIdx.z``.
MAX_BATCH = 65535


@dataclasses.dataclass(frozen=True)
class Tile:
    """One tile of ``csrc/spike_mma_mainloop.cuh``: ``bm`` x ``bn`` outputs a
    block, the contraction staged ``bk`` at a time, ``smem`` bytes of
    dynamic shared memory (``Tile::SMEM``)."""

    name: str
    bm: int
    bn: int
    bk: int
    smem: int

    @property
    def blocks(self) -> tuple[int, int, int]:
        """As a tuned table stores it: ``(block_m, block_k, block_c)``, the
        rows, the output columns and the contraction chunk."""
        return (self.bm, self.bn, self.bk)


#: The ``tile`` argument of the entry points -> the tile it forces (0, the
#: default, takes :func:`default_tile`). Both tiles walk the contraction in
#: the same order, so the bits of a product do not depend on the tile.
TILES: dict[int, Tile] = {
    1: Tile("Large", 256, 64, 128, 63488),
    2: Tile("Small", 128, 64, 64, 29696),
}


def default_tile(m: int) -> int:
    """The tile for ``m`` rows per product when the caller names none:
    Small for the per-head matrices (M <= 512), else Large."""
    return 2 if m <= 512 else 1


def spike_pack(spikes: torch.Tensor) -> torch.Tensor:
    """(..., C) {0,1} -> (..., C//8) uint8, LSB-first along C.

    One matrix-vector product with the bit weights (1, 2, ..., 128): every
    byte is a sum of distinct powers of two up to 255, exact in fp32 in any
    order, and the input is read once."""
    *lead, c = spikes.shape
    if c % 8 != 0:
        raise ValueError(f"contraction dim {c} must be a multiple of 8")
    bits = spikes.reshape(*lead, c // 8, 8).to(torch.float32)
    weights = torch.exp2(torch.arange(8, dtype=torch.float32,
                                      device=spikes.device))
    return torch.matmul(bits, weights).to(torch.uint8)


def spike_unpack(packed: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., C//8) uint8 -> (..., C) in ``dtype``."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8).to(dtype)


def spike_matmul_packed_plain(packed: torch.Tensor, w: torch.Tensor, *,
                              out_dtype: torch.dtype | None = None):
    """Plain version of both kernels: unpack, then ``matmul`` (which
    broadcasts over any leading batch dims)."""
    out = torch.matmul(spike_unpack(packed, w.dtype), w)
    return out.to(out_dtype or w.dtype)


def split_bf16x3(w: torch.Tensor):
    """fp32 ``w`` -> bf16 ``(hi, mid, lo)`` with ``hi + mid + lo == w``
    exactly, each rounded to nearest from the fp32 residual of the ones
    before: the plain version of ``split_bf16x3`` in
    ``csrc/spike_tile_mma.cuh``. Exact for 0 and for |w| in
    [2^-110, 2^127]: hi keeps 8 significant bits, the residual at most 16,
    mid 8 of them and lo the last 8."""
    if w.dtype != torch.float32:
        raise TypeError(f"split_bf16x3 takes float32, got {w.dtype}")
    hi = w.to(torch.bfloat16)
    r1 = w - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _check_operands(packed, w, out_dtype, tile, what):
    if tile not in (0, *TILES):
        raise ValueError(f"{what}: tile {tile!r} is none of 0 (the rule, "
                         f"default_tile) and {sorted(TILES)}")
    if packed.dtype != torch.uint8:
        raise TypeError(f"{what}: packed must be uint8, got {packed.dtype}")
    if packed.ndim != w.ndim or packed.shape[:-2] != w.shape[:-2]:
        raise ValueError(f"{what}: batch dims of packed {tuple(packed.shape)} "
                         f"and w {tuple(w.shape)} differ")
    if w.shape[-2] != 8 * packed.shape[-1]:
        raise ValueError(f"{what}: packed C {8 * packed.shape[-1]} != weight "
                         f"C {w.shape[-2]}")
    if packed.device != w.device:
        raise ValueError(f"{what}: packed on {packed.device}, w on {w.device}")
    if packed.is_cuda:
        if w.dtype != torch.float32 or \
                (out_dtype or w.dtype) != torch.float32:
            raise TypeError(f"{what} kernel takes float32 weights and output, "
                            f"got {w.dtype} -> {out_dtype or w.dtype}")


def _launch_spike_matmul(packed4: torch.Tensor, w4: torch.Tensor, stream=0,
                         tile: int = 0):
    """packed4 (G1, G2, M, C/8) uint8, w4 (G1, G2, C, K) fp32, any strides
    -> out (G1, G2, M, K) fp32, contiguous; ``tile`` as in :data:`TILES`,
    0 resolved here to :func:`default_tile` (the kernel takes 1 or 2)."""
    g1, g2, m, _ = packed4.shape
    c, k = w4.shape[-2:]
    if g1 * g2 > MAX_BATCH:
        raise ValueError(f"spike matmul batch {g1 * g2} exceeds {MAX_BATCH}")
    out = torch.empty((g1, g2, m, k), dtype=torch.float32,
                      device=packed4.device)
    code = build.load().e2a_spike_matmul(
        packed4.data_ptr(), w4.data_ptr(), out.data_ptr(), g1, g2, m, c, k,
        *packed4.stride(), *w4.stride(), *out.stride(),
        tile or default_tile(m), stream)
    build.check_launch(code, "spike_matmul")
    return out


def _launch_on_current_stream(packed4, w4, tile):
    with torch.cuda.device(packed4.device):
        return _launch_spike_matmul(
            packed4, w4, torch.cuda.current_stream().cuda_stream, tile)


def spike_matmul_packed(packed: torch.Tensor, w: torch.Tensor, *,
                        out_dtype: torch.dtype | None = None,
                        tile: int = 0) -> torch.Tensor:
    """packed: (M, C//8) uint8; w: (C, K) -> (M, K) in ``out_dtype`` (default
    ``w.dtype``). Either operand may be strided; nothing is copied.
    ``tile`` forces a tile of :data:`TILES` (0: :func:`default_tile`);
    the plain version has none."""
    if packed.ndim != 2:
        raise ValueError(f"spike_matmul_packed expects 2-D operands, got "
                         f"{tuple(packed.shape)}")
    _check_operands(packed, w, out_dtype, tile, "spike_matmul_packed")
    if not packed.is_cuda:
        return spike_matmul_packed_plain(packed, w, out_dtype=out_dtype)
    out = _launch_on_current_stream(packed[None, None], w[None, None], tile)
    spike_matmul_packed.launches += 1
    return out[0, 0]


def spike_matmul_packed_batched(packed: torch.Tensor, w: torch.Tensor, *,
                                out_dtype: torch.dtype | None = None,
                                tile: int = 0) -> torch.Tensor:
    """packed: (G, M, C//8) uint8; w: (G, C, K) -> (G, M, K).

    Also takes two batch dims, (G1, G2, M, C//8) x (G1, G2, C, K) ->
    (G1, G2, M, K): the attention heads of a (T*B, N, h*dh) tensor form a
    second batch level that no single stride can express. Operands may be
    strided or expanded (a zero batch stride shares one weight among all
    batches); the kernel reads them in place. ``tile`` as in
    :func:`spike_matmul_packed`.
    """
    if packed.ndim not in (3, 4):
        raise ValueError(f"spike_matmul_packed_batched expects one or two "
                         f"batch dims, got {tuple(packed.shape)}")
    _check_operands(packed, w, out_dtype, tile,
                    "spike_matmul_packed_batched")
    if not packed.is_cuda:
        return spike_matmul_packed_plain(packed, w, out_dtype=out_dtype)
    if packed.ndim == 3:
        out = _launch_on_current_stream(packed[:, None], w[:, None],
                                        tile)[:, 0]
    else:
        out = _launch_on_current_stream(packed, w, tile)
    spike_matmul_packed_batched.launches += 1
    return out


def spike_matmul(spikes: torch.Tensor, w: torch.Tensor, **kw) -> torch.Tensor:
    """Convenience: unpacked {0,1} spikes (M, C) x (C, K)."""
    return spike_matmul_packed(spike_pack(spikes), w, **kw)


def spike_matmul_batched(spikes: torch.Tensor, w: torch.Tensor,
                         **kw) -> torch.Tensor:
    """Convenience: unpacked {0,1} spikes (G, M, C) x (G, C, K)."""
    return spike_matmul_packed_batched(spike_pack(spikes), w, **kw)


#: Kernel launches since the counts were last set to 0.
spike_matmul_packed.launches = 0
spike_matmul_packed_batched.launches = 0


# ---------------------------------------------------------------------------
# Kernel-contract declarations (repro_torch.analysis.contracts): the
# builders hand the convenience entry points unpacked {0,1} spikes.
# ---------------------------------------------------------------------------

from repro_torch.kernels import ref as _ref  # noqa: E402
from repro_torch.kernels.contract import (KernelContract,  # noqa: E402
                                          SkipCase, declare_contract, meta)


def _build_spike_matmul(case):
    if case.c % 8 != 0:
        raise SkipCase(f"contraction {case.c} % 8 != 0 -> dense fallback")
    args = (meta(case.t * case.m, case.c, dtype=case.torch_dtype),
            meta(case.c, case.k, dtype=case.torch_dtype))
    return args, {}, {}


def _build_spike_matmul_batched(case):
    if case.c % 8 != 0:
        raise SkipCase(f"contraction {case.c} % 8 != 0 -> eager einsum")
    args = (meta(case.t, case.m, case.c, dtype=case.torch_dtype),
            meta(case.t, case.c, case.k, dtype=case.torch_dtype))
    return args, {}, {}


declare_contract(KernelContract(
    name="spike_matmul", kernel="spike_matmul_packed", fn=spike_matmul,
    build=_build_spike_matmul, ref=_ref.spike_matmul_ref,
    serves=(("linear_bn", "cuda+spike_mm"),)))

declare_contract(KernelContract(
    name="spike_matmul_batched", kernel="spike_matmul_packed_batched",
    fn=spike_matmul_batched, build=_build_spike_matmul_batched,
    ref=_ref.spike_matmul_batched_ref,
    serves=(("attn_qk", "cuda_packed"), ("attn_av", "cuda_packed"))))
