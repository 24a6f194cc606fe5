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

A bf16 weight (the reference's kernels at bf16: spikes unpacked to the
weight's dtype, the dot accumulated in fp32, the output in ``w.dtype``)
takes one tensor-core pass: the exact products are added into fp32
accumulators and the result is rounded to bf16 once, at the store. The
output's dtype is the weight's. Three kernels do it. :data:`WGMMA` is
``csrc/spike_wgmma.cuh``, designed for Hopper: a producer warp keeps a
ring of the weight's and the packed rows' chunks full by TMA, three
consumer warpgroups expand the spikes into wgmma's register A fragments
and read the weight from shared memory (the mainloop of
``csrc/wgmma_mainloop.cuh``, which the train-mode neuron layer's bf16 z
pass runs too). :func:`resolve_tile`
names it for more than :data:`WGMMA_MIN_ROWS` rows and a weight TMA can
read (:func:`tma_suits`). :data:`HEADS` is ``csrc/spike_heads.cuh``,
designed for the bytes of small per-batch products (``attn_qk``'s
per-head Q K^T, bound by its 39 MB of output): a unit is whole output rows
of one batch, persistent blocks walk the units with the next unit's weight
on its way by TMA, and each unit's rows leave shared memory by one bulk
copy; :func:`resolve_tile` names it at :data:`WGMMA_MIN_ROWS` rows or
fewer for such a weight within its limits (:func:`heads_suits`). Every
other bf16 call runs the tiles of :data:`TILES` with the weight as its
single plane.

The plain PyTorch versions unpack and call ``torch.matmul`` in fp32 (a
bf16 weight widened exactly), rounding the product to ``w.dtype`` once, as
the kernels do. The wrappers
use them for CPU tensors only; on ``meta`` tensors they allocate the
kernel's output (:func:`on_meta`) for the dry run to count.

:func:`spike_pack`, the pack every packed arm of the port runs before its
kernel (the spike matmuls here, the neuron layers' packed arms, the
tokenizer's im2col patches), is an entry point of this row too: one launch
of ``csrc/spike_pack.cu``, which reads the spikes in place in their own
dtype and writes one byte for every eight. It replaces no ``pallas_call``:
the reference packs with a ``jnp`` sum inside the functions that reach
one. Its plain version, :func:`spike_pack_plain`, is the fp32
matrix-vector product the port packed with before.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import build, dtype_code, meta_site

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


#: The ``tile`` code of the bf16 kernel of ``csrc/spike_wgmma.cuh``
#: (``e2a::wg::Wide``: 192 x 128 outputs a tile, the contraction staged
#: 128 at a time in a ring of 4, one persistent block an SM). Kept out of
#: :data:`TILES`, the fp32 tuner's candidates; a caller may force it at
#: bf16 only.
WGMMA = 3
WGMMA_TILE = Tile("Wgmma", 192, 128, 128, 193600)
#: The rule names :data:`WGMMA` above this many rows a product.
WGMMA_MIN_ROWS = 512

#: The ``tile`` code of the bf16 kernel of ``csrc/spike_heads.cuh``
#: (``e2a::hd``: whole output rows of one batch a unit, one persistent
#: block an SM, the unit's rows stored by one bulk copy), designed for the
#: per-head products of ``attn_qk``. Kept out of :data:`TILES`, as
#: :data:`WGMMA` is; a caller may force it at bf16 within its limits.
HEADS = 4
#: Its limits, the contraction C and the output columns K of a product:
#: ``kMaxC`` and ``kMaxK`` of ``csrc/spike_heads.cuh``, which refuses a
#: forced :data:`HEADS` past them.
HEADS_MAX_C = 128
HEADS_MAX_K = 256


def tma_suits(w4: torch.Tensor) -> bool:
    """Whether the bf16 kernel can read the weight ``w4`` (G1, G2, C, K)
    where it lies: a 16-byte aligned base, unit stride along K (then C's
    stride a multiple of 16 bytes) or along C (a K^T view; then K's), each
    batch level of more than one batch at stride 0 (one weight shared) or
    a multiple of 16 bytes, and C > 0. The twin of ``e2a::wg::tma_suits``
    (``csrc/spike_wgmma.cuh``), which refuses a forced :data:`WGMMA`
    without it."""
    g1, g2, c, k = w4.shape
    s1, s2, sc, sk = w4.stride()
    size = w4.element_size()
    if c <= 0 or k <= 0 or (not w4.is_meta and w4.data_ptr() % 16):
        return False
    if not ((sk == 1 and sc > 0 and sc * size % 16 == 0) or
            (sc == 1 and sk > 0 and sk * size % 16 == 0)):
        return False
    return (g1 <= 1 or (s1 >= 0 and s1 * size % 16 == 0)) and \
        (g2 <= 1 or (s2 >= 0 and s2 * size % 16 == 0))


def heads_suits(w4: torch.Tensor) -> bool:
    """Whether the heads kernel (:data:`HEADS`) takes the weight ``w4``
    (G1, G2, C, K): TMA reads it (:func:`tma_suits`), C <=
    :data:`HEADS_MAX_C` and K <= :data:`HEADS_MAX_K`. The twin of
    ``e2a::hd::suits`` (``csrc/spike_heads.cuh``; the output the wrappers
    allocate always has the contiguous rows it also asks for)."""
    _, _, c, k = w4.shape
    return c <= HEADS_MAX_C and k <= HEADS_MAX_K and tma_suits(w4)


def resolve_tile(m: int, w4: torch.Tensor, tile: int = 0) -> int:
    """The kernel a call of ``m`` rows a product and weight ``w4`` (G1, G2,
    C, K) runs: ``tile`` where the caller forces one; else, for a bf16
    weight that :func:`tma_suits`, :data:`WGMMA` at more than
    :data:`WGMMA_MIN_ROWS` rows and :data:`HEADS` at fewer where
    :func:`heads_suits`; else :func:`default_tile`."""
    if tile:
        return tile
    if w4.dtype == torch.bfloat16:
        if m > WGMMA_MIN_ROWS:
            if tma_suits(w4):
                return WGMMA
        elif heads_suits(w4):
            return HEADS
    return default_tile(m)


def _as4(w: torch.Tensor) -> torch.Tensor:
    """A weight of two, three or four dims as the kernel's (G1, G2, C, K)."""
    return w[None, None] if w.ndim == 2 else w[:, None] if w.ndim == 3 \
        else w


def spike_pack_plain(spikes: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`spike_pack`: one matrix-vector product with
    the bit weights (1, 2, ..., 128) in fp32. Every byte is a sum of
    distinct powers of two up to 255, exact in fp32 in any order."""
    *lead, c = spikes.shape
    if c % 8 != 0:
        raise ValueError(f"contraction dim {c} must be a multiple of 8")
    bits = spikes.reshape(*lead, c // 8, 8).to(torch.float32)
    weights = torch.exp2(torch.arange(8, dtype=torch.float32,
                                      device=spikes.device))
    return torch.matmul(bits, weights).to(torch.uint8)


#: The path codes of ``e2a_spike_pack`` (``csrc/spike_pack.cu``): 16-byte
#: vector loads, or one load an element at any strides and alignment.
PACK_VECTOR, PACK_SCALAR = 1, 2


def pack_layout(spikes: torch.Tensor):
    """The kernel's view of ``spikes`` (..., C): ``(dims, strides, c,
    c_stride)`` with the leading dims merged where their strides allow and
    dims of 1 dropped, as three sizes and element strides, the innermost
    last, padded in front with dims of 1. Raises ``ValueError`` where more
    than three leading dims remain (the kernel takes four)."""
    *lead, c = spikes.shape
    *lead_strides, sc = spikes.stride()
    merged: list[list[int]] = []
    for n, s in zip(lead, lead_strides):
        if n == 1:
            continue
        if merged and merged[-1][1] == n * s:
            merged[-1] = [merged[-1][0] * n, s]
        else:
            merged.append([n, s])
    if len(merged) > 3:
        raise ValueError(f"spike_pack kernel takes up to 4 dims; "
                         f"{tuple(spikes.shape)} with strides "
                         f"{spikes.stride()} keeps {len(merged) + 1}")
    merged = [[1, 0]] * (3 - len(merged)) + merged
    return (tuple(n for n, _ in merged), tuple(s for _, s in merged), c, sc)


def pack_path(spikes: torch.Tensor, layout=None) -> int:
    """The path ``e2a_spike_pack`` takes for ``spikes`` (``layout``: its
    :func:`pack_layout`, where already made): :data:`PACK_VECTOR` where C
    has unit stride and the base and every row start are 16-byte aligned,
    else :data:`PACK_SCALAR`. The rule lives here alone; the C entry
    refuses the vector path on a layout it cannot read."""
    dims, strides, _, sc = layout or pack_layout(spikes)
    size = spikes.element_size()
    aligned = spikes.data_ptr() % 16 == 0 and all(
        n <= 1 or s * size % 16 == 0 for n, s in zip(dims, strides))
    return PACK_VECTOR if sc == 1 and aligned else PACK_SCALAR


def spike_pack(spikes: torch.Tensor) -> torch.Tensor:
    """(..., C) {0,1} -> (..., C//8) uint8, LSB-first along C.

    On a CUDA tensor, one launch of ``e2a_spike_pack``
    (``csrc/spike_pack.cu``), which reads ``spikes`` in place in its own
    dtype, fp32 or bf16 (any other raises ``TypeError``), at the strides
    :func:`pack_layout` gives, on the path :func:`pack_path` names, and
    writes the contiguous result. On the CPU the plain version
    (:func:`spike_pack_plain`); on ``meta`` the result allocated and the
    site reported (:func:`pack_on_meta`). A bit is set where an element is
    nonzero."""
    c = spikes.shape[-1]
    if c % 8 != 0:
        raise ValueError(f"contraction dim {c} must be a multiple of 8")
    if spikes.is_meta:
        return pack_on_meta(spikes)
    if not spikes.is_cuda:
        return spike_pack_plain(spikes)
    code = dtype_code(spikes.dtype, "spike_pack")
    out = torch.empty((*spikes.shape[:-1], c // 8), dtype=torch.uint8,
                      device=spikes.device)
    if out.numel() == 0:
        return out
    layout = pack_layout(spikes)
    dims, strides, _, sc = layout
    with torch.cuda.device(spikes.device):
        err = build.load().e2a_spike_pack(
            spikes.data_ptr(), out.data_ptr(), *dims, c, *strides, sc,
            pack_path(spikes, layout), code,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "spike_pack")
    spike_pack.launches += 1
    return out


def spike_unpack(packed: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., C//8) uint8 -> (..., C) in ``dtype``."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8).to(dtype)


def spike_matmul_packed_plain(packed: torch.Tensor, w: torch.Tensor, *,
                              out_dtype: torch.dtype | None = None):
    """Plain version of both kernels: unpack, then ``matmul`` (which
    broadcasts over any leading batch dims) in fp32, the product rounded
    to ``out_dtype`` (default ``w.dtype``) once."""
    out = torch.matmul(spike_unpack(packed, torch.float32), w.float())
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
    if tile not in (0, *TILES, WGMMA, HEADS):
        raise ValueError(f"{what}: tile {tile!r} is none of 0 (the rule, "
                         f"resolve_tile), {sorted(TILES)}, {WGMMA} and "
                         f"{HEADS}")
    if tile in (WGMMA, HEADS):
        kernel = "the wgmma kernel" if tile == WGMMA else "the heads kernel"
        if w.dtype != torch.bfloat16:
            raise ValueError(f"{what}: tile {tile} ({kernel}) takes a "
                             f"bfloat16 weight, got {w.dtype}")
        if not tma_suits(_as4(w)):
            raise ValueError(
                f"{what}: tile {tile} cannot read the weight {tuple(w.shape)}"
                f" with strides {w.stride()} by TMA (tma_suits)")
        if tile == HEADS and not heads_suits(_as4(w)):
            raise ValueError(
                f"{what}: tile {HEADS} takes C <= {HEADS_MAX_C} and K <= "
                f"{HEADS_MAX_K}, got the weight {tuple(w.shape)}")
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
        dtype_code(w.dtype, what)
        if (out_dtype or w.dtype) != w.dtype:
            raise TypeError(f"{what} kernel writes its output in the weight's "
                            f"dtype, got {w.dtype} -> {out_dtype}")


def _launch_spike_matmul(packed4: torch.Tensor, w4: torch.Tensor, stream=0,
                         tile: int = 0):
    """packed4 (G1, G2, M, C/8) uint8, w4 (G1, G2, C, K) fp32 or bf16, any
    strides -> out (G1, G2, M, K) in w4's dtype, contiguous; ``tile`` as in
    :data:`TILES`, :data:`WGMMA` or :data:`HEADS`, 0 resolved here by
    :func:`resolve_tile` (the kernel takes 1, 2, 3 or 4)."""
    g1, g2, m, _ = packed4.shape
    c, k = w4.shape[-2:]
    if g1 * g2 > MAX_BATCH:
        raise ValueError(f"spike matmul batch {g1 * g2} exceeds {MAX_BATCH}")
    out = torch.empty((g1, g2, m, k), dtype=w4.dtype, device=packed4.device)
    code = build.load().e2a_spike_matmul(
        packed4.data_ptr(), w4.data_ptr(), out.data_ptr(), g1, g2, m, c, k,
        *packed4.stride(), *w4.stride(), *out.stride(),
        resolve_tile(m, w4, tile), dtype_code(w4.dtype, "spike_matmul"),
        stream)
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
    ``tile`` forces a tile of :data:`TILES` or, at bf16, :data:`WGMMA` or
    :data:`HEADS` (0: :func:`resolve_tile`); the plain version has none."""
    if packed.ndim != 2:
        raise ValueError(f"spike_matmul_packed expects 2-D operands, got "
                         f"{tuple(packed.shape)}")
    _check_operands(packed, w, out_dtype, tile, "spike_matmul_packed")
    if packed.is_meta:
        return on_meta("spike_matmul_packed", packed, w, out_dtype)
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
    if packed.is_meta:
        return on_meta("spike_matmul_packed_batched", packed, w, out_dtype)
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
spike_pack.launches = 0


# ---------------------------------------------------------------------------
# Kernel-contract declarations (repro_torch.analysis.contracts): the
# builders hand the convenience entry points unpacked {0,1} spikes.
# ---------------------------------------------------------------------------

from repro_torch.kernels import ref as _ref  # noqa: E402
from repro_torch.kernels.contract import (KernelContract,  # noqa: E402
                                          SkipCase, declare_contract, meta)


def on_meta(name, packed, w, out_dtype=None):
    """Either entry point's shape rule on ``meta``: (..., M, K) over the
    batch dims of ``packed`` (M, C/8) and ``w`` (C, K), contiguous, in
    ``out_dtype`` (default ``w.dtype``, the kernel's); a batch past
    ``MAX_BATCH`` raises as on the card. The product's 2 * M * C * K
    operations a batch are reported to the dry run."""
    lead = packed.shape[:-2]
    batch = math.prod(lead)
    if batch > MAX_BATCH:
        raise ValueError(f"spike matmul batch {batch} exceeds {MAX_BATCH}")
    m, c, k = packed.shape[-2], w.shape[-2], w.shape[-1]
    out = torch.empty((*lead, m, k), dtype=out_dtype or w.dtype,
                      device=packed.device)
    return meta_site(name, (packed, w), out, 2.0 * batch * m * c * k)


def pack_on_meta(spikes):
    """:func:`spike_pack`'s shape rule on ``meta``: the (..., C/8) uint8
    result, contiguous, the dtype refused as on the card; the site reported
    with no flops (the pack forms no product)."""
    dtype_code(spikes.dtype, "spike_pack")
    out = torch.empty((*spikes.shape[:-1], spikes.shape[-1] // 8),
                      dtype=torch.uint8, device=spikes.device)
    return meta_site("spike_pack", (spikes,), out, 0.0)


def _build_spike_pack(case):
    if case.c % 8 != 0:
        raise SkipCase(f"contraction {case.c} % 8 != 0 -> nothing packed")
    return (meta(case.t * case.m, case.c, dtype=case.torch_dtype),), {}, {}


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
    name="spike_pack", kernel="spike_matmul_packed", fn=spike_pack,
    build=_build_spike_pack, ref=_ref.spike_pack_ref,
    serves=(("linear_bn", "cuda+spike_mm"),)))

declare_contract(KernelContract(
    name="spike_matmul_batched", kernel="spike_matmul_packed_batched",
    fn=spike_matmul_batched, build=_build_spike_matmul_batched,
    ref=_ref.spike_matmul_batched_ref,
    serves=(("attn_qk", "cuda_packed"), ("attn_av", "cuda_packed"))))
