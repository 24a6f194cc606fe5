"""Training batch-norm kernels (E2ATST Fig. 5-6, eq. 13-23) for Hopper.

``bn_fwd`` replaces ``repro.kernels.fused_bn.bn_fwd`` (``_bn_fwd_kernel``):
batch statistics by the paper's E[x^2] - mu^2 formulation, then normalise.
``bn_bwd`` replaces ``repro.kernels.fused_bn.bn_bwd`` (``_bn_bwd_kernel``):
the eq. 19-23 backward, with ``dgamma = s_mn / gamma`` as the reference has
it (inf or nan where gamma is 0).

The TPU kernels had one program own all M rows of a feature block, so the
statistics and the normalisation shared one visit to VMEM. On this card a
column reduction over 12,544 rows cannot live in one block, and D = 512
columns would give too few blocks for 132 SMs, so each kernel is a split
reduction (``csrc/fused_bn.cu``): per-chunk fp32 partial sums into a scratch
buffer the wrapper allocates, the chunks of each column added in a fixed
order (no atomics carry a sum: the statistics are the same on every run),
and an elementwise pass that reads its inputs again, from L2 at the
model's sizes. Each is two launches: the last block of each column group to
write its partials (elected by an arrival counter the wrapper keeps zeroed,
one set per device and stream, which both kernels share) adds the group's
chunks; then the elementwise pass loads float4 along D where ``D % 4 ==
0``. The backward's elected block also forms eq. 23's per-column terms, so
its dx pass does two divisions an element and nothing per column.

Bound on this card: bytes. The forward must read x and write y, the
backward read g and x and write dx.

The plain PyTorch versions, :func:`bn_fwd_plain` and :func:`bn_bwd_plain`,
compute the same formulas with library reductions. The wrappers use them
for a CPU tensor and never for a CUDA tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: The first pass sums chunks of at least MIN_CHUNK_ROWS rows, and makes at
#: most MAX_CHUNKS of them, so that the pass adding the chunks stays short.
#: The backward's chunks are longer, BWD_MIN_CHUNK_ROWS: its lanes keep two
#: batches of four rows' loads in flight, which pays on long chunks, and
#: fewer chunks leave its elected blocks less to add.
MIN_CHUNK_ROWS, MAX_CHUNKS = 128, 256
BWD_MIN_CHUNK_ROWS = 512


def _chunking(m: int, min_rows: int = MIN_CHUNK_ROWS) -> tuple[int, int]:
    """(rows per chunk, number of chunks) for M rows."""
    rows = max(min_rows, -(-m // MAX_CHUNKS))
    return rows, -(-m // rows)


#: Columns one arrival counter of either first pass serves: a block of
#: those passes covers 32 columns (``BN_COLS`` in ``csrc/fused_bn.cu``).
COUNTER_COLS = 32

_arrival: dict[tuple, torch.Tensor] = {}


def _arrival_counters(device: torch.device, stream: int,
                      d: int) -> torch.Tensor:
    """The arrival counters of ``bn_fwd`` and ``bn_bwd`` on ``device`` for
    launches on ``stream``, at least ``ceil(d / COUNTER_COLS)`` of them:
    zero when made, and each kernel leaves them zero, so every call and a
    captured CUDA graph find them so. One set per stream, so that two
    streams never count into one; the launches of one stream run in order,
    so the two kernels can share it."""
    n = -(-d // COUNTER_COLS)
    key = (device, stream)
    buf = _arrival.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _arrival[key] = buf
    return buf


def row_count(x: torch.Tensor) -> torch.Tensor:
    """M as a 0-d fp32 tensor on ``x``'s device. A CUDA division by a host
    scalar multiplies by its rounded reciprocal, which is not the correctly
    rounded quotient of eq. 13-14 and 23 (nor what the kernels form); a
    tensor divisor is divided by."""
    return torch.tensor(float(x.shape[0]), device=x.device)


def bn_fwd_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                 eps: float = 1e-5):
    """x (M, D) -> (y (M, D), mu (1, D), sqrt_d (1, D)), eq. 13-18; the
    statistics in fp32."""
    xf = x.float()
    m = row_count(xf)
    mu = xf.sum(0, keepdim=True) / m                                 # eq. 13
    ex2 = (xf * xf).sum(0, keepdim=True) / m                         # eq. 14
    var = torch.clamp(ex2 - mu * mu, min=0.0)                        # eq. 15
    sqrt_d = torch.sqrt(var + eps)                                   # eq. 16
    y = gamma.float().reshape(1, -1) * (xf - mu) / sqrt_d \
        + beta.float().reshape(1, -1)                                # eq. 17-18
    return y.to(x.dtype), mu, sqrt_d


def bn_bwd_plain(g: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
                 mu: torch.Tensor, sqrt_d: torch.Tensor):
    """eq. 19-23 verbatim: returns (dx (M, D), dgamma (1, D), dbeta
    (1, D))."""
    gf, xf = g.float(), x.float()
    m = row_count(gf)
    gm = gamma.float().reshape(1, -1)
    mi = gm * gf / sqrt_d                                            # eq. 19
    n = xf - mu
    s_n = n.sum(0, keepdim=True)                                     # eq. 20
    s_m = mi.sum(0, keepdim=True)
    s_mn = (mi * n).sum(0, keepdim=True)
    dgamma = s_mn / gm                                               # eq. 21
    dbeta = gf.sum(0, keepdim=True)                                  # eq. 22
    sq2 = sqrt_d * sqrt_d
    dx = mi - n * s_mn / (m * sq2) + s_n * s_mn / (sq2 * m * m) - s_m / m
    return dx.to(g.dtype), dgamma, dbeta                             # eq. 23


def _check(what: str, tensors: dict) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{what} kernel takes float32, got {name} "
                            f"{t.dtype}")
        if not t.is_contiguous() or t.device != tensors["x"].device:
            raise ValueError(f"{what} kernel takes contiguous operands on one "
                             f"device ({name})")


def bn_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
           eps: float = 1e-5):
    """x: (M, D) -> (y (M, D), mu (1, D), sqrt_d (1, D)). A CUDA tensor
    launches the kernel's two passes (fp32, contiguous; anything else
    raises) and counts once; a CPU tensor takes the plain version."""
    if x.ndim != 2 or gamma.shape != (x.shape[1],) \
            or beta.shape != gamma.shape:
        raise ValueError(f"bn_fwd expects x (M, D), gamma and beta (D,), got "
                         f"{tuple(x.shape)}, {tuple(gamma.shape)}, "
                         f"{tuple(beta.shape)}")
    if not x.is_cuda:
        return bn_fwd_plain(x, gamma, beta, eps=eps)
    m, d = x.shape
    _check("bn_fwd", {"x": x, "gamma": gamma, "beta": beta})
    y = torch.empty_like(x)
    mu = torch.empty((1, d), dtype=torch.float32, device=x.device)
    sqrt_d = torch.empty_like(mu)
    rows, chunks = _chunking(m)
    part = torch.empty((2, chunks, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        arrived = _arrival_counters(x.device, stream, d)
        code = build.load().e2a_bn_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mu.data_ptr(), sqrt_d.data_ptr(), part.data_ptr(),
            arrived.data_ptr(), m, d, rows, eps, stream)
    build.check_launch(code, "bn_fwd")
    bn_fwd.launches += 1
    return y, mu, sqrt_d


def bn_bwd(g: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
           mu: torch.Tensor, sqrt_d: torch.Tensor):
    """eq. 19-23: g, x (M, D), gamma (D,), mu and sqrt_d (1, D) -> (dx
    (M, D), dgamma (1, D), dbeta (1, D)). A CUDA tensor launches the
    kernel's two passes (fp32, contiguous; anything else raises) and counts
    once; a CPU tensor takes the plain version."""
    if g.ndim != 2 or x.shape != g.shape or gamma.shape != (g.shape[1],) \
            or mu.numel() != g.shape[1] or sqrt_d.numel() != g.shape[1]:
        raise ValueError(f"bn_bwd expects g and x (M, D), gamma (D,), mu and "
                         f"sqrt_d (1, D), got {tuple(g.shape)}, "
                         f"{tuple(x.shape)}, {tuple(gamma.shape)}, "
                         f"{tuple(mu.shape)}, {tuple(sqrt_d.shape)}")
    if not g.is_cuda:
        return bn_bwd_plain(g, x, gamma, mu, sqrt_d)
    m, d = g.shape
    _check("bn_bwd", {"x": x, "g": g, "gamma": gamma, "mu": mu,
                      "sqrt_d": sqrt_d})
    dx = torch.empty_like(g)
    rows, chunks = _chunking(m, BWD_MIN_CHUNK_ROWS)
    # one allocation for the partials, dgamma, dbeta and eq. 23's terms
    buf = torch.empty((4 * chunks + 6, d), dtype=torch.float32,
                      device=g.device)
    part, dgamma, dbeta, cols = buf.split([4 * chunks, 1, 1, 4])
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        arrived = _arrival_counters(g.device, stream, d)
        code = build.load().e2a_bn_bwd(
            g.data_ptr(), x.data_ptr(), gamma.data_ptr(), mu.data_ptr(),
            sqrt_d.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
            dbeta.data_ptr(), part.data_ptr(), cols.data_ptr(),
            arrived.data_ptr(), m, d, rows, stream)
    build.check_launch(code, "bn_bwd")
    bn_bwd.launches += 1
    return dx, dgamma, dbeta


#: Kernel launches since the counts were last set to 0.
bn_fwd.launches = 0
bn_bwd.launches = 0
