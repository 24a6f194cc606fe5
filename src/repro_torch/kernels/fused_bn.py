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

Data parallelism (``group``, the process group over the batch axes): the
statistics are those of the global batch. Each kernel's first launch then
writes the rank's column sums in double (forward: sum(x), sum(x^2);
backward: the s_n, s_m, s_mn of eq. 20-21) and its row count to a buffer
instead of finishing them; the wrapper all-reduces the buffer over the
group; a second launch forms the statistics (eq. 13-16), or eq. 23's
column terms, from the global sums and count with the fused path's
arithmetic, and runs the elementwise pass. At a world of 1 the outputs are
the fused path's bit for bit. ``dgamma`` and ``dbeta`` come from the rank's
own rows: the train step sums them over the ranks with every other
gradient. Without a group the kernels run as they always have.

The plain PyTorch versions, :func:`bn_fwd_plain` and :func:`bn_bwd_plain`,
compute the same formulas with library reductions, and with a group sum
the same way (the local sums in double, all-reduced with the row count).
The wrappers use them for a CPU tensor and never for a CUDA tensor; a
failed collective raises.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

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


def global_sums(local: list[torch.Tensor], rows: int, group
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The column sums ``local`` (each (D,)) and the row count, added over
    ``group`` in double: ``(sums (len(local), D) float64, count 0-d
    float64)``. Dividing such a sum of fp32 values by the count in double
    and rounding once to fp32 gives the fp32 quotient bit for bit (53 >=
    2 * 24 + 2), so at a world of 1 the statistics are the local ones."""
    buf = torch.cat([torch.stack(local).double().reshape(-1),
                     torch.full((1,), float(rows), dtype=torch.float64,
                                device=local[0].device)])
    dist.all_reduce(buf, group=group)
    return buf[:-1].reshape(len(local), -1), buf[-1]


def bn_fwd_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                 eps: float = 1e-5, group=None):
    """x (M, D) -> (y (M, D), mu (1, D), sqrt_d (1, D)), eq. 13-18; the
    statistics in fp32, over the rows of every rank of ``group`` where
    one is given."""
    xf = x.float()
    if group is None:
        m = row_count(xf)
        mu = xf.sum(0, keepdim=True) / m                             # eq. 13
        ex2 = (xf * xf).sum(0, keepdim=True) / m                     # eq. 14
    else:
        sums, count = global_sums([xf.sum(0), (xf * xf).sum(0)],
                                  xf.shape[0], group)
        mu, ex2 = ((sums[i:i + 1] / count).float() for i in range(2))
    var = torch.clamp(ex2 - mu * mu, min=0.0)                        # eq. 15
    sqrt_d = torch.sqrt(var + eps)                                   # eq. 16
    y = gamma.float().reshape(1, -1) * (xf - mu) / sqrt_d \
        + beta.float().reshape(1, -1)                                # eq. 17-18
    return y.to(x.dtype), mu, sqrt_d


def bn_bwd_plain(g: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
                 mu: torch.Tensor, sqrt_d: torch.Tensor, group=None):
    """eq. 19-23 verbatim: returns (dx (M, D), dgamma (1, D), dbeta
    (1, D)). With ``group``, eq. 23 takes the sums and row count of every
    rank's rows; dgamma and dbeta stay the rank's own."""
    gf, xf = g.float(), x.float()
    gm = gamma.float().reshape(1, -1)
    mi = gm * gf / sqrt_d                                            # eq. 19
    n = xf - mu
    s_n = n.sum(0, keepdim=True)                                     # eq. 20
    s_m = mi.sum(0, keepdim=True)
    s_mn = (mi * n).sum(0, keepdim=True)
    dgamma = s_mn / gm                                               # eq. 21
    dbeta = gf.sum(0, keepdim=True)                                  # eq. 22
    if group is None:
        m = row_count(gf)
    else:
        sums, count = global_sums([s_n[0], s_m[0], s_mn[0]], gf.shape[0],
                                  group)
        s_n, s_m, s_mn = (sums[i:i + 1].float() for i in range(3))
        m = count.float()
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
           eps: float = 1e-5, group=None):
    """x: (M, D) -> (y (M, D), mu (1, D), sqrt_d (1, D)). A CUDA tensor
    launches the kernel's two passes (fp32, contiguous; anything else
    raises) and counts once; a CPU tensor takes the plain version.
    ``group``: the statistics of the rows of every rank in it (the split
    path: :func:`bn_fwd_sums`, an all-reduce, :func:`bn_fwd_apply`)."""
    if x.ndim != 2 or gamma.shape != (x.shape[1],) \
            or beta.shape != gamma.shape:
        raise ValueError(f"bn_fwd expects x (M, D), gamma and beta (D,), got "
                         f"{tuple(x.shape)}, {tuple(gamma.shape)}, "
                         f"{tuple(beta.shape)}")
    if not x.is_cuda:
        return bn_fwd_plain(x, gamma, beta, eps=eps, group=group)
    _check("bn_fwd", {"x": x, "gamma": gamma, "beta": beta})
    if group is not None:
        sums = bn_fwd_sums(x)
        dist.all_reduce(sums, group=group)
        out = bn_fwd_apply(x, gamma, beta, sums, eps=eps)
        bn_fwd.launches += 1
        return out
    m, d = x.shape
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


def bn_fwd_sums(x: torch.Tensor) -> torch.Tensor:
    """The split path's first launch (a CUDA x, checked by the caller): the
    (2 * D + 1,) float64 buffer of this rank's sum(x) and sum(x^2) per
    column and its row count, the fused path's doubles."""
    m, d = x.shape
    rows, chunks = _chunking(m)
    part = torch.empty((2, chunks, d), dtype=torch.float32, device=x.device)
    sums = torch.empty(2 * d + 1, dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = build.load().e2a_bn_fwd_sums(
            x.data_ptr(), part.data_ptr(),
            _arrival_counters(x.device, stream, d).data_ptr(),
            sums.data_ptr(), m, d, rows, stream)
    build.check_launch(code, "bn_fwd")
    return sums


def bn_fwd_apply(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 sums: torch.Tensor, *, eps: float = 1e-5):
    """The split path's second launch: mu and sqrt_d from ``sums`` (every
    rank's, added), then y. Returns ``(y, mu (1, D), sqrt_d (1, D))``."""
    m, d = x.shape
    y = torch.empty_like(x)
    mu = torch.empty((1, d), dtype=torch.float32, device=x.device)
    sqrt_d = torch.empty_like(mu)
    with torch.cuda.device(x.device):
        code = build.load().e2a_bn_fwd_apply(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), sums.data_ptr(),
            y.data_ptr(), mu.data_ptr(), sqrt_d.data_ptr(), m, d, eps,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, "bn_fwd")
    return y, mu, sqrt_d


def bn_bwd(g: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
           mu: torch.Tensor, sqrt_d: torch.Tensor, group=None):
    """eq. 19-23: g, x (M, D), gamma (D,), mu and sqrt_d (1, D) -> (dx
    (M, D), dgamma (1, D), dbeta (1, D)). A CUDA tensor launches the
    kernel's two passes (fp32, contiguous; anything else raises) and counts
    once; a CPU tensor takes the plain version. ``group``: eq. 23 over the
    rows of every rank in it (the split path: :func:`bn_bwd_sums`, an
    all-reduce, :func:`bn_bwd_apply`); dgamma and dbeta stay the rank's
    own."""
    if g.ndim != 2 or x.shape != g.shape or gamma.shape != (g.shape[1],) \
            or mu.numel() != g.shape[1] or sqrt_d.numel() != g.shape[1]:
        raise ValueError(f"bn_bwd expects g and x (M, D), gamma (D,), mu and "
                         f"sqrt_d (1, D), got {tuple(g.shape)}, "
                         f"{tuple(x.shape)}, {tuple(gamma.shape)}, "
                         f"{tuple(mu.shape)}, {tuple(sqrt_d.shape)}")
    if not g.is_cuda:
        return bn_bwd_plain(g, x, gamma, mu, sqrt_d, group)
    _check("bn_bwd", {"x": x, "g": g, "gamma": gamma, "mu": mu,
                      "sqrt_d": sqrt_d})
    if group is not None:
        sums, dgamma, dbeta = bn_bwd_sums(g, x, gamma, mu, sqrt_d)
        dist.all_reduce(sums, group=group)
        dx = bn_bwd_apply(g, x, gamma, mu, sqrt_d, sums)
        bn_bwd.launches += 1
        return dx, dgamma, dbeta
    m, d = g.shape
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


def bn_bwd_sums(g, x, gamma, mu, sqrt_d):
    """The split path's first backward launch (CUDA operands, checked by
    the caller): ``(sums, dgamma (1, D), dbeta (1, D))``, sums the (3 * D +
    1,) float64 buffer of this rank's s_n, s_m, s_mn per column and its
    row count; dgamma and dbeta from this rank's rows."""
    m, d = g.shape
    rows, chunks = _chunking(m, BWD_MIN_CHUNK_ROWS)
    buf = torch.empty((4 * chunks + 2, d), dtype=torch.float32,
                      device=g.device)
    part, dgamma, dbeta = buf.split([4 * chunks, 1, 1])
    sums = torch.empty(3 * d + 1, dtype=torch.float64, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = build.load().e2a_bn_bwd_sums(
            g.data_ptr(), x.data_ptr(), gamma.data_ptr(), mu.data_ptr(),
            sqrt_d.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
            part.data_ptr(), sums.data_ptr(),
            _arrival_counters(g.device, stream, d).data_ptr(), m, d, rows,
            stream)
    build.check_launch(code, "bn_bwd")
    return sums, dgamma, dbeta


def bn_bwd_apply(g, x, gamma, mu, sqrt_d, sums) -> torch.Tensor:
    """The split path's second backward launch: eq. 23's column terms from
    ``sums`` (every rank's, added), then dx."""
    m, d = g.shape
    dx = torch.empty_like(g)
    cols = torch.empty((4, d), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        code = build.load().e2a_bn_bwd_apply(
            g.data_ptr(), x.data_ptr(), gamma.data_ptr(), mu.data_ptr(),
            sqrt_d.data_ptr(), sums.data_ptr(), cols.data_ptr(),
            dx.data_ptr(), m, d, torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, "bn_bwd")
    return dx


#: Kernel launches since the counts were last set to 0.
bn_fwd.launches = 0
bn_bwd.launches = 0
