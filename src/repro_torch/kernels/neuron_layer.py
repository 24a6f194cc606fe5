"""The neuron layer (matmul + BN + SOMA) as one kernel call, eval and train.

``neuron_layer_eval`` replaces ``repro.kernels.neuron_layer.neuron_layer_eval``
(``_nl_eval_kernel`` with ``_accumulate`` and ``_soma``): a whole "neuron
layer" (the Conv1DBN -> SN pair, or one im2col'd eq. 4 tokenizer stage)
with BN folded into ``(w, bias)`` by the caller. The membrane update runs
in the epilogue and only spikes leave the kernel: the (T, M, K)
pre-activation never exists in device memory. The packed arm (every site
but the first tokenizer stage) runs, for each time step in turn, the
tensor-core mainloop that ``e2a_spike_matmul`` runs
(``csrc/spike_mma_mainloop.cuh``: exact three-way bf16 split of the fp32
weight) on a tile of the step's rows, then adds the bias and advances the
membranes, which stay with the block across the T steps; its products are
the spike matmul's bit for bit. The TPU kernel accumulated into a scratch
tile revisited across a sequential contraction grid axis; here a block
loops over C itself and masks its own tails. The dense arm (the first
stage: a float image, C = 27) stages the whole weight and each time step's
rows, one contiguous span, in shared memory and forms each output with fp32
FMAs over c ascending, a warp's stores two contiguous runs of K floats.
Bound on this card: three dense bf16 passes on the tensor cores at the
packed sites, bytes at the first stage.

``neuron_layer_train`` replaces ``repro.kernels.neuron_layer.
neuron_layer_train`` (``_nl_train_kernel``): the same product, then batch
statistics over all T*M rows of each column, BN and SOMA; it returns the
spikes and the fp32 statistics (mu, var) for the caller's running-stat
blend. The TPU kernel had one program own all T*M rows of a feature block
(12,544 at the blocks, 802,816 at the first tokenizer stage), which one
block of this card cannot hold, so the wrapper's one call is three launches
(``csrc/neuron_layer.cu``): z = x @ w, written once with deterministic
per-row-tile column sums of z and z^2; the statistics; and one pass that
reads z, normalises and runs SOMA over T in registers. In train mode T is
only a row index, so the packed arm's first pass is the spike matmul over
T*M rows on the tensor cores, 256-row tiles; the dense arm's is the eval
arm's fp32 product over T*M rows, 1024-row tiles. Storing z was chosen over recomputing the product in the SOMA
pass, which would double the dominant work. Bound on this card: three
dense bf16 passes on the tensor cores plus the z round trip at the block
sites, bytes at the first tokenizer stage.

With ``group`` (data parallelism: the statistics of the global batch) the
call is the split path: the first launch runs the z pass and leaves the
rank's column sums of z and z^2, in double, and its row count in a buffer;
the wrapper all-reduces the buffer over the group; the second forms the
statistics from the global sums (the fused path's arithmetic: at a world
of 1 its bits) and runs the SOMA pass. The plain version sums the same way.

``neuron_layer_train_z`` is that first pass alone: the autograd ops'
backward replays the pre-activation with it, so the replayed z is the
forward's bit for bit and the replay runs the spike trajectory the forward
emitted.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import build
from repro_torch.kernels.fused_bn import global_sums, row_count
from repro_torch.kernels.lif_soma import lif_soma_fwd_plain
from repro_torch.kernels.spike_matmul import spike_pack

#: Time steps the entry points take.
MAX_TIME_STEPS = 8

#: Rows of one tile of the packed train arm's first pass, over all T*M rows
#: (``ZTile::BM`` in ``csrc/neuron_layer.cu``, the ``Large`` tile of
#: ``csrc/spike_mma_mainloop.cuh``): one partial sum per tile and column.
TILE_ROWS = 256

#: The same for the dense arm, whose tiles also run over all T*M rows
#: (``DENSE_TILE_ROWS`` in ``csrc/neuron_layer.cu``).
DENSE_TILE_ROWS = 1024


def neuron_layer_train_z_plain(x: torch.Tensor,
                               w: torch.Tensor) -> torch.Tensor:
    """Plain version of the train arm's first pass, z = x (T, M, C) @ w
    (C, K) in fp32: the product every plain version of this module forms."""
    return torch.matmul(x.to(w.dtype), w).float()


def neuron_layer_eval_plain(x: torch.Tensor, w: torch.Tensor,
                            bias: torch.Tensor, *, alpha: float = 0.5,
                            th_fire: float = 1.0) -> torch.Tensor:
    """Plain version: dense matmul, bias, then the LIF recursion. ``x`` is
    the unpacked (T, M, C) input for both arms."""
    acc = neuron_layer_train_z_plain(x, w) + bias.float().reshape(1, 1, -1)
    s, _, _ = lif_soma_fwd_plain(acc, alpha=alpha, th_fire=th_fire)
    return s.to(x.dtype)


def _train_plain(x, w, gamma, beta, alpha, th_fire, eps, group=None):
    """The plain train arm: ``(spikes, mu, var, sqrt_d)``, the statistics
    (1, K), over the rows of every rank of ``group`` where one is given."""
    t, m, _ = x.shape
    z = neuron_layer_train_z_plain(x, w)
    zf = z.reshape(t * m, -1)
    if group is None:
        count = row_count(zf)              # divided by, as the kernel does
        mu = zf.sum(0, keepdim=True) / count
        ex2 = (zf * zf).sum(0, keepdim=True) / count
    else:
        sums, count = global_sums([zf.sum(0), (zf * zf).sum(0)], t * m,
                                  group)
        mu, ex2 = ((sums[i:i + 1] / count).float() for i in range(2))
    var = torch.clamp(ex2 - mu * mu, min=0.0)
    sqrt_d = torch.sqrt(var + eps)
    y = gamma.float() * (z - mu) / sqrt_d + beta.float()
    s, _, _ = lif_soma_fwd_plain(y, alpha=alpha, th_fire=th_fire)
    return s.to(x.dtype), mu, var, sqrt_d


def neuron_layer_train_plain(x: torch.Tensor, w: torch.Tensor,
                             gamma: torch.Tensor, beta: torch.Tensor, *,
                             alpha: float = 0.5, th_fire: float = 1.0,
                             eps: float = 1e-5, group=None):
    """Plain version of the train arm: dense matmul, batch statistics over
    all T*M rows (eq. 13-16; with ``group``, those of every rank), BN
    (eq. 17-18), the LIF recursion. Returns ``(spikes (T, M, K), mu (1, K),
    var (1, K))``."""
    return _train_plain(x, w, gamma, beta, alpha, th_fire, eps, group)[:3]


def _check_layer(what, x, w, vectors, packed):
    if x.ndim != 3 or w.ndim != 2:
        raise ValueError(f"{what} expects x (T, M, C) and w (C, K), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    c, k = x.shape[2], w.shape[1]
    if w.shape[0] != c:
        raise ValueError(f"weight contraction {w.shape[0]} != input {c}")
    for name, v in vectors.items():
        if v.shape != (k,):
            raise ValueError(f"{name} shape {tuple(v.shape)} != ({k},)")
    if packed and c % 8 != 0:
        raise ValueError(f"packed contraction dim {c} must be a multiple of 8")
    if not x.is_cuda:
        return
    if not 1 <= x.shape[0] <= MAX_TIME_STEPS:
        raise ValueError(f"{what} kernel supports 1..{MAX_TIME_STEPS} time "
                         f"steps, got {x.shape[0]}")
    if any(a.dtype != torch.float32 for a in (x, w, *vectors.values())):
        raise TypeError(f"{what} kernel takes float32 operands")
    if any(a.device != x.device for a in (w, *vectors.values())):
        raise ValueError(f"{what}: operands on different devices")
    if not all(a.is_contiguous() for a in (x, w, *vectors.values())):
        raise ValueError(f"{what} kernel takes contiguous operands")


def _launch_neuron_layer_eval(xin, w, bias, t, m, c, k, packed, alpha,
                              th_fire, stream=0, tile=0):
    """The C entry point on ``xin`` (packed or dense); ``tile`` 0 lets the
    entry point choose the packed arm's tile, 1 / 2 force Large / Small."""
    s = torch.empty((t, m, k), dtype=torch.float32, device=xin.device)
    code = build.load().e2a_neuron_layer_eval(
        xin.data_ptr(), w.data_ptr(), bias.data_ptr(), s.data_ptr(), t, m, c,
        k, int(packed), tile, alpha, th_fire, stream)
    build.check_launch(code, "neuron_layer_eval")
    return s


def neuron_layer_eval(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
                      alpha: float = 0.5, th_fire: float = 1.0,
                      packed: bool = False) -> torch.Tensor:
    """Eval-mode neuron layer: x (T, M, C) @ w (C, K) + bias -> SOMA, one
    launch. Returns spikes (T, M, K) in ``x.dtype``.

    ``packed=True`` bit-packs the {0,1} ``x`` along C (8 spikes/byte, plain
    tensor code) so that it crosses device memory at 1 bit/element and is
    expanded inside the kernel; C must then be a multiple of 8.
    """
    _check_layer("neuron_layer_eval", x, w, {"bias": bias}, packed)
    if not x.is_cuda:
        return neuron_layer_eval_plain(x, w, bias, alpha=alpha,
                                       th_fire=th_fire)
    t, m, c = x.shape
    xin = spike_pack(x) if packed else x
    with torch.cuda.device(x.device):
        s = _launch_neuron_layer_eval(
            xin, w, bias, t, m, c, w.shape[1], packed, alpha, th_fire,
            torch.cuda.current_stream().cuda_stream)
    neuron_layer_eval.launches += 1
    return s


def neuron_layer_train_fwd(x: torch.Tensor, w: torch.Tensor,
                           gamma: torch.Tensor, beta: torch.Tensor, *,
                           alpha: float = 0.5, th_fire: float = 1.0,
                           eps: float = 1e-5, packed: bool = False,
                           group=None):
    """:func:`neuron_layer_train` with what its autograd op keeps for the
    replay: ``(spikes, mu (1, K), var (1, K), sqrt_d (1, K), xin)``, where
    ``sqrt_d`` is the kernel's own ``sqrt(var + eps)`` and ``xin`` the
    packed input the kernel read (None for the dense arm and on the CPU)."""
    _check_layer("neuron_layer_train", x, w, {"gamma": gamma, "beta": beta},
                 packed)
    if not x.is_cuda:
        return (*_train_plain(x, w, gamma, beta, alpha, th_fire, eps, group),
                None)
    xin = spike_pack(x) if packed else None
    if group is not None:
        sums, z = neuron_layer_train_sums(x, w, packed=packed, xin=xin)
        dist.all_reduce(sums, group=group)
        out = neuron_layer_train_apply(z, gamma, beta, sums, alpha=alpha,
                                       th_fire=th_fire, eps=eps)
        neuron_layer_train.launches += 1
        return (*out, xin)
    t, m, c = x.shape
    k = w.shape[1]
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    s, z = (torch.empty((t, m, k), **f32) for _ in range(2))
    tiles = -(-t * m // (TILE_ROWS if packed else DENSE_TILE_ROWS))
    part = torch.empty((2, tiles, k), **f32)
    mu, var, sqrt_d = (torch.empty((1, k), **f32) for _ in range(3))
    with torch.cuda.device(dev):
        code = build.load().e2a_neuron_layer_train(
            (x if xin is None else xin).data_ptr(), w.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), z.data_ptr(), part.data_ptr(),
            mu.data_ptr(), var.data_ptr(), sqrt_d.data_ptr(), s.data_ptr(),
            t, m, c, k, int(packed), alpha, th_fire, eps,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, "neuron_layer_train")
    neuron_layer_train.launches += 1
    return s, mu, var, sqrt_d, xin


def neuron_layer_train_sums(x: torch.Tensor, w: torch.Tensor, *,
                            packed: bool = False,
                            xin: torch.Tensor | None = None):
    """The split path's first launch (CUDA operands, checked by the
    caller): the z pass, then this rank's sum(z) and sum(z^2) per column
    and its row count T * M in a (2 * K + 1,) float64 buffer, the fused
    path's doubles. ``xin``: ``spike_pack(x)`` where already made. Returns
    ``(sums, z)``."""
    t, m, c = x.shape
    k = w.shape[1]
    if packed and xin is None:
        xin = spike_pack(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    z = torch.empty((t, m, k), **f32)
    tiles = -(-t * m // (TILE_ROWS if packed else DENSE_TILE_ROWS))
    part = torch.empty((2, tiles, k), **f32)
    sums = torch.empty(2 * k + 1, dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        code = build.load().e2a_neuron_layer_train_sums(
            (xin if packed else x).data_ptr(), w.data_ptr(), z.data_ptr(),
            part.data_ptr(), sums.data_ptr(), t, m, c, k, int(packed),
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, "neuron_layer_train")
    return sums, z


def neuron_layer_train_apply(z: torch.Tensor, gamma: torch.Tensor,
                             beta: torch.Tensor, sums: torch.Tensor, *,
                             alpha: float = 0.5, th_fire: float = 1.0,
                             eps: float = 1e-5):
    """The split path's second launch: mu, var and sqrt_d from ``sums``
    (every rank's, added), then BN and SOMA over z. Returns ``(spikes,
    mu (1, K), var (1, K), sqrt_d (1, K))``."""
    t, m, k = z.shape
    f32 = dict(dtype=torch.float32, device=z.device)
    s = torch.empty((t, m, k), **f32)
    mu, var, sqrt_d = (torch.empty((1, k), **f32) for _ in range(3))
    with torch.cuda.device(z.device):
        code = build.load().e2a_neuron_layer_train_apply(
            z.data_ptr(), gamma.data_ptr(), beta.data_ptr(), sums.data_ptr(),
            mu.data_ptr(), var.data_ptr(), sqrt_d.data_ptr(), s.data_ptr(),
            t, m, k, alpha, th_fire, eps,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, "neuron_layer_train")
    return s, mu, var, sqrt_d


def neuron_layer_train(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, *, alpha: float = 0.5,
                       th_fire: float = 1.0, eps: float = 1e-5,
                       packed: bool = False, group=None):
    """Train-mode neuron layer: x (T, M, C) @ w (C, K) -> BN with the batch
    statistics over all T*M rows (with ``group``, the rows of every rank
    in it) -> SOMA. Returns ``(spikes (T, M, K), mu (1, K), var (1, K))``,
    the statistics in fp32. ``packed`` as in :func:`neuron_layer_eval`.
    One call launches the kernel's passes and counts once."""
    return neuron_layer_train_fwd(x, w, gamma, beta, alpha=alpha,
                                  th_fire=th_fire, eps=eps, packed=packed,
                                  group=group)[:3]


def neuron_layer_train_z(x: torch.Tensor, w: torch.Tensor, *,
                         packed: bool = False,
                         xin: torch.Tensor | None = None) -> torch.Tensor:
    """z = x (T, M, C) @ w (C, K) in fp32 by the train arm's first pass
    alone: the kernel and tile of :func:`neuron_layer_train`'s z, so the
    same bits. ``xin``, where given, is ``spike_pack(x)`` already made (the
    packed arm reads it instead of packing again). A launch counts as one
    of ``neuron_layer_train``, whose first pass it is."""
    _check_layer("neuron_layer_train_z", x, w, {}, packed)
    if not x.is_cuda:
        return neuron_layer_train_z_plain(x, w)
    t, m, c = x.shape
    if packed and xin is None:
        xin = spike_pack(x)
    src = xin if packed else x
    z = torch.empty((t, m, w.shape[1]), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = build.load().e2a_neuron_layer_train_z(
            src.data_ptr(), w.data_ptr(), z.data_ptr(), t, m, c, w.shape[1],
            int(packed), torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, "neuron_layer_train_z")
    neuron_layer_train.launches += 1
    return z


#: Kernel launches since the counts were last set to 0.
neuron_layer_eval.launches = 0
neuron_layer_train.launches = 0
