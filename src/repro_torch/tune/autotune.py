"""Site-level kernel autotuner: oracle-pruned, warm-up-blocked timing.

The counterpart of ``repro.tune.autotune``. Per tunable site
(``repro_torch.tune.workloads.TUNABLE_IMPLS``):

1. the analytic oracle ranks every feasible candidate
   (:func:`repro_torch.tune.oracle.oracle_rank`, pure arithmetic): the
   spike matmul's tiles, or the neuron layer's fused and pipeline arms;
2. the top-K candidates are timed, on operands drawn at the site's
   *measured* sparsity from a ``torch.Generator``, after one warm-up call,
   each call on the next of copies of its operands that span four L2s
   (:func:`l2_cold`), so that its bytes cross device memory as they do in
   a training step, the calls queued behind a sleeping kernel so that CUDA
   events time the kernels and not the host (:func:`queued_ms`);
3. the measured winner becomes a :class:`repro_torch.tune.table.
   TunedBlocks` entry keyed by ``(device_kind, site, op, impl, shape,
   packing)``.

On the card the candidates are the kernels as the model runs them, timed
with CUDA events: the spike matmul with its tile forced, forward only (its
backward, the dense VJP, does not depend on the tile); a neuron layer's
arms forward *and* backward, because dispatch takes a table's arm in train
mode only and the arms' backwards differ: the fused arm is
``ops.neuron_layer_train_op`` (``neuron_layer_train``, then a backward
that replays the pre-activation through the z pass, ``lif_soma_bwd`` and
``bn_bwd``), the pipeline arm the port's own pipeline under autograd (the
spike matmul, ``bn_fwd`` and ``lif_soma_fwd``, then ``lif_soma_bwd``,
``bn_bwd`` and the dense VJP, no replay). The oracle's cycles stay the
reference's forward-only model: they order the candidates, the timing
picks the winner. On the CPU the same calls take the plain versions and
are timed on the host's clock under the device kind ``cpu``: that is for
the tests only. A candidate that raises, raises: the sweep has no circuit
breaker.
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import math
import time

import torch

from repro_torch.core.energy.constants import H100_L2_BYTES
from repro_torch.tune.oracle import OracleCandidate, oracle_array, oracle_rank
from repro_torch.tune.sparsity import SparsityReport, measure_sparsity
from repro_torch.tune.table import (TunedBlocks, current_device_kind,
                                    save_table, site_key)
from repro_torch.tune.workloads import SiteWorkload, site_workloads

logger = logging.getLogger(__name__)

L2_BYTES = H100_L2_BYTES


def l2_cold(call, operands: tuple, moved: int):
    """A function that runs ``call`` on the next of ``ceil(4 * L2 / moved)``
    copies of ``operands`` (each in its operand's layout; None stays None)
    and keeps that copy's outputs until its turn comes again. The copies and
    their outputs span four L2s, so each call reads its inputs from device
    memory and writes its outputs over lines that go back to it: the bytes
    over the HBM rate bound such a call."""
    n = max(1, math.ceil(4 * L2_BYTES / moved))
    sets = [operands] + [tuple(None if o is None else
                               torch.empty_like(o).copy_(o) for o in operands)
                         for _ in range(n - 1)]
    kept = [None] * n
    turn = itertools.count()

    def fn():
        k = next(turn) % n
        kept[k] = call(*sets[k])
    return fn


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(t) for t in tree)
    return 0


#: SM cycles the first hold of the stream lasts (about 5 ms at 1.98 GHz);
#: :func:`queued_ms` quadruples it while the host falls behind, up to
#: ``_HOLD_MAX`` (about 2 s).
_HOLD_CYCLES, _HOLD_MAX = 10_000_000, 4_000_000_000


def queued_ms(fn, reps: int, device: torch.device) -> float | None:
    """Device ms per call of ``fn``, its calls run back to back: a sleeping
    kernel holds the stream while the host enqueues ``reps`` calls between
    two CUDA events, so the host's launch time between kernels is not
    counted (what remains is the kernels' time and the card's own gaps
    between them). None when the host cannot stay ahead of the longest
    hold: a call that synchronises with the card, or ``reps`` calls of more
    launches than the launch queue holds (about a thousand: a model's
    forward or step)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    hold = _HOLD_CYCLES
    with torch.cuda.device(device):
        while hold <= _HOLD_MAX:
            torch.cuda._sleep(hold)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            ahead = not start.query()     # the hold had not ended yet
            torch.cuda.synchronize(device)
            if ahead:
                return start.elapsed_time(end) / reps
            hold *= 4
    return None


def _time_us(call, operands: tuple, device: torch.device, reps: int) -> float:
    """Microseconds per call: one warm-up call first (the kernels build on
    the first launch), then ``reps`` calls; on the card their device time
    with the L2 cold (:func:`queued_ms` over :func:`l2_cold`), on the CPU
    the host's clock."""
    out = call(*operands)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            call(*operands)
        return (time.perf_counter() - t0) / reps * 1e6
    fn = l2_cold(call, operands, _nbytes(operands) + _nbytes(out))
    del out
    fn()
    ms = queued_ms(fn, reps, device)
    if ms is None:
        raise RuntimeError(f"{call!r} synchronises with the card: its "
                           f"kernels cannot be timed back to back")
    return ms * 1e3


def _spikes(gen, shape, sparsity: float, device) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, device=device)
            >= sparsity).float()


def _dense(gen, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device)


def _train_arm(wl: SiteWorkload, arm: str, tile: int):
    """One train arm of a neuron-layer site, forward and backward, as a
    training step runs it: ``fused``, ``ops.neuron_layer_train_op``;
    ``pipeline``, the product (``ops.spike_matmul_train_op`` or
    ``spike_patch_mm_train_op`` on ``tile``, or ``torch.matmul`` on a
    dense input), ``ops.bn_train_op`` over all T*M rows and
    ``ops.lif_soma_op``. Returns the gradients under the cotangent ``g``
    of w, gamma, beta and, where the input is spikes, of x (a dense input
    is the image, which takes none)."""
    from repro_torch.kernels import ops

    def run(x, w, gamma, beta, g):
        with torch.enable_grad():
            x = x.detach().requires_grad_(wl.packed)
            w, gamma, beta = (p.detach().requires_grad_()
                              for p in (w, gamma, beta))
            t, m, c = x.shape
            if arm == "fused":
                s = ops.neuron_layer_train_op(x, w, gamma, beta,
                                              packed=wl.packed)[0]
            else:
                if not wl.packed:
                    y = torch.matmul(x, w)
                elif wl.op == "conv":
                    y = ops.spike_patch_mm_train_op(x, w, tile)
                else:
                    y = ops.spike_matmul_train_op(x.reshape(t * m, c), w,
                                                  tile)
                y, _, _ = ops.bn_train_op(y.reshape(t * m, -1), gamma, beta)
                s = ops.lif_soma_op(y.reshape(t, m, -1))
            leaves = (x, w, gamma, beta) if wl.packed else (w, gamma, beta)
            return torch.autograd.grad(s, leaves, g)
    return run


def _candidate(wl: SiteWorkload, cand: OracleCandidate, gen, device):
    """``(call, operands)`` of one candidate on operands drawn at the
    site's sparsity, each in the layout the model hands its kernel."""
    from repro_torch.kernels import spike_matmul

    sp = wl.mm.in_sparsity if wl.mm is not None else 0.0
    tile = cand.as_tuned().tile()
    pack = spike_matmul.spike_pack

    if (wl.op, wl.impl) == ("linear_bn", "cuda+spike_mm"):
        s, c, k = wl.shape
        return (lambda x, w: spike_matmul.spike_matmul_packed(x, w,
                                                               tile=tile),
                (pack(_spikes(gen, (s, c), sp, device)),
                 _dense(gen, (c, k), device)))
    if (wl.op, wl.impl) == ("conv", "cuda_packed"):
        t, m, c, k = wl.shape
        return (lambda x, w: spike_matmul.spike_matmul_packed_batched(
                    x, w.unsqueeze(0).expand(t, c, k), tile=tile),
                (pack(_spikes(gen, (t, m, c), sp, device)),
                 _dense(gen, (c, k), device)))
    if wl.op in ("attn_qk", "attn_av"):
        # K^T and attn^T are transposed views in the model: unit stride
        # along the contraction
        g, b, c, k = wl.shape
        return (lambda x, w: spike_matmul.spike_matmul_packed_batched(
                    x, w, tile=tile),
                (pack(_spikes(gen, (g, b, c), sp, device)),
                 _dense(gen, (g, k, c), device).transpose(-1, -2)))
    if wl.impl == "fused_epilogue":
        t, m, c, k = wl.shape
        x = (_spikes(gen, (t, m, c), sp, device) if wl.packed
             else _dense(gen, (t, m, c), device))
        return (_train_arm(wl, cand.arm, tile),
                (x, _dense(gen, (c, k), device) * c ** -0.5,
                 torch.ones(k, device=device), torch.zeros(k, device=device),
                 _dense(gen, (t, m, k), device)))
    raise ValueError(f"no timed path for {wl.site} ({wl.op}, {wl.impl})")


@dataclasses.dataclass(frozen=True)
class SiteTuneResult:
    workload: SiteWorkload
    ranked: tuple[OracleCandidate, ...]      # oracle order, best first
    timed: tuple[tuple[OracleCandidate, float], ...]   # (candidate, us)
    winner: OracleCandidate | None
    winner_us: float | None

    @property
    def winner_in_top1(self) -> bool | None:
        if self.winner is None or not self.ranked:
            return None
        return self.winner == self.ranked[0]


@dataclasses.dataclass(frozen=True)
class TuneReport:
    entries: dict[str, TunedBlocks]          # site_key -> winner
    results: tuple[SiteTuneResult, ...]
    sparsity: SparsityReport
    device_kind: str


def tune_site(wl: SiteWorkload, *, top_k: int = 3, reps: int = 3, arr=None,
              device: str | torch.device | None = None,
              seed: int = 0) -> SiteTuneResult | None:
    """Oracle-rank then time the top-K candidates for one site on
    ``device`` (``None`` = the card). None for a site with no candidate."""
    from repro_torch.core.backend import resolve_device

    ranked = oracle_rank(wl, arr if arr is not None else oracle_array())
    if not ranked:
        return None
    device = resolve_device(device)
    timed = []
    for cand in ranked[:max(1, top_k)]:
        gen = torch.Generator(device=device).manual_seed(seed)
        call, operands = _candidate(wl, cand, gen, device)
        with torch.no_grad():
            timed.append((cand, _time_us(call, operands, device, reps)))
        del call, operands
    winner, winner_us = min(timed, key=lambda cu: cu[1])
    return SiteTuneResult(wl, tuple(ranked), tuple(timed), winner,
                          winner_us)


def tune(cfg, *, batch: int = 1, sites: list[str] | None = None,
         top_k: int = 3, reps: int = 3, smoke: bool = False, seed: int = 0,
         sparsity: SparsityReport | None = None,
         device: str | torch.device | None = None) -> TuneReport:
    """Tune every tunable site of a model config's execution plan on
    ``device`` (``None`` = the card).

    ``smoke`` shrinks the sweep to a 2-candidate, single-rep pass.
    Sparsity is *measured* from an instrumented forward (at ``batch``, at
    least 2), unless ``sparsity`` hands in a report already measured.
    """
    if smoke:
        top_k, reps = 2, 1
    report = sparsity if sparsity is not None else measure_sparsity(
        cfg, batch=max(batch, 2), seed=seed, device=device)
    site_sp = report.site_sparsity()
    kind = current_device_kind(device)
    entries: dict[str, TunedBlocks] = {}
    results = []
    for wl in site_workloads(cfg, batch, site_sp):
        if sites is not None and wl.site not in sites:
            continue
        if not wl.tunable:
            continue
        res = tune_site(wl, top_k=top_k, reps=reps, device=device, seed=seed)
        if res is None:
            continue
        results.append(res)
        key = site_key(wl.site, wl.op, wl.impl, wl.shape, wl.packed, kind)
        entries[key] = res.winner.as_tuned(
            measured_us=round(res.winner_us, 3),
            sparsity=round(wl.mm.in_sparsity, 4) if wl.mm else None)
    return TuneReport(entries=entries, results=tuple(results),
                      sparsity=report, device_kind=kind)


def tune_and_save(cfg, path, **kw) -> TuneReport:
    """Run :func:`tune` and persist the winners as a versioned table."""
    rep = tune(cfg, **kw)
    save_table(path, rep.entries, meta={"device_kind": rep.device_kind})
    logger.info("wrote %d tuned-block entries to %s", len(rep.entries),
                path)
    return rep
