"""Measured per-site spike sparsity from one instrumented training forward.

The counterpart of ``repro.tune.sparsity``. The paper's energy model takes
sparsity as an *input* (``Sparsity(s_s, s_smg, s_pg)``, defaults from §V);
here it is measured: ``probe`` registry impls wrap the port's ``eager``
functions and count the zeros of the spike operand at every LIF / matmul
site directly, ``(x != 0).sum()`` (the reference needs
``jax.debug.callback`` to get them out of a trace). Running the forward
under the probe :class:`~repro_torch.core.policy.ExecutionPolicy` routes
every site through them.

Measured quantities:

* per-site zeros-fraction of the matmul/LIF input spike operand (feeds
  ``MMOp.in_sparsity`` in ``repro_torch.tune.workloads``);
* per-LIF-site spike-output sparsity (the paper's ``s_s``) and surrogate
  gradient-mask sparsity (``s_smg``, via ``spike_grad_mask`` on the
  membrane trajectory).

``s_pg`` (partial-sum gradient sparsity) needs backward instrumentation
and keeps the paper default, as in the reference.
"""
from __future__ import annotations

import contextvars
import dataclasses

import torch

from repro_torch.core.energy.constants import DEFAULT_SPARSITY, Sparsity
from repro_torch.core.policy import ExecutionPolicy, register_kernel

#: The counts of the :func:`sparsity_report` running in this context:
#: (site, kind ("in" | "spike" | "mask")) -> [nonzeros, total]. A probe
#: called outside a report counts nothing.
_COUNTS: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "sparsity_counts", default=None)


def _emit(site: str, kind: str, arr: torch.Tensor) -> None:
    counts = _COUNTS.get()
    if counts is None:
        return
    acc = counts.setdefault((site, kind), [0.0, 0.0])
    acc[0] += float((arr != 0).sum())
    acc[1] += float(arr.numel())


# ---------------------------------------------------------------------------
# Probe impls (eager semantics + counting; never used for speed)
# ---------------------------------------------------------------------------

def _scan(x_seq, u, s, cfg):
    from repro_torch.core.lif import lif_step

    us, spikes = [], []
    for t in range(x_seq.shape[0]):
        u, s = lif_step(u, s, x_seq[t], cfg)
        us.append(u)
        spikes.append(s)
    return torch.stack(us), torch.stack(spikes), (u, s)


def _emit_lif(site, us, spikes, cfg):
    from repro_torch.core.lif import spike_grad_mask

    _emit(site, "spike", spikes)
    _emit(site, "mask", spike_grad_mask(us, cfg))


@register_kernel("lif", "probe")
def _lif_probe(x_seq, cfg, site):
    zero = torch.zeros_like(x_seq[0])
    us, spikes, _ = _scan(x_seq, zero, zero, cfg)
    _emit_lif(site, us, spikes, cfg)
    return spikes


@register_kernel("lif_state", "probe")
def _lif_state_probe(x_seq, u0, s0, cfg, site):
    us, spikes, last = _scan(x_seq, u0, s0, cfg)
    _emit_lif(site, us, spikes, cfg)
    return spikes, last


@register_kernel("linear_bn", "probe")
def _linear_bn_probe(params, state, x, train, policy, site):
    from repro_torch.core.spiking_layers import _linear_bn_eager

    _emit(site, "in", x)
    return _linear_bn_eager(params, state, x, train, policy, site)


@register_kernel("conv", "probe")
def _conv_probe(params, state, x, lif_cfg, train, spike_in, policy, site):
    from repro_torch.core.spikingformer import _conv_stage_eager

    if spike_in:
        _emit(site, "in", x)
    return _conv_stage_eager(params, state, x, lif_cfg, train, spike_in,
                             policy, site)


@register_kernel("attn_qk", "probe")
def _attn_qk_probe(q, k, policy, site):
    from repro_torch.core.spiking_layers import _attn_qk_eager

    _emit(site, "in", q)
    return _attn_qk_eager(q, k, policy, site)


@register_kernel("attn_av", "probe")
def _attn_av_probe(attn, v, policy, site):
    from repro_torch.core.spiking_layers import _attn_av_eager

    _emit(site, "in", v)    # V is the packed (spike) operand
    return _attn_av_eager(attn, v, policy, site)


PROBE_OVERRIDES = (("lif", "probe"), ("lif_state", "probe"),
                   ("linear_bn", "probe"), ("conv", "probe"),
                   ("attn_qk", "probe"), ("attn_av", "probe"))

#: The policy that routes every site through a probe.
PROBE_POLICY = ExecutionPolicy(backend="eager", overrides=PROBE_OVERRIDES)


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SparsityReport:
    """Zeros-fractions per site from one instrumented forward."""

    operand: dict[str, float]       # matmul sites: input-operand zeros
    spike: dict[str, float]         # LIF sites: output-spike zeros (s_s)
    mask: dict[str, float]          # LIF sites: surrogate-mask zeros (s_smg)
    totals: dict[tuple[str, str], tuple[float, float]]

    def site_sparsity(self) -> dict[str, float]:
        """site -> in_sparsity for :func:`repro_torch.tune.workloads
        .site_workloads`: the measured input-operand sparsity where a
        probe saw the operand, else the measured LIF-output sparsity."""
        return {**self.spike, **self.operand}

    def aggregate(self) -> Sparsity:
        """Element-weighted means, folded into the paper's ``Sparsity``.
        ``s_pg`` keeps the default (no backward instrumentation)."""
        def mean(kind: str, default: float) -> float:
            num = den = 0.0
            for (site, k), (nz, total) in self.totals.items():
                if k == kind:
                    num += total - nz
                    den += total
            return num / den if den else default

        return Sparsity(s_s=mean("spike", DEFAULT_SPARSITY.s_s),
                        s_smg=mean("mask", DEFAULT_SPARSITY.s_smg),
                        s_pg=DEFAULT_SPARSITY.s_pg)


def sparsity_report(params, state, images: torch.Tensor, cfg, *,
                    train: bool = True) -> SparsityReport:
    """One forward of ``cfg``'s model on ``images`` with these weights under
    the probe policy (whatever ``cfg``'s own policy is): the measured
    per-site sparsities."""
    from repro_torch.core.spikingformer import spikingformer_apply

    counts: dict[tuple[str, str], list[float]] = {}
    token = _COUNTS.set(counts)
    try:
        with torch.no_grad():
            spikingformer_apply(params, state, images,
                                cfg.with_policy(PROBE_POLICY), train=train)
    finally:
        _COUNTS.reset(token)

    def frac(kind: str) -> dict[str, float]:
        return {site: 1.0 - nz / total
                for (site, k), (nz, total) in sorted(counts.items())
                if k == kind and total}

    return SparsityReport(operand=frac("in"), spike=frac("spike"),
                          mask=frac("mask"),
                          totals={k: tuple(v) for k, v in counts.items()})


def measure_sparsity(cfg, batch: int = 2, seed: int = 0, train: bool = True,
                     device: str | torch.device | None = None
                     ) -> SparsityReport:
    """Run one seeded synthetic forward under the probe policy on
    ``device`` (``None`` = the card) and return the measured per-site
    sparsities: weights from ``init_spikingformer`` and uniform images (or
    Bernoulli(0.5) frames under ``spike_input``), all drawn from one
    ``torch.Generator`` seeded with ``seed``. Deterministic for a given
    (cfg, batch, seed)."""
    from repro_torch.core.backend import resolve_device
    from repro_torch.core.spikingformer import init_spikingformer

    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params, state = init_spikingformer(gen, cfg, device)
    shape = (batch, cfg.image_size, cfg.image_size, cfg.in_channels)
    if cfg.spike_input:
        x = (torch.rand((cfg.time_steps,) + shape, generator=gen)
             < 0.5).to(cfg.dtype)
    else:
        x = torch.rand(shape, generator=gen, dtype=torch.float32)
    return sparsity_report(params, state, x.to(device=device, dtype=cfg.dtype),
                           cfg, train=train)
