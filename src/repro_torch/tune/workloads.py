"""Plan-generated energy-model workloads: one record per dispatch site.

The counterpart of ``repro.tune.workloads``, built from the port's own plan
with the port's impl names (``IMPL_FROM_JAX``); every record equals the
reference's at the same config and batch, impl names mapped. Every
:class:`SiteWorkload` is derived from the model's execution plan
(``cfg.execution_plan()``, the rows ``describe_execution()`` renders), so
the op, the *effective* impl (after packing fallbacks), the packing arm
and the canonical dispatch shape all match what actually runs. Measured
per-site spike sparsity (``repro_torch.tune.sparsity``) slots into
``MMOp.in_sparsity``; without it the paper's default ``Sparsity.s_s``
applies to spike operands.

Canonical dispatch shapes mirror the tensors at the kernel boundary:

* ``linear_bn`` pipeline (``cuda+spike_mm`` / dense): ``(S, C, K)`` with
  ``S = T * B * N`` (``fold_rows`` collapses the leading axes).
* ``linear_bn`` / ``conv`` megakernel (``fused_epilogue``): ``(T, M, C,
  K)`` — the train arm runs all ``T*M`` rows in one call.
* ``conv`` patch matmul (``cuda``/``cuda_packed``): ``(T, M, C, K)``
  with T as the batched kernel's leading grid axis.
* ``attn_qk``: ``(G, N, dh, N)`` and ``attn_av``: ``(G, dh, N, N)`` with
  ``G = T * B * h`` (the transpose trick puts V^T on the packed side).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.energy.constants import DEFAULT_SPARSITY
from repro_torch.core.energy.workload import ElemOp, MMOp
from repro_torch.core.policy import IMPL_FROM_JAX

#: (op, impl) pairs with a knob the autotuner can turn: the spike
#: matmul's tile, or the fused-vs-pipeline arm of the neuron layer (the
#: reference's pairs, impl names mapped).
TUNABLE_IMPLS = frozenset((op, IMPL_FROM_JAX[impl]) for op, impl in [
    ("linear_bn", "pallas+spike_mm"),
    ("linear_bn", "fused_epilogue"),
    ("conv", "pallas_packed"),
    ("conv", "fused_epilogue"),
    ("attn_qk", "pallas_packed"),
    ("attn_av", "pallas_packed"),
])


@dataclasses.dataclass(frozen=True)
class SiteWorkload:
    """One dispatch site's workload, as planned for a given batch size."""

    site: str
    op: str
    impl: str                      # effective impl from the plan
    packed: bool                   # the arm that actually runs
    shape: tuple[int, ...]         # canonical dispatch shape (see module doc)
    calls: int                     # dispatches per training step
    mm: MMOp | None = None         # FP matmul (count covers all calls)
    elems: tuple[ElemOp, ...] = ()
    trailing_lif: bool = False     # megakernel fused-vs-pipeline arm applies

    @property
    def tunable(self) -> bool:
        return (self.op, self.impl) in TUNABLE_IMPLS


def _spec_map(cfg, model_shards: int = 1) -> dict[str, tuple]:
    """site -> (op, pack_dim, spike_operand, trailing_lif)."""
    out = {}
    for spec in cfg.execution_site_specs(model_shards):
        site, op, pack_dim, *rest = spec
        spike = rest[0] if rest else False
        trailing = rest[1] if len(rest) > 1 else False
        # lif/lif_state twins share a site; the MM view keeps the first.
        out.setdefault(site, (op, pack_dim, spike, trailing))
    return out


def training_mms(wl: SiteWorkload) -> list[MMOp]:
    """FP + the derived BP/WG matmuls of one linear-like site (Table IV
    structure: BP streams dense fp16 gradients, WG re-uses the spike
    operand on the stationary side)."""
    fp = wl.mm
    if fp is None:
        return []
    bp = dataclasses.replace(fp, name=f"{wl.site}.bp", stage="BP",
                             C=fp.K, K=fp.C, in_bits=16, in_sparsity=0.0)
    wg = dataclasses.replace(fp, name=f"{wl.site}.wg", stage="WG",
                             B=fp.C, C=fp.B, K=fp.K)
    return [fp, bp, wg]


def site_workloads(cfg, batch: int = 1,
                   sparsity: dict[str, float] | None = None,
                   model_shards: int = 1) -> list[SiteWorkload]:
    """Build per-site workloads from ``cfg.execution_plan()``, one rank's
    on a model axis of ``model_shards``.

    ``sparsity`` maps site -> measured zeros-fraction of the spike operand
    (see :func:`repro_torch.tune.sparsity.measure_sparsity`); missing sites get
    the paper default for spike operands and 0.0 for dense ones.
    """
    from repro_torch.analysis.audit import fused_site_geometries

    geoms = fused_site_geometries(cfg, batch, model_shards)
    specs = _spec_map(cfg, model_shards)
    sparsity = sparsity or {}
    t, n, d, h = (cfg.time_steps, cfg.num_tokens, cfg.d_model,
                  cfg.n_heads)
    layers = cfg.num_layers
    dh = d // h
    g = t * batch * h // model_shards        # the rank's heads

    def sp(site: str, spike: bool) -> float:
        if not spike:
            return 0.0
        return float(sparsity.get(site, DEFAULT_SPARSITY.s_s))

    out: list[SiteWorkload] = []
    for row in cfg.execution_plan(model_shards):
        site, op, impl = row.site, row.op, row.effective
        _, pack_dim, spike, trailing = specs.get(
            site, (op, None, False, False))
        if op in ("lif", "lif_state"):
            if any(w.site == site for w in out):
                continue            # lif/lif_state twins: one workload row
            n_elems = _lif_site_elems(site, cfg, batch, geoms)
            out.append(SiteWorkload(
                site=site, op="lif", impl=impl, packed=False,
                shape=(n_elems,), calls=layers if site != "tokenizer.lif"
                else 1,
                elems=(ElemOp(site, "FP", "soma", n_elems=n_elems),
                       ElemOp(site, "BP", "grad", n_elems=n_elems))))
            continue
        if op == "bn":
            elems = []
            for cs, geom in sorted(geoms.items()):
                if not cs.startswith("tokenizer.conv"):
                    continue
                gt, gm, _, gk = geom
                elems.append(ElemOp(f"{site}.{cs.rsplit('.', 1)[-1]}",
                                    "FP", "bn_fp", n_features=gk,
                                    n_samples=gt * gm))
                elems.append(ElemOp(f"{site}.{cs.rsplit('.', 1)[-1]}",
                                    "BP", "bn_bp", n_features=gk,
                                    n_samples=gt * gm))
            out.append(SiteWorkload(site=site, op=op, impl=impl,
                                    packed=False, shape=(), calls=1,
                                    elems=tuple(elems)))
            continue
        if op == "conv":
            gt, gm, gc, gk = geoms[site]
            packed = bool(spike and gc % 8 == 0 and
                          impl in ("cuda_packed", "fused_epilogue"))
            s = sp(site, spike)
            if impl in ("cuda", "cuda_packed"):
                shape = (gt, gm, gc, gk)
                mm = MMOp(site, "FP", gm, gc, gk,
                          in_bits=1 if packed else 16, in_sparsity=s,
                          count=gt)
            elif impl == "fused_epilogue":
                shape = (gt, gm, gc, gk)
                mm = MMOp(site, "FP", gt * gm, gc, gk,
                          in_bits=1 if packed else 16, in_sparsity=s)
            else:                   # eager: dense conv, im2col-equivalent MM
                shape = (gt * gm, gc, gk)
                mm = MMOp(site, "FP", gt * gm, gc, gk, in_sparsity=s)
            out.append(SiteWorkload(site=site, op=op, impl=impl,
                                    packed=packed, shape=shape, calls=1,
                                    mm=mm, trailing_lif=True))
            continue
        if op == "linear_bn":
            gt, gm, gc, gk = geoms[site]
            calls = layers * (3 if site == "pssa.qkv" else 1)
            packed = bool(spike and gc % 8 == 0 and
                          impl in ("cuda+spike_mm", "fused_epilogue"))
            s = sp(site, spike)
            if impl == "fused_epilogue":
                shape = (gt, gm, gc, gk)
            else:
                shape = (gt * gm, gc, gk)
            mm = MMOp(site, "FP", gt * gm, gc, gk,
                      in_bits=1 if packed else 16, in_sparsity=s,
                      count=calls)
            elems = (ElemOp(site, "FP", "bn_fp", n_features=gk,
                            n_samples=gt * gm),
                     ElemOp(site, "BP", "bn_bp", n_features=gk,
                            n_samples=gt * gm))
            out.append(SiteWorkload(site=site, op=op, impl=impl,
                                    packed=packed, shape=shape, calls=calls,
                                    mm=mm, elems=elems,
                                    trailing_lif=bool(trailing)))
            continue
        if op in ("attn_qk", "attn_av"):
            packed = bool((dh if op == "attn_qk" else n) % 8 == 0 and
                          impl == "cuda_packed")
            s = sp(site, True)
            if op == "attn_qk":
                shape = (g, n, dh, n)
                mm = MMOp(site, "FP", n, dh, n, in_bits=1 if packed else 16,
                          in_sparsity=s, count=g * layers)
            else:                   # transpose trick: V^T on the packed side
                shape = (g, dh, n, n)
                mm = MMOp(site, "FP", dh, n, n, in_bits=1 if packed else 16,
                          in_sparsity=s, count=g * layers)
            out.append(SiteWorkload(site=site, op=op, impl=impl,
                                    packed=packed, shape=shape,
                                    calls=layers, mm=mm))
            continue
    return out


@dataclasses.dataclass(frozen=True)
class KernelShapeCase:
    """One site's abstract geometry at the *kernel* boundary.

    Unlike :class:`SiteWorkload` (the energy model's per-site op counts),
    these rows carry the normalized ``(t, m, c, k)`` launch geometry (the
    reference's kernel-contract verifier checks its contracts on them):
    ``t`` the leading time/batch grid axis (1 when the
    launch folds it away), ``m`` rows, ``c`` contraction (0 for
    elementwise/BN sites), ``k`` output features.
    """

    site: str
    op: str
    impl: str                       # effective impl from the plan
    packed: bool
    t: int
    m: int
    c: int
    k: int


def kernel_shape_cases(cfg, batch: int = 1, model_shards: int = 1
                       ) -> list[KernelShapeCase]:
    """Kernel-boundary geometries for every planned site of ``cfg`` (one
    rank's on a model axis of ``model_shards``).

    Derived from the same ``cfg.execution_plan()`` rows as
    :func:`site_workloads`, but keeping the lif/lif_state twins (their
    backward kernels differ) and the full launch layout instead of the
    energy-model op counts.
    """
    from repro_torch.analysis.audit import fused_site_geometries

    geoms = fused_site_geometries(cfg, batch, model_shards)
    specs = _spec_map(cfg, model_shards)
    t, n, d, h = (cfg.time_steps, cfg.num_tokens, cfg.d_model, cfg.n_heads)
    dh = d // h
    g = t * batch * h // model_shards        # the rank's heads
    conv_geoms = sorted((s, gm) for s, gm in geoms.items()
                        if s.startswith("tokenizer.conv"))

    out: list[KernelShapeCase] = []
    for row in cfg.execution_plan(model_shards):
        site, op, impl = row.site, row.op, row.effective
        _, pack_dim, spike, trailing = specs.get(
            site, (op, None, False, False))
        if op in ("lif", "lif_state"):
            # The SOMA/GRAD pair runs on fold_time_major output (T, M, D);
            # the tokenizer site sees one geometry per conv stage.
            if site == "tokenizer.lif":
                for cs, (gt, gm, _, gk) in conv_geoms:
                    out.append(KernelShapeCase(site=f"{site}[{cs}]", op=op,
                                               impl=impl, packed=False,
                                               t=gt, m=gm, c=0, k=gk))
            else:
                out.append(KernelShapeCase(site=site, op=op, impl=impl,
                                           packed=False, t=t, m=batch * n,
                                           c=0, k=d))
            continue
        if op == "bn":
            # Dispatches on fold_rows output (T*M, D), per conv stage.
            for cs, (gt, gm, _, gk) in conv_geoms:
                out.append(KernelShapeCase(site=f"{site}[{cs}]", op=op,
                                           impl=impl, packed=False,
                                           t=1, m=gt * gm, c=0, k=gk))
            continue
        if op in ("conv", "linear_bn"):
            gt, gm, gc, gk = geoms[site]
            packed_impls = (("cuda_packed", "fused_epilogue")
                            if op == "conv"
                            else ("cuda+spike_mm", "fused_epilogue"))
            packed = bool(spike and gc % 8 == 0 and impl in packed_impls)
            if impl == "fused_epilogue" or (op == "conv"
                                            and impl != "eager"):
                shape = (gt, gm, gc, gk)     # time-major (T, M, C) launch
            else:
                shape = (1, gt * gm, gc, gk)  # fold_rows pipeline launch
            out.append(KernelShapeCase(site=site, op=op, impl=impl,
                                       packed=packed, t=shape[0], m=shape[1],
                                       c=shape[2], k=shape[3]))
            continue
        if op in ("attn_qk", "attn_av"):
            packed = bool((dh if op == "attn_qk" else n) % 8 == 0 and
                          impl == "cuda_packed")
            if op == "attn_qk":
                out.append(KernelShapeCase(site=site, op=op, impl=impl,
                                           packed=packed, t=g, m=n, c=dh,
                                           k=n))
            else:                   # transpose trick: V^T on the packed side
                out.append(KernelShapeCase(site=site, op=op, impl=impl,
                                           packed=packed, t=g, m=dh, c=n,
                                           k=n))
            continue
    return out


def _lif_site_elems(site: str, cfg, batch: int, geoms) -> int:
    t, n, d = cfg.time_steps, cfg.num_tokens, cfg.d_model
    if site == "tokenizer.lif":
        return sum(gt * gm * gk for s, (gt, gm, _, gk) in geoms.items()
                   if s.startswith("tokenizer.conv"))
    # pssa.lif / smlp.lif scan the (T, B, N, D) residual stream per layer.
    return t * batch * n * d * cfg.num_layers
