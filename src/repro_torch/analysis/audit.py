"""Static execution-plan auditor: the plan that runs is the plan analyzed
(the counterpart of ``repro.analysis.audit``).

This module walks the static surfaces of the port, ``execution_plan()``,
``describe_execution(mesh)``, the serving-cache constructors and the tuned
table, for every registered config x policy preset, without running a
kernel, and reports:

* overrides naming sites no model registers (``audit.plan.overrides``),
  errors;
* % 8 packing demotions not marked :attr:`SiteDecision.expected`
  (``audit.plan.packing``), errors: the measured time and energy would
  silently diverge from the analyzed dataflow;
* ``tokenizer.bn`` / ``tokenizer.lif`` rows that the fused conv impls make
  never-dispatched but that lack the plan annotation
  (``audit.plan.annotation``), errors;
* sites whose launches ask for more dynamic shared memory than a block of
  the card may have (``audit.plan.smem``), warnings: the reference's VMEM
  budget becomes the card's own, each launch's shared memory read from the
  library's plan exports (``csrc/launch_plan.cuh``; on the card only, an
  ``info`` row says so elsewhere);
* serving-cache slot-axis inconsistencies between ``init_cache``,
  ``cache_batch_axes`` and ``reset_cache_slots`` (``audit.serving.cache``),
  errors, checked on ``meta`` tensors (no allocation);
* ``describe_execution(mesh)`` failures on the mesh shapes the ranks
  present can hold (``audit.mesh.describe``), errors;
* tuned-table entries (``audit.tune.table``) whose keys are malformed, name
  sites no model registers, carry ops or impls the registry does not know
  (or that have no block knobs), name blocks that are no tile of the spike
  matmul kernel, or whose packed shape violates the % 8 contract, errors.

Everything returns :class:`repro_torch.analysis.report.Finding` rows; the
CLI (``python -m repro_torch.analysis --audit``) turns errors into a
non-zero exit.
"""
from __future__ import annotations

from typing import Iterable, Mapping, Sequence

from repro_torch.analysis.report import Finding, error, info, warning

__all__ = ["audit_breaker", "audit_mesh_plans", "audit_serving_caches",
           "audit_spikingformer_plans", "audit_tuned_table",
           "fused_site_geometries", "run_audit"]

#: Arch families whose decode path has no slot cache contract (the audio
#: encoder-decoder serves through a different entry point).
_SKIP_CACHE_FAMILIES = {"audio"}


# ---------------------------------------------------------------------------
# Plan audit: presets x policies
# ---------------------------------------------------------------------------

def fused_site_geometries(cfg, batch: int, model_shards: int = 1
                          ) -> dict[str, tuple]:
    """``site -> (t, m, c, k)`` matmul geometry for every fused-epilogue
    candidate site of a Spikingformer config, at global batch ``batch``.
    Conv stages use their im2col geometry (rows = batch x out-pixel
    count, contraction = 9 x c_in); the Q/K/V projections share one site
    and one geometry. With ``model_shards`` = M, one rank's: the
    column-parallel sites' K and the row-parallel sites' C over M."""
    t, n, d = cfg.time_steps, cfg.num_tokens, cfg.d_model
    m = cfg.check_model_shards(model_shards)
    geoms: dict[str, tuple] = {}
    h = cfg.image_size
    for i, (c_in, c_out) in enumerate(cfg.tokenizer_stage_channels()):
        h //= 2
        geoms[f"tokenizer.conv.{i}"] = (t, batch * h * h, 9 * c_in, c_out)
    geoms["pssa.qkv"] = (t, batch * n, d, d // m)
    geoms["pssa.proj"] = (t, batch * n, d // m, d)
    geoms["smlp.a"] = (t, batch * n, d, cfg.d_ff // m)
    geoms["smlp.b"] = (t, batch * n, cfg.d_ff // m, d)
    return geoms


def site_smem(cfg, batch: int) -> dict[str, int]:
    """``site -> the most dynamic shared memory (bytes) one launch of its
    kernels asks for`` at global batch ``batch``, read from the plan
    exports; needs the card. Sites whose impl launches no kernel are
    absent."""
    from repro_torch.analysis.contracts import config_cases, read_launches
    from repro_torch.kernels.contract import SkipCase

    out: dict[str, int] = {}
    for site, decl, case in config_cases(cfg, batch):
        try:
            args, fn_kwargs, _ = decl.build(case)
        except SkipCase:
            continue
        for call in read_launches(decl, args, fn_kwargs):
            for launch in call.launches:
                out[site] = max(out.get(site, 0), launch.smem)
    return out


def audit_spikingformer_plans(presets: Sequence[str] | None = None,
                              policies: Mapping[str, object] | None = None,
                              *, batch: int = 1,
                              smem: bool | None = None) -> list[Finding]:
    """Audit every preset x policy plan (see module docstring). ``smem``:
    read the sites' shared memory from the plan exports (None: where there
    is a CUDA device)."""
    from repro_torch.analysis.contracts import (MAX_SMEM,
                                                launch_family_unavailable)
    from repro_torch.configs.spikingformer import (SPIKINGFORMER_PRESETS,
                                                   get_spikingformer_config)
    from repro_torch.core.policy import NAMED_POLICIES
    from repro_torch.core.spikingformer import (FUSED_CONV_IMPLS,
                                                SINGLE_LAUNCH_CONV_IMPLS)

    why_not = launch_family_unavailable()
    if smem is None:
        smem = why_not is None
    presets = list(presets if presets is not None
                   else sorted(SPIKINGFORMER_PRESETS))
    policies = dict(policies if policies is not None else NAMED_POLICIES)
    findings: list[Finding] = []
    for preset in presets:
        for polname, pol in policies.items():
            where = f"{preset}@{polname}"
            try:
                cfg = get_spikingformer_config(preset, policy=pol)
                rows = cfg.execution_plan()
            except (ValueError, KeyError) as e:
                findings.append(error("audit.plan.overrides", where, str(e)))
                continue
            by_site = {r.site: r for r in rows}

            for r in rows:
                if "% 8" in r.note and not r.expected:
                    findings.append(error(
                        "audit.plan.packing", f"{where}/{r.site}",
                        f"unplanned packing demotion ({r.note}): the "
                        f"analyzed dataflow assumes the packed arm; mark "
                        f"the decision expected in the model's "
                        f"execution_plan() or fix the shape"))

            # Never-dispatched sites must say so in the plan: if every conv
            # stage runs a fused impl, the standalone bn (and, under the
            # megakernel, lif) site never dispatches.
            conv = [r for r in rows if r.op == "conv"]
            for site, impls, what in (
                    ("tokenizer.bn", FUSED_CONV_IMPLS, "BN fold"),
                    ("tokenizer.lif", SINGLE_LAUNCH_CONV_IMPLS,
                     "SOMA absorption")):
                row = by_site.get(site)
                if row is not None and conv and \
                        all(r.effective in impls for r in conv) and \
                        not row.note:
                    findings.append(error(
                        "audit.plan.annotation", f"{where}/{site}",
                        f"site never dispatches under the fused conv "
                        f"impls but its plan row carries no {what} "
                        f"annotation: the reported plan claims an impl "
                        f"that never runs"))

            if smem and cfg.policy.backend == "cuda":
                needs = site_smem(cfg, batch)
                for site, need in sorted(needs.items()):
                    if need > MAX_SMEM:
                        findings.append(warning(
                            "audit.plan.smem", f"{where}/{site}",
                            f"a launch asks for {need} bytes of dynamic "
                            f"shared memory, over the {MAX_SMEM} a block "
                            f"of the card may have, at batch={batch}: the "
                            f"launch would be refused"))
                if needs:
                    site, need = max(needs.items(), key=lambda kv: kv[1])
                    findings.append(info(
                        "audit.plan.smem", where,
                        f"largest dynamic shared memory of a launch: "
                        f"{need} bytes ({site}) at batch={batch}"))
            findings.append(info(
                "audit.plan", where,
                f"{len(rows)} sites resolved, "
                f"{sum(1 for r in rows if r.note)} annotated"))
    if not smem:
        findings.append(info("audit.plan.smem", "not-run",
                             f"shared memory not read: {why_not}"))
    return findings


# ---------------------------------------------------------------------------
# Serving-cache audit: slot-axis consistency, shape-only
# ---------------------------------------------------------------------------

def audit_serving_caches(arch_names: Sequence[str] | None = None, *,
                         slots: int = 4, max_seq: int = 32) -> list[Finding]:
    """Check ``init_cache`` / ``cache_batch_axes`` / ``reset_cache_slots``
    agree on every leaf's slot axis, for every (reduced) registered arch,
    with and without the spiking-LM LIF state. On ``meta`` tensors: nothing
    is allocated."""
    import torch

    from repro_torch.configs.registry import ASSIGNED, get_config, reduced
    from repro_torch.core.lif import LIFConfig
    from repro_torch.core.spikingformer import tree_leaves, tree_paths
    from repro_torch.models import lm

    findings: list[Finding] = []
    names = list(arch_names if arch_names is not None else ASSIGNED)
    for name in names:
        base = reduced(get_config(name))
        if base.family in _SKIP_CACHE_FAMILIES:
            findings.append(info("audit.serving.cache", name,
                                 f"family {base.family!r} has no decode "
                                 f"slot cache; skipped"))
            continue
        for cfg, tag in ((base, name),
                         (base.replace(lif=LIFConfig()), f"{name}+lif")):
            try:
                cache = lm.init_cache(cfg, slots, max_seq, torch.float32,
                                      device="meta")
                axes = lm.cache_batch_axes(cfg, cache)
                if tree_paths(axes) != tree_paths(cache):
                    findings.append(error(
                        "audit.serving.cache", tag,
                        "cache_batch_axes returns a different tree "
                        "structure than init_cache"))
                    continue
                bad = [(path, tuple(leaf.shape), ax)
                       for path, leaf, ax in zip(tree_paths(cache),
                                                 tree_leaves(cache),
                                                 tree_leaves(axes))
                       if not (0 <= ax < leaf.ndim
                               and leaf.shape[ax] == slots)]
                for path, shape, ax in bad:
                    findings.append(error(
                        "audit.serving.cache", f"{tag}/{path}",
                        f"declared slot axis {ax} of shape {shape} does "
                        f"not hold {slots} slots: reset_cache_slots "
                        f"would zero the wrong dimension"))
                mask = torch.empty(slots, dtype=torch.bool, device="meta")
                after = lm.reset_cache_slots(cache, mask, cfg)
                same = tree_paths(after) == tree_paths(cache) and all(
                    a.shape == b.shape and a.dtype == b.dtype
                    for a, b in zip(tree_leaves(after), tree_leaves(cache)))
                if not same:
                    findings.append(error(
                        "audit.serving.cache", tag,
                        "reset_cache_slots does not preserve the cache's "
                        "structure/shapes/dtypes"))
                if not bad and same:
                    findings.append(info(
                        "audit.serving.cache", tag,
                        f"{len(tree_leaves(cache))} leaves consistent"))
            except Exception as e:   # noqa: BLE001 - report, don't crash
                findings.append(error("audit.serving.cache", tag,
                                      f"cache construction failed: {e!r}"))
    return findings


# ---------------------------------------------------------------------------
# Tuned-block table audit: key validation against the kernel registry
# ---------------------------------------------------------------------------

def audit_tuned_table(path: str | None = None) -> list[Finding]:
    """Validate a tuned-block table (``repro_torch.tune.table``) key by key.

    ``path=None`` audits the active table (``$REPRO_TORCH_TUNED_BLOCKS`` or
    the repo default); no active table is an info, not an error. Every entry
    must name a site the site-key registry knows, a registered ``(op,
    impl)`` that has block knobs (``repro_torch.tune.workloads.
    TUNABLE_IMPLS``), a well-formed shape, a valid arm, blocks that are a
    tile of the spike matmul kernel, and, when marked packed, a contraction
    dim honouring the % 8 packing contract. A version mismatch is an error
    here (dispatch merely ignores such tables).
    """
    import json as _json
    import pathlib

    from repro_torch.core.policy import OPS, available_impls, known_site_keys
    from repro_torch.tune.table import (ARMS, TABLE_VERSION, TunedBlocks,
                                        parse_key, table_path)
    from repro_torch.tune.workloads import TUNABLE_IMPLS

    p = pathlib.Path(path) if path is not None else table_path()
    if p is None:
        return [info("audit.tune.table", "-",
                     "no tuned-block table active; kernel defaults apply")]
    try:
        raw = _json.loads(p.read_text())
    except (OSError, _json.JSONDecodeError) as e:
        return [error("audit.tune.table", str(p), f"unreadable table: {e}")]
    if raw.get("version") != TABLE_VERSION:
        return [error("audit.tune.table", str(p),
                      f"version {raw.get('version')!r} unsupported "
                      f"(expected {TABLE_VERSION}); dispatch would ignore "
                      f"this table entirely")]
    findings: list[Finding] = []
    sites = known_site_keys()
    bad = 0
    for key, entry in sorted(raw.get("entries", {}).items()):
        where = f"{p.name}/{key}"
        try:
            _, site, op, impl, shape, packed = parse_key(key)
        except ValueError as e:
            findings.append(error("audit.tune.table", where, str(e)))
            bad += 1
            continue
        problems = []
        if site not in sites:
            problems.append(f"unknown site {site!r} (stale key?)")
        if op not in OPS:
            problems.append(f"unknown op {op!r}")
        elif impl not in available_impls(op):
            problems.append(f"impl {impl!r} not registered for op {op!r}")
        elif (op, impl) not in TUNABLE_IMPLS:
            problems.append(f"({op}, {impl}) has no block knobs: the entry "
                            f"can never be consulted")
        if not shape or any(d <= 0 for d in shape):
            problems.append(f"malformed shape {shape}")
        elif packed and len(shape) >= 2 and shape[-2] % 8 != 0:
            problems.append(f"packed entry but contraction dim "
                            f"{shape[-2]} % 8 != 0")
        arm = entry.get("arm")
        if arm is not None and arm not in ARMS:
            problems.append(f"unknown arm {arm!r}")
        blocks_ok = True
        for name in ("block_m", "block_k", "block_c"):
            v = entry.get(name)
            if v is not None and (not isinstance(v, int) or v <= 0):
                problems.append(f"{name}={v!r} is not a positive int")
                blocks_ok = False
        if blocks_ok:
            try:
                TunedBlocks(**{n: entry.get(n) for n in
                               ("block_m", "block_k", "block_c")}).tile()
            except ValueError as e:
                problems.append(str(e))
        for msg in problems:
            findings.append(error("audit.tune.table", where, msg))
        bad += bool(problems)
    n = len(raw.get("entries", {}))
    findings.append(info("audit.tune.table", str(p),
                         f"{n} entries, {bad} invalid"))
    return findings


# ---------------------------------------------------------------------------
# Mesh audit: describe_execution on the mesh shapes the ranks can hold
# ---------------------------------------------------------------------------

def audit_mesh_plans(presets: Sequence[str] | None = None,
                     mesh_shapes: Iterable[tuple[int, int]] = ((1, 1),
                                                               (2, 4)),
                     ) -> list[Finding]:
    """``describe_execution(mesh)`` must render (dispatch and sharding
    tables) for every preset on every (data, model) mesh shape that the
    ranks of the running process group can hold. Where no group runs, a
    world of 1 over gloo is started for the audit and shut down after
    it."""
    import torch.distributed as dist

    from repro_torch.configs.spikingformer import (SPIKINGFORMER_PRESETS,
                                                   get_spikingformer_config)
    from repro_torch.launch.mesh import (init_distributed, make_test_mesh,
                                         shutdown_distributed)

    presets = list(presets if presets is not None
                   else sorted(SPIKINGFORMER_PRESETS))
    started = not dist.is_initialized()
    if started:
        init_distributed("cpu")
    findings: list[Finding] = []
    try:
        world = dist.get_world_size()
        for data, model in mesh_shapes:
            if data * model != world:
                findings.append(info(
                    "audit.mesh.describe", f"mesh=({data},{model})",
                    f"skipped: needs {data * model} ranks, the process "
                    f"group has {world}"))
                continue
            mesh = make_test_mesh(data, model)
            for preset in presets:
                where = f"{preset}/mesh=({data},{model})"
                try:
                    out = get_spikingformer_config(preset) \
                        .describe_execution(mesh)
                    if "Sharding plan" not in out or "site,op" not in out:
                        findings.append(error(
                            "audit.mesh.describe", where,
                            "describe_execution(mesh) rendered without the "
                            "dispatch or sharding table"))
                    else:
                        findings.append(info(
                            "audit.mesh.describe", where,
                            f"{len(out.splitlines())} lines"))
                except Exception as e:   # noqa: BLE001 - report, don't crash
                    findings.append(error("audit.mesh.describe", where,
                                          f"describe_execution failed: "
                                          f"{e!r}"))
    finally:
        if started:
            shutdown_distributed()
    return findings


def audit_breaker() -> list[Finding]:
    """Every circuit-breaker trip in this process (``audit.breaker``), one
    warning each: a tripped site took an injected ``chaos.kernel`` fault
    and the run served its eager arm from then on
    (``core.policy.dispatch_site``). Empty when no site tripped, as in a
    fresh process; an audit in the process after a training or serving run
    shows the demotions beside the plan's findings."""
    from repro_torch.core.policy import breaker_trips

    return [warning("audit.breaker", site,
                    f"impl {t.impl!r} (op {t.op}) tripped -> {t.fallback!r}: "
                    f"{t.error}")
            for site, t in sorted(breaker_trips().items())]


def run_audit(*, batch: int = 1,
              presets: Sequence[str] | None = None,
              policies: Mapping[str, object] | None = None,
              arch_names: Sequence[str] | None = None) -> list[Finding]:
    """The full static audit (plans, serving caches, tuned table, mesh
    renders and circuit-breaker trips)."""
    return (audit_spikingformer_plans(presets, policies, batch=batch)
            + audit_serving_caches(arch_names)
            + audit_tuned_table()
            + audit_mesh_plans(presets)
            + audit_breaker())
