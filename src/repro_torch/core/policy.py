"""Execution policy + per-site kernel registry for the Spikingformer port.

The counterpart of :mod:`repro.core.policy`, with the same two pieces:

* :class:`ExecutionPolicy` — a frozen, hashable value holding a default
  ``backend`` and a canonical tuple of per-site implementation overrides,
  e.g.::

      ExecutionPolicy(backend="cuda",
                      overrides={"pssa.qkv": "cuda+spike_mm",
                                 "attn_qk": "cuda_packed",
                                 "tokenizer.bn": "eager"})

* a **kernel registry** keyed ``(op, impl)``. Op and site names are the
  reference's, letter for letter; implementation and policy names map one
  to one through :data:`IMPL_FROM_JAX` / :data:`POLICY_FROM_JAX`.

Resolution precedence for ``resolve(site, op)``:

1. an override keyed by the exact *site* name (``"pssa.qkv"``),
2. an override keyed by a dotted *group prefix* of the site
   (``"tokenizer.conv"`` covers every per-stage ``"tokenizer.conv.<i>"``
   site; nearest prefix wins),
3. an override keyed by the *op* name (``"linear_bn"``),
4. the backend's default implementation for the op.

Packing constraints (the bit-packed spike kernels need their contraction
dim to be a multiple of 8, and a spike-valued operand) are resolved **once,
at policy-validation time** via :func:`plan_sites`. Those demotions are
decisions taken from shapes, not error handling: this module has no circuit
breaker, and :func:`dispatch_kernel` calls the resolved implementation and
lets it raise.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Callable, Iterable, Mapping, Sequence

from repro_torch.core.backend import BACKENDS, validate_backend

logger = logging.getLogger("repro_torch.execution")

#: Reference (JAX package) implementation name -> the port's name.
IMPL_FROM_JAX: dict[str, str] = {
    "jnp": "eager",
    "pallas": "cuda",
    "pallas+spike_mm": "cuda+spike_mm",
    "pallas_packed": "cuda_packed",
    "fused_epilogue": "fused_epilogue",
}

#: Reference named policy -> the port's named policy.
POLICY_FROM_JAX: dict[str, str] = {
    "jnp": "eager", "pallas": "cuda", "pallas-full": "cuda-full"}

#: The abstract op kinds the model dispatches through (a *site* is a named
#: instance of one of these, e.g. site "pssa.qkv" has op "linear_bn").
#: "lif_state" is the state-carrying LIF of temporal tiling and of the LM's
#: decode step (``lif_decode_step``); its kernels are the SOMA/GRAD pair.
OPS: tuple[str, ...] = ("lif", "lif_state", "bn", "linear_bn", "attn_qk",
                        "attn_av", "conv")

# Per-backend default implementation for each op. The attention einsums and
# the tokenizer conv stay on their dense defaults even under backend="cuda"
# (packed attention and the fused im2col tokenizer conv are opt-in via the
# "cuda-full" policy), exactly as in the reference.
_DEFAULT_IMPL: dict[tuple[str, str], str] = {
    ("lif", "eager"): "eager", ("lif", "cuda"): "cuda",
    ("lif_state", "eager"): "eager", ("lif_state", "cuda"): "cuda",
    ("bn", "eager"): "eager", ("bn", "cuda"): "cuda",
    ("linear_bn", "eager"): "eager", ("linear_bn", "cuda"): "cuda",
    ("attn_qk", "eager"): "eager", ("attn_qk", "cuda"): "eager",
    ("attn_av", "eager"): "eager", ("attn_av", "cuda"): "eager",
    ("conv", "eager"): "eager", ("conv", "cuda"): "eager",
}

#: impl -> fallback impl used when a site's packing constraint
#: (contraction dim % 8 == 0, spike-valued operand) cannot be met.
PACKED_IMPL_FALLBACK: dict[str, str] = {
    "cuda+spike_mm": "cuda",   # dense matmul + BN
    "cuda_packed": "eager",    # plain einsum
}

#: (op, impl) -> fallback, consulted before the impl-keyed table. The
#: packed tokenizer conv demotes to the *dense im2col* arm of the fused
#: conv+BN+LIF pipeline, not all the way to the eager reference conv.
_PACKED_OP_FALLBACK: dict[tuple[str, str], str] = {
    ("conv", "cuda_packed"): "cuda",
}


def packed_fallback(op: str, impl: str) -> str | None:
    """The dense fallback for a packed implementation at ``op`` (``None``
    when ``impl`` has no packing constraint)."""
    return _PACKED_OP_FALLBACK.get((op, impl), PACKED_IMPL_FALLBACK.get(impl))


#: Implementations that run the single-launch neuron-layer kernel (matmul +
#: BN + SOMA in one launch). Packing constraints do NOT demote these — the
#: kernel has a dense arm. What does demote them is the site itself: a
#: ``linear_bn`` site with no trailing LIF has no SOMA to fuse.
FUSED_EPILOGUE_IMPLS: frozenset[str] = frozenset({"fused_epilogue"})

#: (op, impl) -> demotion target at sites that structurally cannot host the
#: fused epilogue (no trailing LIF).
_FUSED_EPILOGUE_FALLBACK: dict[tuple[str, str], str] = {
    ("linear_bn", "fused_epilogue"): "cuda+spike_mm",
}


def fused_epilogue_fallback(op: str, impl: str) -> str | None:
    """The pipeline (multi-launch) fallback for a fused-epilogue impl at a
    site with no trailing LIF (``None`` when ``impl`` is not one)."""
    return _FUSED_EPILOGUE_FALLBACK.get((op, impl))


def default_impl(op: str, backend: str) -> str:
    try:
        return _DEFAULT_IMPL[(op, validate_backend(backend))]
    except KeyError:
        raise ValueError(f"unknown op {op!r}; expected one of {OPS}") from None


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """Hashable execution policy: default backend + per-site overrides.

    ``overrides`` accepts a mapping or an iterable of ``(key, impl)`` pairs
    (keys are site names or op names) and is canonicalized to a sorted tuple
    so equal policies compare and hash equal.
    """

    backend: str = "eager"
    overrides: tuple[tuple[str, str], ...] = ()
    #: Validate override keys against the registered site tables at
    #: construction (``strict=False`` admits site names of models this
    #: process never imports). Excluded from eq/hash.
    strict: bool = dataclasses.field(default=True, compare=False)

    def __post_init__(self):
        validate_backend(self.backend)
        ov = self.overrides
        if isinstance(ov, Mapping):
            ov = ov.items()
        object.__setattr__(
            self, "overrides",
            tuple(sorted((str(k), str(v)) for k, v in ov)))
        if self.strict:
            _validate_override_keys(self.overrides)

    def resolve(self, site: str, op: str) -> str:
        """Implementation name for ``site`` (an instance of ``op``): the
        exact site name first, then each dotted group prefix, then the op
        name, then the backend default."""
        ov = dict(self.overrides)
        key = site
        while True:
            impl = ov.get(key)
            if impl is not None:
                return impl
            if "." not in key:
                break
            key = key.rsplit(".", 1)[0]
        impl = ov.get(op)
        if impl is None:
            impl = default_impl(op, self.backend)
        return impl

    def with_sites(self, sites: Mapping[str, str | None]) -> "ExecutionPolicy":
        """New policy with ``sites`` merged in (``None`` removes a key)."""
        ov = dict(self.overrides)
        for k, v in sites.items():
            if v is None:
                ov.pop(k, None)
            else:
                ov[k] = v
        return dataclasses.replace(self, overrides=tuple(ov.items()))

    def describe(self, site_specs: Sequence[tuple] | None = None, *,
                 rows: Sequence["SiteDecision"] | None = None) -> str:
        """Human-readable per-site dispatch table (see the reference's
        ``ExecutionPolicy.describe``): op-level defaults without arguments,
        the effective implementation per model site with ``site_specs``, or
        already-resolved ``rows``."""
        if rows is None:
            if site_specs is None:
                site_specs = [(op, op, None) for op in OPS]
            rows = plan_sites(self, site_specs, check_registry=False)
        lines = [f"# ExecutionPolicy backend={self.backend}",
                 "site,op,requested,effective,note"]
        for r in rows:
            lines.append(f"{r.site},{r.op},{r.requested},{r.effective},"
                         f"{r.note}")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class SiteDecision:
    """One row of a resolved execution plan. ``expected`` marks a
    *structural* demotion the model shape dictates by design — reported at
    INFO, unlike constraint violations (ragged pack dims), which warn."""

    site: str
    op: str
    requested: str
    effective: str
    note: str = ""
    expected: bool = False


def plan_sites(policy: ExecutionPolicy,
               site_specs: Sequence[tuple],
               *, check_registry: bool = True) -> list[SiteDecision]:
    """Resolve every site once and report packing/fusion fallbacks.

    ``site_specs`` is a sequence of ``(site, op, pack_dim)``, ``(site, op,
    pack_dim, spike_operand)`` or ``(site, op, pack_dim, spike_operand,
    trailing_lif)``, with the reference's meaning: a packed impl with a
    float operand demotes to its dense fallback as an *expected* decision;
    one whose ``pack_dim % 8 != 0`` resolves to the same fallback as a
    reported constraint violation; a fused-epilogue impl at a
    no-trailing-LIF site demotes to its pipeline fallback (expected) and at
    servable sites never demotes for packing — the note records the dense
    arm.

    With ``check_registry=True`` every effective implementation must exist
    in the registry, and every override key must match a planned site, a
    dotted group prefix of one, or a known op name.
    """
    rows = []
    for spec in site_specs:
        site, op, dim = spec[0], spec[1], spec[2]
        spike_operand = spec[3] if len(spec) > 3 else True
        trailing_lif = spec[4] if len(spec) > 4 else True
        requested = policy.resolve(site, op)
        effective, notes, violation = requested, [], False
        ffb = fused_epilogue_fallback(op, requested)
        if ffb is not None and not trailing_lif:
            effective = ffb
            notes.append(f"no trailing LIF at this site -> {ffb}")
        fb = packed_fallback(op, effective)
        if fb is not None:
            if not spike_operand:
                effective = fb
                notes.append(f"float (non-spike) operand -> {fb}")
            elif dim is not None and dim % 8 != 0:
                effective = fb
                notes.append(f"pack dim {dim} % 8 != 0 -> {fb}")
                violation = True
        elif effective in FUSED_EPILOGUE_IMPLS:
            if not spike_operand:
                notes.append("float (non-spike) operand -> dense arm "
                             "(still fused)")
            elif dim is not None and dim % 8 != 0:
                notes.append(f"pack dim {dim} % 8 != 0 -> dense arm "
                             f"(still fused)")
                violation = True
        note = "; ".join(notes)
        expected = bool(notes) and not violation
        if check_registry:
            get_kernel(op, effective)   # raises on unknown impl
        rows.append(SiteDecision(site, op, requested, effective, note,
                                 expected))
    if check_registry:
        sites = {spec[0] for spec in site_specs}
        known = sites | set(OPS)

        def matches(key: str) -> bool:
            return key in known or any(s.startswith(key + ".")
                                       for s in sites)

        unmatched = [k for k, _ in policy.overrides if not matches(k)]
        if unmatched:
            raise ValueError(
                f"policy overrides {unmatched} match no site, site group or "
                f"op; sites: {sorted(sites)}, ops: {OPS}")
    return rows


_reported_fallbacks: set[tuple[str, str]] = set()


def log_fallbacks(rows: Iterable[SiteDecision]) -> None:
    """Report (once per site+note) every site whose requested impl was
    replaced at validation time: violations warn, expected structural
    demotions log at INFO."""
    for r in rows:
        if r.note and (r.site, r.note) not in _reported_fallbacks:
            _reported_fallbacks.add((r.site, r.note))
            log = logger.info if r.expected else logger.warning
            log("execution policy: site %s requested %r but %s",
                r.site, r.requested, r.note)


def runtime_fallback(site: str, impl: str, reason: str,
                     expected: bool = False) -> None:
    """Log (once per site+reason) a per-call, shape-driven demotion that a
    layer called directly takes on its own (the plan reports the same
    decision for a whole model)."""
    key = (site, reason)
    if key not in _reported_fallbacks:
        _reported_fallbacks.add(key)
        log = logger.info if expected else logger.warning
        log("execution policy: site %s impl %r fell back at call "
            "time: %s", site, impl, reason)


def dispatch_kernel(site: str, op: str, impl: str, *args: Any) -> Any:
    """Call the registered ``(op, impl)`` implementation with ``*args``.
    An implementation that raises, raises: nothing is demoted here."""
    return get_kernel(op, impl)(*args)


# ---------------------------------------------------------------------------
# Kernel registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[tuple[str, str], Callable[..., Any]] = {}


def register_kernel(op: str, impl: str) -> Callable:
    """Decorator: register ``fn`` as the ``impl`` implementation of ``op``.

    Signatures by op (``policy``/``site`` always ride along so nested ops
    can resolve through the same policy):

    * ``lif``:       ``fn(x_seq, cfg: LIFConfig, site) -> spikes``
    * ``lif_state``: ``fn(x_seq, u0, s0, cfg: LIFConfig, site)
                      -> (spikes, (u, s))``
    * ``bn``:        ``fn(params, state, x, train, momentum, eps, policy,
                      site) -> (y, state)``
    * ``linear_bn``: ``fn(params, state, x, train, policy, site)
                      -> (y, state)``
    * ``attn_qk``:   ``fn(q, k, policy, site) -> attn``  (T,B,h,N,M)
    * ``attn_av``:   ``fn(attn, v, policy, site) -> out`` (T,B,h,N,dh)
    * ``conv``:      ``fn(params, state, x, lif_cfg, train, spike_in,
                      policy, site) -> (spikes, new_state)`` — one full
                      eq. 4 tokenizer stage on a time-major (T, B, H, W, C)
                      input

    Exception: the ``"fused_epilogue"`` implementation of ``linear_bn``
    absorbs the *following* SN, so it is registered with the extended
    signature ``fn(params, state, x, lif_cfg, train, policy, site) ->
    (spikes, new_state)`` and is only dispatched through
    ``linear_bn_lif_apply``.
    """
    def deco(fn: Callable) -> Callable:
        _REGISTRY[(op, impl)] = fn
        return fn
    return deco


def unregister_kernel(op: str, impl: str) -> None:
    _REGISTRY.pop((op, impl), None)


def available_impls(op: str) -> tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(i for (o, i) in _REGISTRY if o == op))


def get_kernel(op: str, impl: str) -> Callable[..., Any]:
    """Look up the registered implementation, importing the builtins first."""
    _ensure_builtins()
    try:
        return _REGISTRY[(op, impl)]
    except KeyError:
        raise KeyError(
            f"no implementation {impl!r} registered for op {op!r}; "
            f"available: {available_impls(op)}") from None


def registered_kernels() -> tuple[tuple[str, str], ...]:
    """Every registered ``(op, impl)`` pair, builtins imported."""
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def _ensure_builtins() -> None:
    # The builtin implementations register themselves at import time; pull
    # them in lazily so policy.py never imports the model modules at load
    # (they import *us*).
    import repro_torch.core.spikingformer  # noqa: F401  (lif + layers too)


# ---------------------------------------------------------------------------
# Site-table registry (construction-time override validation)
# ---------------------------------------------------------------------------

_SITE_TABLES: dict[str, frozenset[str]] = {}
_SITE_GROUPS: dict[str, frozenset[str]] = {}
_site_tables_loading = False
_site_tables_loaded = False


def register_site_table(model: str, sites: Iterable[str],
                        groups: Iterable[str] = ()) -> None:
    """Declare a model family's site names (plus any group prefixes that
    are valid override keys on their own, e.g. ``"tokenizer.conv"``)."""
    _SITE_TABLES[str(model)] = frozenset(str(s) for s in sites)
    _SITE_GROUPS[str(model)] = frozenset(str(g) for g in groups)


def site_tables() -> dict[str, frozenset[str]]:
    """``model -> registered site names`` (builtin tables imported first)."""
    _ensure_site_tables()
    return dict(_SITE_TABLES)


def known_site_keys() -> frozenset[str]:
    """Every valid non-op override key: registered site names, declared
    groups, and every dotted prefix of a registered site."""
    _ensure_site_tables()
    keys: set[str] = set()
    for sites in _SITE_TABLES.values():
        for s in sites:
            keys.add(s)
            while "." in s:
                s = s.rsplit(".", 1)[0]
                keys.add(s)
    for groups in _SITE_GROUPS.values():
        keys.update(groups)
    return frozenset(keys)


def _ensure_site_tables() -> None:
    # The loading flag is a re-entrancy guard: policies constructed *during*
    # these imports skip validation instead of seeing a partial registry.
    global _site_tables_loading, _site_tables_loaded
    if _site_tables_loaded or _site_tables_loading:
        return
    _site_tables_loading = True
    try:
        import repro_torch.core.spikingformer  # noqa: F401  "spikingformer"
        import repro_torch.models.lm           # noqa: F401  "lm" table
    finally:
        _site_tables_loading = False
    _site_tables_loaded = True


def _validate_override_keys(overrides: tuple[tuple[str, str], ...]) -> None:
    site_keyed = [k for k, _ in overrides if k not in OPS]
    if not site_keyed or _site_tables_loading:
        return
    known = known_site_keys()
    groups = frozenset().union(*_SITE_GROUPS.values()) if _SITE_GROUPS \
        else frozenset()
    unknown = [k for k in site_keyed
               if k not in known
               and not any(k.startswith(g + ".") for g in groups)]
    if unknown:
        raise ValueError(
            f"ExecutionPolicy overrides {unknown} name no registered site, "
            f"site group or op. Known sites: "
            f"{ {m: sorted(s) for m, s in sorted(_SITE_TABLES.items())} }, "
            f"ops: {OPS}. Pass strict=False for forward-compat site names.")


# ---------------------------------------------------------------------------
# Named policies + environment default
# ---------------------------------------------------------------------------

#: Everything-on policy: the LIF kernel, the packed Q K^T (and, where the
#: token count allows, packed (attn) V) path, and the single-launch
#: neuron-layer kernel at every Conv1DBN-with-SN site and every eq. 4
#: tokenizer stage. Sites with no trailing LIF (Z projection, SMLP-B) demote
#: to the pipeline ``cuda+spike_mm`` arm as a planned structural decision.
_CUDA_FULL = ExecutionPolicy(
    backend="cuda",
    overrides=(("attn_av", "cuda_packed"), ("attn_qk", "cuda_packed"),
               ("conv", "fused_epilogue"), ("linear_bn", "fused_epilogue")))

NAMED_POLICIES: dict[str, ExecutionPolicy] = {
    "eager": ExecutionPolicy(),
    "cuda": ExecutionPolicy(backend="cuda"),
    "cuda-full": _CUDA_FULL,
}


def list_named_policies() -> list[str]:
    return sorted(NAMED_POLICIES)


def named_policy(name: str) -> ExecutionPolicy:
    """Resolve a policy preset name (``eager``/``cuda``/``cuda-full``)."""
    try:
        return NAMED_POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; expected one of "
                         f"{list_named_policies()}") from None


def default_policy() -> ExecutionPolicy:
    """Process-wide default policy, read live from ``REPRO_BACKEND`` (which
    takes the port's policy names here)."""
    return named_policy(os.environ.get("REPRO_BACKEND", "eager"))


__all__ = [
    "BACKENDS", "ExecutionPolicy", "FUSED_EPILOGUE_IMPLS", "IMPL_FROM_JAX",
    "NAMED_POLICIES", "OPS", "POLICY_FROM_JAX", "SiteDecision",
    "available_impls", "default_impl", "default_policy", "dispatch_kernel",
    "fused_epilogue_fallback", "get_kernel", "known_site_keys",
    "list_named_policies", "log_fallbacks", "named_policy",
    "packed_fallback", "plan_sites", "register_kernel",
    "register_site_table", "registered_kernels", "runtime_fallback",
    "site_tables", "unregister_kernel",
]
