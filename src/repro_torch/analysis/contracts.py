"""Kernel-contract verifier (the counterpart of
``repro.analysis.contracts``): coverage, reference parity, launch limits,
autograd cotangents and config hashing, without running a kernel.

The plan auditor (``audit.py``) checks *which* kernel runs where; this
module checks the kernels themselves. Every kernel wrapper of the port
declares a :class:`~repro_torch.kernels.contract.KernelContract` (builder,
oracle, the ``(op, impl)`` pairs it serves); the verifier walks the preset x
policy x site matrix (geometries from
:func:`repro_torch.tune.workloads.kernel_shape_cases`) and checks five
families:

* ``audit.kernel.coverage``: every registered (op, impl) pair that is not
  exempt (``CONTRACT_EXEMPT_IMPLS``) is served by a declaration, no
  declaration serves a pair that is not registered, and the ``serves`` of
  each kernel's declarations add up to its row of
  ``repro_torch.kernels.KERNELS``.
* ``audit.kernel.parity``: at every site geometry the wrapper's output
  shapes and dtypes equal its oracle's (``kernels/ref.py``), on ``meta``
  tensors, where the wrapper allocates its kernel's outputs by its shape
  rule (the dry run counts the same); the kernel's own values are held
  against the oracles on the card (``chip_smoke.py``'s
  ``analysis`` phase, ``tests/test_torch_cuda.py``).
* ``audit.kernel.launch``: on the card, the launches each case would make,
  read from the library's plan exports (``csrc/launch_plan.cuh``) while the
  wrapper runs on zero-filled CUDA operands inside
  ``build.plan_launches()``, against the H100's limits: grid.x at most
  2^31 - 1 and grid.y, grid.z at most 65,535 blocks, no empty grid, the
  blocks times the tile covering the output and no row or column of blocks
  wholly outside it, at most 1,024 threads a block, at most 232,448 bytes
  (227 KB) of dynamic shared memory, and above 48 KB the opt-in call
  first. The reference's BlockSpec, grid and VMEM checks become these. No
  kernel is launched. Without a CUDA device the family does not run and
  says so in one ``info`` row; it never passes in silence.
* ``audit.kernel.vjp``: every ``torch.autograd.Function`` of
  ``kernels/ops.py`` and ``core/lif.py``'s ``_Fire`` runs forward and its
  own ``backward`` (called directly, so that autograd's casts and checks do
  not hide a fault) on ``meta`` tensors at fp32 and bf16; each cotangent
  must have its primal's shape and dtype.
* ``audit.trace.registry``: policy-equivalent spellings of each preset x
  named policy, and repeated lookups of each registry config and its
  ``reduced()``, compare and hash equal (the train and serve steps key
  their plans and tuned tables on the config).

No family launches a kernel.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.report import Finding, error, info

#: The H100's limits a launch is held to (CUDA's grid limits; the
#: per-block opt-in shared memory of compute capability 9.0).
MAX_GRID = (2 ** 31 - 1, 65535, 65535)
MAX_THREADS = 1024
MAX_BLOCK = (1024, 1024, 64)
MAX_SMEM = 232448
DEFAULT_SMEM = 48 * 1024

#: Geometry of the autograd checks (the reference's ``_VJP_GEOM``).
_VJP_GEOM = {"t": 2, "m": 16, "c": 16, "k": 16, "g": 2}

_VJP_DTYPES = ("float32", "bfloat16")


def _avals(tree) -> list[tuple[tuple[int, ...], torch.dtype]]:
    leaves = tree if isinstance(tree, (tuple, list)) else (tree,)
    return [(tuple(t.shape), t.dtype) for t in leaves
            if isinstance(t, torch.Tensor)]


def _aval_str(avals) -> str:
    return ", ".join(f"{str(dt).removeprefix('torch.')}{list(sh)}"
                     for sh, dt in avals)


# ---------------------------------------------------------------------------
# audit.kernel.coverage
# ---------------------------------------------------------------------------

def _contract_index():
    """(op, impl) -> [KernelContract], plus the declaration dict."""
    from repro_torch.kernels.contract import kernel_contracts

    decls = kernel_contracts()
    by_pair: dict[tuple[str, str], list] = {}
    for decl in decls.values():
        for pair in decl.serves:
            by_pair.setdefault(pair, []).append(decl)
    return decls, by_pair


def audit_kernel_coverage() -> list[Finding]:
    """Every registered non-exempt (op, impl) pair has a declaration, every
    declaration serves only registered pairs and names a kernel of
    ``KERNELS``, and each kernel's declarations serve its ``KERNELS``
    row's pairs, no more and no fewer."""
    from repro_torch.core.policy import (CONTRACT_EXEMPT_IMPLS,
                                         registered_kernels)
    from repro_torch.kernels import KERNELS

    decls, by_pair = _contract_index()
    registered = set(registered_kernels())
    out: list[Finding] = []
    for op, impl in sorted(registered):
        if impl not in CONTRACT_EXEMPT_IMPLS and (op, impl) not in by_pair:
            out.append(error(
                "audit.kernel.coverage", f"{op}/{impl}",
                "registered implementation has no KernelContract "
                "declaration (repro_torch.kernels.contract): its launches, "
                "autograd and reference parity are unverified"))
    served: dict[str, set] = {name: set() for name in KERNELS}
    for name, decl in sorted(decls.items()):
        for pair in decl.serves:
            if pair not in registered:
                out.append(error(
                    "audit.kernel.coverage", name,
                    f"declaration serves unregistered pair {pair!r}"))
        if decl.kernel not in KERNELS:
            out.append(error(
                "audit.kernel.coverage", name,
                f"declaration names {decl.kernel!r}, no kernel of KERNELS"))
        else:
            served[decl.kernel].update(decl.serves)
    for kernel, row in sorted(KERNELS.items()):
        want = set(row["serves"])
        if served[kernel] != want:
            out.append(error(
                "audit.kernel.coverage", kernel,
                f"the declarations serve {sorted(served[kernel])}, KERNELS "
                f"says {sorted(want)}"))
    out.append(info("audit.kernel.coverage", "registry",
                    f"{len(registered)} registered pairs, {len(decls)} "
                    f"declarations of {len(KERNELS)} kernels"))
    return out


# ---------------------------------------------------------------------------
# audit.kernel.parity
# ---------------------------------------------------------------------------

def check_parity_contract(decl, args: tuple, ref_kwargs: dict, out,
                          where: str) -> list[Finding]:
    try:
        ref_out = decl.ref(*args, **ref_kwargs)
    except Exception as e:   # noqa: BLE001 - report, don't crash
        return [error("audit.kernel.parity", where,
                      f"reference {decl.ref.__name__} failed on meta "
                      f"operands: {e!r}")]
    got, want = _avals(out), _avals(ref_out)
    if got != want:
        return [error(
            "audit.kernel.parity", where,
            f"kernel outputs [{_aval_str(got)}] != reference "
            f"{decl.ref.__name__} outputs [{_aval_str(want)}]")]
    return []


# ---------------------------------------------------------------------------
# audit.kernel.launch
# ---------------------------------------------------------------------------

def launch_family_unavailable() -> str | None:
    """Why the launch family cannot run here (None: it can)."""
    if not torch.cuda.is_available():
        return ("no CUDA device (torch.cuda.is_available() is False): the "
                "launches are read from the built library on the card")
    return None


def read_launches(decl, args: tuple, fn_kwargs: dict) -> list:
    """The plan reader: the entry-point calls (``build.PlannedCall``) that
    ``decl.fn`` makes on zero-filled CUDA copies of the ``meta`` operands
    ``args``, read inside ``build.plan_launches()``, which launches nothing
    and leaves the kernels' launch counts as they were."""
    from repro_torch.kernels import build

    dev = torch.device("cuda", torch.cuda.current_device())
    cuda_args = tuple(
        torch.zeros(a.shape, dtype=a.dtype, device=dev)
        if isinstance(a, torch.Tensor) else a for a in args)
    with build.plan_launches() as calls:
        decl.fn(*cuda_args, **fn_kwargs)
    return calls


def check_launch(launch, where: str) -> list[Finding]:
    """One launch against the card's limits and its output extents."""
    out: list[Finding] = []

    def bad(msg: str) -> None:
        out.append(error("audit.kernel.launch", where, msg))

    for a, (g, cap) in enumerate(zip(launch.grid, MAX_GRID)):
        name = "xyz"[a]
        if g < 1:
            bad(f"empty grid: grid.{name} = {g} for a non-empty operand")
        elif g > cap:
            bad(f"grid.{name} = {g} blocks exceeds the card's {cap}")
        tile, extent = launch.tile[a], launch.extent[a]
        if tile <= 0:
            if g > 1:
                bad(f"grid.{name} = {g} blocks along an axis that cuts no "
                    f"output")
            continue
        if not launch.strided[a] and g * tile < extent:
            bad(f"grid.{name}: {g} blocks of {tile} cover {g * tile} of an "
                f"extent of {extent}")
        if (g - 1) * tile >= extent:
            bad(f"grid.{name}: the last of {g} blocks of {tile} lies wholly "
                f"outside the extent of {extent}")
    threads = launch.block[0] * launch.block[1] * launch.block[2]
    if min(launch.block) < 1 or threads > MAX_THREADS or any(
            b > cap for b, cap in zip(launch.block, MAX_BLOCK)):
        bad(f"block {launch.block}: {threads} threads, the card takes 1 to "
            f"{MAX_THREADS} (each dim at most {MAX_BLOCK})")
    if launch.smem > MAX_SMEM:
        bad(f"{launch.smem} bytes of dynamic shared memory exceed the "
            f"card's {MAX_SMEM} a block")
    if launch.smem > DEFAULT_SMEM and not launch.opt_in:
        bad(f"{launch.smem} bytes of dynamic shared memory, more than "
            f"{DEFAULT_SMEM}, without the opt-in call first")
    return out


def check_launch_contract(calls: list, where: str) -> list[Finding]:
    """The entry-point calls of one case: at least one, each making at
    least one launch, each launch within the limits."""
    if not calls:
        return [error("audit.kernel.launch", where,
                      "the wrapper reached no entry point on CUDA operands")]
    out: list[Finding] = []
    for call in calls:
        if not call.launches:
            out.append(error("audit.kernel.launch", f"{where}:{call.entry}",
                             "entry point makes no launch for a non-empty "
                             "operand"))
        for i, launch in enumerate(call.launches):
            out += check_launch(launch, f"{where}:{call.entry}[{i}]")
    return out


# ---------------------------------------------------------------------------
# The preset x policy x site matrix walk
# ---------------------------------------------------------------------------

def matrix_policies() -> dict:
    """The matrix's policies: the named ones, and ``cuda+conv_packed``,
    the one policy that routes the tokenizer convs to the packed im2col
    kernel (``conv`` -> ``cuda_packed``, which no named policy takes), so
    that every declaration meets a site."""
    from repro_torch.core.policy import NAMED_POLICIES, ExecutionPolicy

    return {**NAMED_POLICIES, "cuda+conv_packed": ExecutionPolicy(
        backend="cuda", overrides=(("conv", "cuda_packed"),))}


#: Temporal tiling's chunk in the matrix: None, and 2 steps, which adds the
#: state-carrying ``lif_state`` sites.
MATRIX_TIME_CHUNKS = (None, 2)
#: Model axes in the matrix: one device, and each axis of up to 8 ranks
#: that splits the preset's heads, d_model and d_ff (one rank's site
#: shapes, ``SpikingFormerConfig.execution_site_specs(model_shards)``).
MATRIX_MODEL_SHARDS = (1, 2, 4, 8)


def model_shards_of(cfg) -> list[int]:
    """The entries of :data:`MATRIX_MODEL_SHARDS` that split ``cfg``
    (``cfg.check_model_shards``)."""
    out = []
    for m in MATRIX_MODEL_SHARDS:
        try:
            out.append(cfg.check_model_shards(m))
        except ValueError:
            continue
    return out


def config_cases(cfg, batch: int = 1, model_shards: int = 1) -> list:
    """``(site, decl, case)`` for every declared kernel at every planned
    site geometry of one config at global batch ``batch``, one rank's on a
    model axis of ``model_shards`` (sites whose impl is exempt launch no
    kernel and are left out)."""
    from repro_torch.core.policy import CONTRACT_EXEMPT_IMPLS
    from repro_torch.kernels.contract import KernelCase
    from repro_torch.tune.workloads import kernel_shape_cases

    _, by_pair = _contract_index()
    out = []
    for row in kernel_shape_cases(cfg, batch=batch,
                                  model_shards=model_shards):
        if row.impl in CONTRACT_EXEMPT_IMPLS:
            continue
        case = KernelCase(t=row.t, m=row.m, c=row.c, k=row.k,
                          packed=row.packed)
        out += [(row.site, decl, case)
                for decl in by_pair.get((row.op, row.impl), ())]
    return out


def kernel_cases(*, batch: int = 1, presets=None, policies=None):
    """Every distinct ``(where, decl, case)`` of the matrix: each declared
    kernel at each planned site geometry of every preset x policy (default
    :func:`matrix_policies`) x time chunk (``MATRIX_TIME_CHUNKS``) x model
    axis (:func:`model_shards_of`, one rank's shapes), the first site of a
    repeated (kernel, geometry) naming it."""
    from repro_torch.configs.spikingformer import (SPIKINGFORMER_PRESETS,
                                                   get_spikingformer_config)

    seen: set[tuple] = set()
    out = []
    for preset in presets or sorted(SPIKINGFORMER_PRESETS):
        for polname, pol in (policies or matrix_policies()).items():
            for chunk in MATRIX_TIME_CHUNKS:
                cfg = get_spikingformer_config(preset, policy=pol,
                                               time_chunk=chunk)
                for m in model_shards_of(cfg):
                    tag = f"{preset}@{polname}" + (
                        f"/time_chunk={chunk}" if chunk else "") + (
                        f"/model={m}" if m > 1 else "")
                    for site, decl, case in config_cases(cfg, batch, m):
                        if (decl.name, case) not in seen:
                            seen.add((decl.name, case))
                            out.append((f"{tag}/{site}[{decl.name}]", decl,
                                        case))
    return out


def audit_kernel_matrix(*, batch: int = 1, presets=None, policies=None,
                        launches: bool | None = None) -> list[Finding]:
    """Parity at every distinct (kernel, geometry) of the matrix and, where
    ``launches`` (None: where there is a CUDA device), the launch checks
    (``launches=True`` without a device raises)."""
    from repro_torch.kernels.contract import SkipCase

    why_not = launch_family_unavailable()
    if launches is None:
        launches = why_not is None
    findings: list[Finding] = []
    checked = n_launches = 0
    for where, decl, case in kernel_cases(batch=batch, presets=presets,
                                          policies=policies):
        try:
            args, fn_kwargs, ref_kwargs = decl.build(case)
        except SkipCase:
            continue
        except Exception as e:   # noqa: BLE001 - report, don't crash
            findings.append(error("audit.kernel.parity", where,
                                  f"builder failed at {case.shape4}: {e!r}"))
            continue
        try:
            out = decl.fn(*args, **fn_kwargs)
        except Exception as e:   # noqa: BLE001 - report, don't crash
            findings.append(error("audit.kernel.parity", where,
                                  f"wrapper failed on meta operands at "
                                  f"{case.shape4}: {e!r}"))
            continue
        checked += 1
        if decl.ref is not None:
            findings += check_parity_contract(decl, args, ref_kwargs, out,
                                              where)
        if launches:
            try:
                calls = read_launches(decl, args, fn_kwargs)
            except RuntimeError as e:
                findings.append(error("audit.kernel.launch", where, str(e)))
                continue
            n_launches += sum(len(c.launches) for c in calls)
            findings += check_launch_contract(calls, where)
    findings.append(info(
        "audit.kernel.parity", "matrix",
        f"{checked} distinct (kernel, geometry) contracts held against "
        f"their oracles on meta tensors"))
    if launches:
        findings.append(info(
            "audit.kernel.launch", "matrix",
            f"{n_launches} launches of {checked} cases read from the plan "
            f"exports and held to the card's limits; none made"))
    else:
        findings.append(info("audit.kernel.launch", "not-run",
                             f"launch family not run: {why_not}"))
    return findings


def launch_family_ran(findings) -> bool:
    """Whether ``findings`` hold the launch family's summary row of a run
    (``chip_smoke.py`` fails without it)."""
    return any(f.check == "audit.kernel.launch" and f.where == "matrix"
               for f in findings)


# ---------------------------------------------------------------------------
# audit.kernel.vjp
# ---------------------------------------------------------------------------

def _vjp_cases(dtype: torch.dtype):
    """``(name, op, args)`` for every autograd Function: ``op(*args)``
    applies it; tensor args are its primals."""
    from repro_torch.core.lif import fire
    from repro_torch.kernels import ops

    t, m, c, k, g = (_VJP_GEOM[x] for x in "tmckg")

    def a(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    return [
        ("lif_soma_op", ops.lif_soma_op, (a(t, m, k),)),
        ("lif_soma_carry_op", ops.lif_soma_carry_op,
         (a(t, m, k), a(m, k), a(m, k))),
        ("bn_train_op", ops.bn_train_op, (a(m, k), a(k), a(k))),
        ("spike_matmul_train_op", ops.spike_matmul_train_op,
         (a(m, c), a(c, k))),
        ("spike_bmm_train_op", ops.spike_bmm_train_op,
         (a(g, m, c), a(g, c, k))),
        ("spike_patch_mm_train_op", ops.spike_patch_mm_train_op,
         (a(t, m, c), a(c, k))),
        ("neuron_layer_train_op", ops.neuron_layer_train_op,
         (a(t, m, c), a(c, k), a(k), a(k))),
        ("neuron_layer_train_op[packed]",
         lambda *xs: ops.neuron_layer_train_op(*xs, packed=True),
         (a(t, m, c), a(c, k), a(k), a(k))),
        ("neuron_layer_eval_op", ops.neuron_layer_eval_op,
         (a(t, m, c), a(c, k), a(k, dt=torch.float32))),
        ("fire", lambda u: fire(u, 1.0, 0.0, 2.0, 1.0), (a(m, k),)),
    ]


def _check_one_vjp(name: str, op, args: tuple, dtype: str) -> list[Finding]:
    where = f"ops.{name}[{dtype}]"
    primals = [x.requires_grad_() for x in args]
    try:
        outs = op(*primals)
    except Exception as e:   # noqa: BLE001 - report, don't crash
        return [error("audit.kernel.vjp", where,
                      f"forward failed on meta operands: {e!r}")]
    outs = outs if isinstance(outs, tuple) else (outs,)
    node = outs[0].grad_fn
    if node is None or not hasattr(node, "_forward_cls"):
        return [error("audit.kernel.vjp", where,
                      "output carries no autograd Function node")]
    # The node is the Function's ctx: its own backward, called directly, on
    # a cotangent of each output's shape and dtype.
    cot = tuple(torch.empty_like(o) for o in outs)
    try:
        cts = node._forward_cls.backward(node, *cot)
    except Exception as e:   # noqa: BLE001 - report, don't crash
        return [error("audit.kernel.vjp", where,
                      f"backward failed on meta operands: {e!r}")]
    cts = cts if isinstance(cts, tuple) else (cts,)
    # One cotangent per input of the Function's forward: the primals (every
    # one requires grad) where ``needs_input_grad`` says so, in order; every
    # other input is a non-tensor and owes None.
    needs = node.needs_input_grad
    if len(cts) != len(needs):
        return [error("audit.kernel.vjp", where,
                      f"backward returned {len(cts)} cotangent(s) for "
                      f"{len(needs)} input(s)")]
    tensor_slots = [i for i, need in enumerate(needs) if need]
    if len(tensor_slots) != len(primals):
        return [error("audit.kernel.vjp", where,
                      f"{len(tensor_slots)} differentiable inputs for "
                      f"{len(primals)} primals")]
    out: list[Finding] = []
    for i, ct in enumerate(cts):
        if i not in tensor_slots:
            if ct is not None:
                out.append(error("audit.kernel.vjp", where,
                                 f"cotangent {i} given for a non-tensor "
                                 f"input"))
            continue
        if ct is None:
            continue     # a zero cotangent
        primal = primals[tensor_slots.index(i)]
        got, want = _avals(ct), _avals(primal)
        if got != want:
            out.append(error(
                "audit.kernel.vjp", where,
                f"cotangent {i} [{_aval_str(got)}] != primal "
                f"[{_aval_str(want)}]: a dtype drift here is a silent "
                f"cast in the update"))
    return out


def audit_kernel_vjps() -> list[Finding]:
    """Each autograd Function's forward and own backward at fp32 and
    bf16, on meta tensors."""
    findings: list[Finding] = []
    n = 0
    for dtype in _VJP_DTYPES:
        for name, op, args in _vjp_cases(getattr(torch, dtype)):
            findings += _check_one_vjp(name, op, args, dtype)
            n += 1
    findings.append(info(
        "audit.kernel.vjp", "ops",
        f"{n} autograd Function forward/backward pairs checked on meta "
        f"tensors across {len(_VJP_DTYPES)} dtypes"))
    return findings


# ---------------------------------------------------------------------------
# audit.trace.registry
# ---------------------------------------------------------------------------

def audit_registry_retrace(presets=None, policies=None) -> list[Finding]:
    """Policy-equivalent spellings of each preset (``name@policy`` against
    ``policy=`` with a freshly built equal policy) give configs that
    compare and hash equal, and so do repeated lookups of every registry
    config and its ``reduced()``."""
    from repro_torch.configs.registry import get_config, list_configs, \
        reduced
    from repro_torch.configs.spikingformer import (SPIKINGFORMER_PRESETS,
                                                   get_spikingformer_config)
    from repro_torch.core.policy import NAMED_POLICIES, ExecutionPolicy

    findings: list[Finding] = []
    for preset in presets or sorted(SPIKINGFORMER_PRESETS):
        for polname, pol in (policies or NAMED_POLICIES).items():
            where = f"spikingformer/{preset}@{polname}"
            pol_b = ExecutionPolicy(backend=pol.backend,
                                    overrides=dict(pol.overrides))
            try:
                if polname in NAMED_POLICIES and policies is None:
                    cfg_a = get_spikingformer_config(f"{preset}@{polname}")
                else:
                    cfg_a = get_spikingformer_config(preset, policy=pol)
                cfg_b = get_spikingformer_config(preset, policy=pol_b)
            except Exception as e:   # noqa: BLE001 - report, don't crash
                findings.append(error("audit.trace.registry", where,
                                      f"factory raised: {e!r}"))
                continue
            try:
                ha, hb = hash(cfg_a), hash(cfg_b)
            except TypeError as e:
                findings.append(error(
                    "audit.trace.registry", where,
                    f"config not hashable ({e}): it cannot key a plan or a "
                    f"tuned table"))
                continue
            if cfg_a != cfg_b:
                findings.append(error(
                    "audit.trace.registry", where,
                    "policy-equivalent spellings built unequal configs"))
            elif ha != hb:
                findings.append(error(
                    "audit.trace.registry", where,
                    "equal configs hash unequal"))
    for name in list_configs():
        where = f"registry/{name}"
        try:
            cfg_a, cfg_b = get_config(name), get_config(name)
            ra, rb = reduced(cfg_a), reduced(cfg_b)
            ok = (cfg_a == cfg_b and hash(cfg_a) == hash(cfg_b)
                  and ra == rb and hash(ra) == hash(rb))
        except Exception as e:   # noqa: BLE001 - report, don't crash
            findings.append(error("audit.trace.registry", where,
                                  f"factory/hash raised: {e!r}"))
            continue
        if not ok:
            findings.append(error(
                "audit.trace.registry", where,
                "repeated factory lookups disagree (eq/hash)"))
    return findings


# ---------------------------------------------------------------------------
# The kernels against the oracles (the card only: this part launches)
# ---------------------------------------------------------------------------

#: Tolerances of :func:`hold_against_oracle` (ROADMAP's tolerance policy):
#: the elementwise LIF kernels bitwise or within 1e-6; products of {0,1}
#: with Gaussian weights within rtol 1e-5 / atol 1e-4 (the same exact
#: products summed in another order); BN outputs within 1e-5, their column
#: statistics within 1e-6 (forward) / 1e-5 (backward) of their scale. Behind
#: a matmul or a BN reduction the spikes are held exactly
#: (:func:`spike_verdict`): a spike may differ from the oracle's only where
#: the oracle's membrane lies within the tolerance of the product (carried
#: through BN and the recursion) of the threshold.
ELEMENTWISE_ATOL = 1e-6
MATMUL_RTOL, MATMUL_ATOL = 1e-5, 1e-4
BN_TOL = 1e-5


def _spikes(gen, shape, device, rate=0.2):
    return (torch.rand(shape, generator=gen, device=device) < rate).float()


def _normal(gen, shape, device, scale=1.0, shift=0.0):
    return torch.randn(shape, generator=gen, device=device) * scale + shift


def oracle_operands(decl, case, gen: torch.Generator):
    """Operands of ``decl`` at ``case`` on ``gen``'s device, with values
    that exercise the kernel (spike rates of 0.2, currents around the
    threshold, Gaussian weights of unit-order sums): ``(args, fn_kwargs,
    ref_kwargs)`` as the builder gives them."""
    from repro_torch.kernels import ref

    meta, fn_kwargs, ref_kwargs = decl.build(case)
    dev = gen.device
    shapes = [tuple(a.shape) for a in meta]
    name = decl.name
    if name == "lif_soma_fwd":
        args = (_normal(gen, shapes[0], dev, 1.2, 0.3),)
    elif name.startswith("lif_soma_bwd"):
        s, u, mask = ref.lif_soma_fwd_ref(_normal(gen, shapes[0], dev, 1.2,
                                                  0.3))
        args = (_normal(gen, shapes[0], dev), u, s, mask) + tuple(
            _normal(gen, sh, dev) for sh in shapes[4:])
    elif name.startswith("spike_"):
        c = shapes[1][-2]
        args = (_spikes(gen, shapes[0], dev),
                _normal(gen, shapes[1], dev, c ** -0.5))
    elif name == "bn_fwd":
        args = (_normal(gen, shapes[0], dev, 2.0, 0.5),
                torch.rand(shapes[1], generator=gen, device=dev) + 0.5,
                _normal(gen, shapes[2], dev, 0.3))
    elif name == "bn_bwd":
        x = _normal(gen, shapes[1], dev, 2.0, 0.5)
        gamma = torch.rand(shapes[2], generator=gen, device=dev) + 0.5
        _, mu, sqrt_d = ref.bn_fwd_ref(x, gamma, gamma)
        args = (_normal(gen, shapes[0], dev), x, gamma, mu, sqrt_d)
    elif name.startswith("neuron_layer_"):
        c = shapes[0][-1]
        x = _spikes(gen, shapes[0], dev) if fn_kwargs["packed"] \
            else _normal(gen, shapes[0], dev)
        w = _normal(gen, shapes[1], dev,
                    (2.0 if fn_kwargs["packed"] else 1.0) * c ** -0.5)
        if name == "neuron_layer_train":
            args = (x, w,
                    torch.rand(shapes[2], generator=gen, device=dev) + 0.5,
                    _normal(gen, shapes[3], dev, 0.3, 0.5))
        else:
            args = (x, w, _normal(gen, shapes[2], dev, 0.1, 0.5))
    else:
        raise ValueError(f"no operand recipe for contract {name!r}")
    return args, fn_kwargs, ref_kwargs


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0


def _scaled(got, want) -> float:
    """max|got - want| / max|want|: a statistics vector's error relative
    to its scale."""
    return _max_err(got, want) / max(float(want.abs().max()), 1e-30)


def _close(got, want, rtol, atol) -> bool:
    return got.shape == want.shape and got.dtype == want.dtype and bool(
        ((got - want).abs() <= atol + rtol * want.abs()).all())


def spike_verdict(got, y, tol_y, *, alpha: float = 0.5,
                  th_fire: float = 1.0) -> dict:
    """The spikes ``got`` (T, M, K) of a kernel held against the oracle's
    membrane: the LIF recursion of ``kernels/ref.py`` on the oracle's input
    current ``y``, replayed along ``got``'s own resets so that each step is
    judged on its own after a spike that differs. ``tol_y`` bounds the
    kernel's error in the current; carried through the recursion it gives
    each step's band around the membrane. Outside the band a spike must be
    the oracle's; inside it either value passes. Returns ``{"total",
    "in_band", "wrong"}`` element counts; ``wrong`` (a spike outside the
    band that is not the oracle's, or a value other than 0 and 1) must be
    0."""
    u = torch.zeros_like(y[0])
    band = torch.zeros_like(y[0])
    s_prev = torch.zeros_like(y[0])
    in_band = wrong = 0
    for t in range(y.shape[0]):
        u = alpha * u * (1.0 - s_prev) + y[t]
        band = alpha * band * (1.0 - s_prev) + tol_y[t]
        near = (u - th_fire).abs() <= band
        s = got[t].to(u.dtype)
        want = (u >= th_fire).to(u.dtype)
        in_band += int(near.sum())
        wrong += int((((s != want) & ~near) | ((s != 0) & (s != 1))).sum())
        s_prev = s
    return {"total": got.numel(), "in_band": in_band, "wrong": wrong}


def _nl_current(decl_name, args):
    """The oracle's input current to the SOMA of a neuron layer and the
    bound on the kernel's error in it: ``(y (T, M, K), tol_y)``. The
    product within the matmul tolerance; in train mode the batch statistics
    carry that error (mu by its largest value in the column) and their own
    ``BN_TOL``, scaled by gamma / sqrt_d."""
    from repro_torch.kernels import ref

    x, w = args[0], args[1]
    acc = torch.einsum("tmc,ck->tmk", x.to(w.dtype), w)
    tol_z = MATMUL_ATOL + MATMUL_RTOL * acc.abs()
    if decl_name == "neuron_layer_eval":
        return acc + args[2].reshape(1, 1, -1), tol_z
    gamma, beta = args[2], args[3]
    t, m, k = acc.shape
    y, _, sqrt_d = ref.bn_fwd_ref(acc.reshape(t * m, k), gamma, beta)
    y = y.reshape(t, m, k)
    scale = (gamma.abs().reshape(1, -1) / sqrt_d).reshape(1, 1, k)
    tol_mu = tol_z.amax(dim=(0, 1), keepdim=True)
    return y, scale * (tol_z + tol_mu) + BN_TOL * (y - beta).abs()


def hold_against_oracle(decl, case, gen: torch.Generator) -> dict:
    """Launch ``decl``'s kernel at ``case`` on the card and hold its output
    against the oracle of ``kernels/ref.py`` on the same operands, under
    the tolerances above. Returns ``{"contract", "case", "ok",
    "max_abs_err", "bitwise", "spikes", "tolerance"}``: ``max_abs_err`` is
    the largest error of the wrapper's outputs held to a tolerance (None
    where it returns spikes alone); ``spikes``, for a neuron layer, the
    counts of :func:`spike_verdict` and ``differing``, the spikes that are
    not the oracle's. In train mode ``z_max_abs_err`` is the error of the
    pre-activation of the kernel's first pass (``neuron_layer_train_z``);
    the eval kernel's pre-activation never leaves it."""
    from repro_torch.kernels import neuron_layer

    args, fn_kwargs, ref_kwargs = oracle_operands(decl, case, gen)
    got = decl.fn(*args, **fn_kwargs)
    want = decl.ref(*args, **ref_kwargs)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    name = decl.name
    row = {"contract": name, "case": list(case.shape4),
           "packed": case.packed, "spikes": None}
    if name.startswith("lif_soma"):
        errs = [_max_err(a, b) for a, b in zip(got, want)]
        ok = all(a.shape == b.shape for a, b in zip(got, want)) and \
            max(errs) <= ELEMENTWISE_ATOL
        row.update(bitwise=all(torch.equal(a, b) for a, b in zip(got, want)),
                   tolerance=f"bitwise or {ELEMENTWISE_ATOL} abs")
    elif name.startswith("spike_"):
        errs = [_max_err(got[0], want[0])]
        ok = _close(got[0], want[0], MATMUL_RTOL, MATMUL_ATOL)
        row.update(bitwise=torch.equal(got[0], want[0]),
                   tolerance=f"rtol {MATMUL_RTOL}, atol {MATMUL_ATOL}")
    elif name in ("bn_fwd", "bn_bwd"):
        stat_tol = 1e-6 if name == "bn_fwd" else BN_TOL
        stats = [_scaled(a, b) for a, b in zip(got[1:], want[1:])]
        errs = [_max_err(a, b) for a, b in zip(got, want)]
        ok = _close(got[0], want[0], BN_TOL, BN_TOL) and \
            all(a.shape == b.shape for a, b in zip(got, want)) and \
            max(stats) <= stat_tol
        row.update(bitwise=all(torch.equal(a, b) for a, b in zip(got, want)),
                   stats_scaled_err=stats,
                   tolerance=f"rtol/atol {BN_TOL}; statistics within "
                             f"{stat_tol} of their scale")
    else:
        y, tol_y = _nl_current(name, args)
        spikes = spike_verdict(got[0], y, tol_y)
        spikes["differing"] = int((got[0] != want[0]).sum())
        ok = got[0].shape == want[0].shape and \
            got[0].dtype == want[0].dtype and spikes["wrong"] == 0
        stats = [_scaled(a, b) for a, b in zip(got[1:], want[1:])]
        errs = [_max_err(a, b) for a, b in zip(got[1:], want[1:])]
        if name == "neuron_layer_train":
            x, w = args[0], args[1]
            z = neuron_layer.neuron_layer_train_z(
                x, w, packed=fn_kwargs["packed"])
            acc = torch.einsum("tmc,ck->tmk", x, w)
            row["z_max_abs_err"] = _max_err(z, acc)
            errs.append(row["z_max_abs_err"])
            ok = ok and _close(z, acc, MATMUL_RTOL, MATMUL_ATOL) and \
                max(stats) <= BN_TOL
        row.update(bitwise=torch.equal(got[0], want[0]), spikes=spikes,
                   stats_scaled_err=stats,
                   tolerance="spikes the oracle's outside the band of "
                             "the product's tolerance around the threshold"
                             + (f"; z rtol {MATMUL_RTOL}, atol {MATMUL_ATOL};"
                                f" statistics within {BN_TOL} of their "
                                f"scale" if stats else ""))
    row.update(ok=bool(ok), max_abs_err=max(errs) if errs else None)
    return row


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def run_contracts(*, batch: int = 1, presets=None, policies=None,
                  launches: bool | None = None) -> list[Finding]:
    """All contract families; ``launches`` as in
    :func:`audit_kernel_matrix`."""
    findings = audit_kernel_coverage()
    findings += audit_kernel_matrix(batch=batch, presets=presets,
                                    policies=policies, launches=launches)
    findings += audit_kernel_vjps()
    findings += audit_registry_retrace(presets=presets, policies=policies)
    return findings
