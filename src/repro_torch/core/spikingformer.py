"""Spikingformer (the paper's representative Spiking Transformer) in PyTorch.

Model = Spiking Tokenizer (conv downsampling + spike encoding, eq. 4)
      + L Spiking Transformer Blocks (PSSA + SMLP, eq. 5-6)
      + GAP + FC classification head (eq. 7).

The counterpart of ``repro.core.spikingformer``: plain functions over
nested dicts of tensors with the reference pytree's keys
(``tokenizer[i].conv.w`` HWIO, ``blocks.pssa.q.linear.w`` with a leading L
axis, ``head.w`` ...), images NHWC, activations time-major (T, B, N, D). The
reference scans the homogeneous blocks over depth; here that is a Python
loop over the leading L axis. :class:`SpikingFormer` is a thin ``nn.Module``
over the same functions whose ``forward(images)`` is the serving entry;
:func:`spikingformer_grad_step` is one BPTT step (loss, gradients of every
parameter leaf, new BN state), what ``repro_torch.train.loop`` drives.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.core.backend import resolve_device
from repro_torch.core.lif import LIFConfig, lif_scan
from repro_torch.core.policy import (ExecutionPolicy, describe_breaker,
                                     dispatch_kernel, plan_sites,
                                     register_kernel,
                                     register_site_table, runtime_fallback)
from repro_torch.launch.mesh import P, map_specs
from repro_torch.core.spiking_layers import (BlockConfig, _bn_cuda,
                                             _neuron_layer_site, _normal,
                                             _tuned_prefers_pipeline,
                                             bn_apply, block_apply,
                                             check_model_split,
                                             init_block, init_bn, init_linear,
                                             linear_apply)
from repro_torch.tune.table import describe_tuned, lookup_tile

Params = dict[str, Any]
State = dict[str, Any]

#: Site table for construction-time ExecutionPolicy validation: every site
#: this model dispatches through (per-stage conv sites at the paper's
#: 224/14 geometry, 4 stages). The "tokenizer.conv" group admits any stage
#: index, so shallower/deeper tokenizers stay addressable as a group.
register_site_table(
    "spikingformer",
    tuple(f"tokenizer.conv.{i}" for i in range(4)) + (
        "tokenizer.bn", "tokenizer.lif", "pssa.lif", "pssa.qkv",
        "attn_qk", "attn_av", "pssa.proj", "smlp.lif", "smlp.a", "smlp.b"),
    groups=("tokenizer.conv",))


@dataclasses.dataclass(frozen=True)
class SpikingFormerConfig:
    """Paper Table III defaults: h=8, d=512, T=4, P=14, BS=16."""

    family: ClassVar[str] = "vision"

    num_layers: int = 8
    d_model: int = 512
    n_heads: int = 8
    d_ff: int = 2048                  # MLP ratio 4
    time_steps: int = 4
    image_size: int = 224
    in_channels: int = 3
    patch_grid: int = 14              # P: final N = P*P tokens
    num_classes: int = 1000
    lif: LIFConfig = LIFConfig()
    qk_first: bool = True             # paper-faithful (QK^T)V order
    attn_scale: float = 0.125
    dtype: Any = torch.float32
    # Training: recompute each block's activations in the backward instead
    # of keeping them (torch.utils.checkpoint per block).
    remat: bool = False
    # Temporal tiling: every LIF scan splits its T axis into chunks of this
    # length with the (U, S) carry threaded across chunk boundaries.
    time_chunk: int | None = None
    # True when the input frames are pre-encoded {0,1} spikes (DVS-style
    # event data): the *first* tokenizer stage then also qualifies for the
    # bit-packed spike-conv path (stages >= 2 always consume LIF spikes).
    spike_input: bool = False
    # Execution policy for every LIF/BN/matmul/attention site; derived
    # configs (Block/PSSA/SMLP/LIF) inherit it.
    policy: ExecutionPolicy = ExecutionPolicy()

    @property
    def block(self) -> BlockConfig:
        return BlockConfig(self.d_model, self.n_heads, self.d_ff,
                           self.lif_cfg, self.qk_first, self.attn_scale,
                           policy=self.policy)

    @property
    def lif_cfg(self) -> LIFConfig:
        """LIF config with the model policy + temporal tiling injected."""
        return dataclasses.replace(self.lif, policy=self.policy,
                                   time_chunk=self.time_chunk)

    def with_policy(self, policy: ExecutionPolicy) -> "SpikingFormerConfig":
        """Same model, different execution policy (params are compatible)."""
        return dataclasses.replace(self, policy=policy)

    def check_model_shards(self, m: int) -> int:
        """``m``, where a model axis of ``m`` ranks splits the heads,
        d_model and d_ff evenly (the plan's column and row splits); else
        raises."""
        return check_model_split("the Spikingformer", m,
                                 n_heads=self.n_heads, d_model=self.d_model,
                                 d_ff=self.d_ff)

    @property
    def num_tokens(self) -> int:
        return self.patch_grid * self.patch_grid

    @property
    def tokenizer_stages(self) -> int:
        n = self.image_size // self.patch_grid
        stages = max(1, n.bit_length() - 1)   # log2 downsample factor
        assert self.patch_grid * (2 ** stages) == self.image_size, (
            "image_size must be patch_grid * 2^k")
        return stages

    def tokenizer_stage_channels(self) -> tuple[tuple[int, int], ...]:
        """(c_in, c_out) for each eq. 4 tokenizer stage, in order."""
        stages = self.tokenizer_stages
        chans, c_in = [], self.in_channels
        for i in range(stages):
            c_out = self.d_model // (2 ** (stages - 1 - i))
            chans.append((c_in, c_out))
            c_in = c_out
        return tuple(chans)

    def execution_site_specs(self, model_shards: int = 1
                             ) -> tuple[tuple, ...]:
        """(site, op, pack_dim[, spike_operand[, trailing_lif]]) for every
        dispatch site in this model — the input to
        :func:`repro_torch.core.policy.plan_sites`, row for row what the
        reference's ``execution_site_specs`` gives; with ``model_shards``
        = M, one rank's of a model axis of M (the row-parallel sites
        contract over their D/M and d_ff/M local input features)."""
        head_dim = self.d_model // self.n_heads
        m = self.check_model_shards(model_shards)
        attn = (
            ("attn_qk", "attn_qk", head_dim),
            ("attn_av", "attn_av", self.num_tokens),
        ) if self.qk_first else ()
        lif_ops = ("lif", "lif_state") if self.time_chunk else ("lif",)
        lif = lambda site: tuple((site, op, None) for op in lif_ops)  # noqa
        conv = tuple(
            (f"tokenizer.conv.{i}", "conv", 9 * c_in,
             self.spike_input if i == 0 else True)
            for i, (c_in, _) in enumerate(self.tokenizer_stage_channels()))
        return conv + (
            ("tokenizer.bn", "bn", None),
        ) + lif("tokenizer.lif") + lif("pssa.lif") + (
            ("pssa.qkv", "linear_bn", self.d_model, True, True),
        ) + attn + (
            ("pssa.proj", "linear_bn", self.d_model // m, True, False),
        ) + lif("smlp.lif") + (
            ("smlp.a", "linear_bn", self.d_model, True, True),
            ("smlp.b", "linear_bn", self.d_ff // m, True, False),
        )

    def execution_plan(self, model_shards: int = 1):
        """Resolve the policy once against this model's shapes (one rank's
        on a model axis of ``model_shards``): one
        :class:`~repro_torch.core.policy.SiteDecision` per site, with the
        same annotations as the reference's plan (attention pack dims are
        architectural, so their demotions are expected; the
        ``tokenizer.bn`` / ``tokenizer.lif`` rows say when the fused conv
        stages absorb them)."""
        rows = plan_sites(self.policy,
                          self.execution_site_specs(model_shards))
        rows[:] = [dataclasses.replace(r, expected=True)
                   if r.op in ("attn_qk", "attn_av") and r.note else r
                   for r in rows]
        conv_rows = [r for r in rows if r.op == "conv"]

        def annotate(site, subset, what):
            if not subset:
                return
            if len(subset) == len(conv_rows):
                note = f"{what} (never dispatched)"
            else:
                note = (f"{what} at {len(subset)}/{len(conv_rows)} stages "
                        f"(still dispatches at the others)")
            rows[:] = [dataclasses.replace(r, note=note, expected=True)
                       if r.site == site else r for r in rows]

        annotate("tokenizer.bn",
                 [r for r in conv_rows if r.effective in FUSED_CONV_IMPLS],
                 "folded into the fused conv stages")
        annotate("tokenizer.lif",
                 [r for r in conv_rows
                  if r.effective in SINGLE_LAUNCH_CONV_IMPLS],
                 "absorbed into the single-launch neuron-layer megakernel")
        return rows

    def describe_execution(self, mesh=None) -> str:
        """The per-site dispatch table, the circuit breaker's demoted sites
        (when a site tripped in this process, ``policy.describe_breaker``),
        the active tuned-block table's entries for this model's sites
        (``repro_torch.tune``: the tiles and arms kernel dispatch will
        take), then the sharding plan (:meth:`describe_sharding`)."""
        rows = self.execution_plan()
        out = self.policy.describe(rows=rows)
        breaker = describe_breaker()
        if breaker:
            out = out + "\n\n" + breaker
        return out + "\n\n" + describe_tuned([r.site for r in rows]) + \
            "\n\n" + self.describe_sharding(mesh)

    def describe_sharding(self, mesh=None) -> str:
        """The sharding half of the execution report: the activation specs
        of the plan (batch over ("pod", "data"), projections over "model")
        and, with ``mesh`` (a mesh or an abstract one), the parameter
        placements ``launch.train.build_spikingformer_state`` uses on it
        (after ``sanitize_specs`` and FSDP), one ``path,spec`` line each,
        as the reference prints them."""
        lines = ["# Sharding plan (batch over ('pod','data'), "
                 "tensor-parallel over 'model')", "activation,spec"]
        for name, spec in activation_specs(self):
            lines.append(f"{name},{spec}")
        if mesh is not None:
            from repro_torch.launch.specs import spikingformer_structs
            from repro_torch.train.checkpoint import _flatten_with_paths
            _, (specs, _) = spikingformer_structs(self, mesh)
            lines.append(f"param,spec  (mesh {mesh.shape})")
            for name, spec in _flatten_with_paths(specs, spec_leaves=True):
                lines.append(f"{name},{spec}")
        return "\n".join(lines)

    def param_count(self) -> int:
        d, f = self.d_model, self.d_ff
        per_block = 4 * d * d + 2 * d * f + 10 * d + 2 * f
        tok = sum(9 * ci * co + 2 * co
                  for ci, co in self.tokenizer_stage_channels())
        head = self.d_model * self.num_classes + self.num_classes
        return self.num_layers * per_block + tok + head


# ---------------------------------------------------------------------------
# Sharding plan: logical partition specs for params and activations
# ---------------------------------------------------------------------------

BATCH, MODEL = ("pod", "data"), "model"


def activation_specs(cfg: SpikingFormerConfig) -> tuple[tuple[str, P], ...]:
    """(name, spec) of every activation of the reference's sharding plan.
    Activations are (T, B, N, D) unless noted; batch shards over ("pod",
    "data"), the Q/K/V, head and MLP-hidden projections over "model"; the
    residual stream keeps features replicated. Under data parallelism a
    rank holds the batch slice of each, which is what its rows give it."""
    return (
        ("images", P(None, BATCH, None, None, None)),     # (T,B,H,W,C)
        ("tokenizer.stage", P(None, BATCH, None, None, None)),  # (T,B,H,W,C)
        ("tokenizer.stage.folded", P(BATCH, None, None, None)),  # (T*B,H,W,C)
        ("tokenizer.patches", P(None, BATCH, None)),      # im2col (T,M,kkC)
        ("tokenizer.tokens", P(None, BATCH, None, None)),
        ("block.residual", P(None, BATCH, None, None)),   # (T,B,N,D)
        ("pssa.qkv", P(None, BATCH, None, MODEL)),        # (T,B,N,D)
        ("attn.scores", P(None, BATCH, MODEL, None, None)),  # (T,B,h,N,M)
        ("pssa.out", P(None, BATCH, None, MODEL)),        # merged heads
        ("smlp.hidden", P(None, BATCH, None, MODEL)),     # (T,B,N,F)
        ("head.features", P(BATCH, None)),                # (B, D)
    )


def spikingformer_param_specs(cfg: SpikingFormerConfig):
    """(param_specs, state_specs) trees matching :func:`init_spikingformer`.

    Q/K/V and SMLP-A column-parallel (output features over "model", their
    BN leaves alike), the Z projection and SMLP-B row-parallel (input
    features over "model", BN replicated); the stacked block leaves' leading
    L axis unsharded (:func:`spikingformer_scan_dims`); tokenizer convs and
    the head replicated (FSDP may still shard them over "data")."""
    rep = P(None)
    tok_p = [{"conv": {"w": P(None, None, None, None)},
              "bn": {"gamma": rep, "beta": rep}}
             for _ in range(cfg.tokenizer_stages)]
    tok_s = [{"bn": {"mean": rep, "var": rep}}
             for _ in range(cfg.tokenizer_stages)]

    def linear_bn(w_spec, feat_spec):
        return ({"linear": {"w": w_spec},
                 "bn": {"gamma": feat_spec, "beta": feat_spec}},
                {"bn": {"mean": feat_spec, "var": feat_spec}})

    col_p, col_s = linear_bn(P(None, None, MODEL), P(None, MODEL))
    row_p, row_s = linear_bn(P(None, MODEL, None), P(None, None))
    blocks_p = {"pssa": {"q": col_p, "k": col_p, "v": col_p, "z": row_p},
                "smlp": {"a": col_p, "b": row_p}}
    blocks_s = {"pssa": {"q": col_s, "k": col_s, "v": col_s, "z": row_s},
                "smlp": {"a": col_s, "b": row_s}}
    head = {"w": P(None, None), "b": P(None)}
    return ({"tokenizer": tok_p, "blocks": blocks_p, "head": head},
            {"tokenizer": tok_s, "blocks": blocks_s})


def lif_residual_accounting(cfg: SpikingFormerConfig, batch: int
                            ) -> dict[str, int]:
    """Analytic stored-residual accounting for the LIF sites of one BPTT
    step (fp32 bytes; the time-chunk memory math of docs/torch/SHARDING.md),
    the reference's function.

    ``single_shot``: the SOMA path persists (U, S, mask) for all T steps of
    every LIF site between FP and BP — 3·T·rows elements. ``tiled`` (with
    ``time_chunk`` set): the recomputed chunk scan stores only the (U, S)
    carries at the T/time_chunk chunk boundaries plus one transient chunk
    of (U, S, mask) recomputed during BP — 2·(T/tc)·rows + 3·tc·rows.
    ``rows`` is the per-time-step element count summed over all LIF sites.
    """
    t = cfg.time_steps
    rows = 0
    h = w = cfg.image_size
    for _, c_out in cfg.tokenizer_stage_channels():
        h, w = h // 2, w // 2
        rows += batch * h * w * c_out
    # per layer: PSSA scans x, q, k, v, out (5 d-wide) + SMLP scans x
    # (d-wide) and the hidden (d_ff-wide)
    rows += cfg.num_layers * batch * cfg.num_tokens * \
        (6 * cfg.d_model + cfg.d_ff)
    single = 3 * t * rows * 4
    tc = cfg.time_chunk or t
    if not (0 < tc < t) or t % tc != 0:
        tiled = single                     # degenerate: single-shot scan
    else:
        tiled = (2 * (t // tc) + 3 * tc) * rows * 4
    return {"elems_per_step": rows, "single_shot_bytes": single,
            "tiled_bytes": tiled}


def spikingformer_scan_dims(specs):
    """Per-leaf count of leading scan dims ``apply_fsdp`` must not shard: 1
    for the stacked block leaves, 0 elsewhere."""
    return {k: map_specs(lambda _: int(k == "blocks"), v)
            for k, v in specs.items()}


# ---------------------------------------------------------------------------
# Spiking Tokenizer: [Conv(k3,s2) -> BN -> LIF] x stages  (eq. 4)
#
# The ``conv`` registry op is one *full* eq. 4 stage on a time-major
# (T, B, H, W, C) input, returning (spikes, new_state). Implementations:
#
# * ``"eager"``          — the reference pipeline: dense conv, then the BN and
#                          LIF dispatched through their own sites
#                          (``tokenizer.bn`` / ``tokenizer.lif``).
# * ``"cuda"``           — the fused conv_bn_lif pipeline, dense-im2col arm:
#                          one time-major matmul (contraction k*k*c_in), BN
#                          folded into weights/bias (eval), then the SOMA
#                          kernel at ``tokenizer.lif``.
# * ``"cuda_packed"``    — same pipeline with the im2col patches bit-packed
#                          through the batched spike-matmul kernel (spike
#                          inputs only; k*k*c_in % 8 == 0).
# * ``"fused_epilogue"`` — the whole stage as ONE launch of the neuron-layer
#                          kernel: im2col matmul (bit-packed on spike
#                          inputs), folded BN and SOMA; neither
#                          ``tokenizer.bn`` nor ``tokenizer.lif`` dispatches.
# ---------------------------------------------------------------------------

#: conv impls that run a fused Conv->BN->LIF pipeline (BN folded in).
FUSED_CONV_IMPLS: frozenset[str] = frozenset({"cuda", "cuda_packed",
                                              "fused_epilogue"})

#: conv impls that additionally absorb the SOMA epilogue into the same
#: single kernel launch (``tokenizer.lif`` never dispatches).
SINGLE_LAUNCH_CONV_IMPLS: frozenset[str] = frozenset({"fused_epilogue"})


def _conv_init(generator, c_in, c_out, dtype, device):
    return {"w": _normal(generator, (3, 3, c_in, c_out), dtype, device,
                         (9 * c_in) ** -0.5)}


@register_kernel("conv", "eager")
def _conv_stage_eager(params, state, x, lif_cfg, train, spike_in, policy,
                      site):
    """Reference eq. 4 stage: dense conv -> BN -> LIF, each stage sub-op
    dispatched through the policy at its own site.

    The SAME padding of a k3/s2 conv on an even size is one-sided, so the
    input is padded explicitly and the convolution runs with padding 0."""
    from repro_torch.kernels import conv_spike

    t, b, h, w, c = x.shape
    xp = conv_spike.pad_same(x.reshape(t * b, h, w, c))
    wt = params["conv"]["w"].to(x.dtype).permute(3, 2, 0, 1)    # HWIO -> OIHW
    y = F.conv2d(xp.permute(0, 3, 1, 2), wt, stride=2).permute(0, 2, 3, 1)
    # BN over (TB,H,W) per channel; LIF scans time, so unfold T.
    y, bn_s = bn_apply(params["bn"], state["bn"], y, train=train,
                       policy=policy, site="tokenizer.bn")
    _, hh, wh, ch = y.shape
    spikes = lif_scan(y.reshape(t, b, hh, wh, ch), lif_cfg,
                      site="tokenizer.lif")
    return spikes, {"bn": bn_s}


def _im2col_patches(params, x):
    """Shared prologue of every fused conv arm: lower the k3/s2 stage input
    (T, B, H, W, C) to time-major im2col patches (T, M, k*k*c_in), plus the
    (k*k*c_in, c_out) weight matrix and the output spatial dims."""
    from repro_torch.kernels import conv_spike

    t, b, h, w, c = x.shape
    patches = conv_spike.im2col(x.reshape(t * b, h, w, c))
    _, ho, wo, cdim = patches.shape
    patches = patches.reshape(t, b * ho * wo, cdim)         # (T, M, k*k*c_in)
    w_mat = conv_spike.conv_w_matrix(params["conv"]["w"])
    return patches, w_mat, (t, b, ho, wo, cdim)


def conv_bn_lif_fused(params, state, x, lif_cfg, train, spike_in, policy,
                      site, *, packed, tile=None, lowered=None):
    """Fused eq. 4 stage, pipeline arms: im2col matmul + BN, then the SOMA
    kernel at ``tokenizer.lif``.

    With ``packed=True`` and a spike input whose contraction is a multiple
    of 8, the patches ride the bit-packed batched spike kernel; otherwise
    the dense matmul of the same pipeline runs (logged when that disagrees
    with a packed request). BN never dispatches at ``tokenizer.bn``: in
    eval it folds into the matmul weights and a bias; in train the batch
    statistics depend on the conv output, so the BN kernel pair
    (``_bn_cuda``, the one the Conv1DBN sites use) computes and applies
    them. ``tile`` forces the packed arm's spike-matmul tile; ``None``
    takes the active tuned table's entry for this stage, or
    ``spike_matmul.default_tile``. ``lowered`` is ``_im2col_patches``'
    result where the caller already has it.
    """
    from repro_torch.kernels import conv_spike, ops

    patches, w_mat, (t, b, ho, wo, cdim) = lowered or \
        _im2col_patches(params, x)
    k_out = w_mat.shape[-1]
    use_packed = packed and spike_in and cdim % 8 == 0
    if packed and not use_packed:
        reason = (f"im2col dim {cdim} % 8 != 0" if spike_in
                  else "float (non-spike) input")
        runtime_fallback(site, "cuda_packed",
                         reason + " -> dense im2col arm",
                         expected=not spike_in)
    if use_packed and tile is None:
        tile = lookup_tile(site, "conv", "cuda_packed",
                           (t, patches.shape[1], cdim, k_out), x.device)

    def matmul(weights):
        weights = weights.to(patches.dtype)
        if use_packed:
            return ops.spike_patch_mm_train_op(patches, weights, tile)
        return torch.matmul(patches, weights)

    bn_p, bn_s = params["bn"], state["bn"]
    if train:
        y, new_bn = _bn_cuda(bn_p, bn_s, matmul(w_mat), True, 0.9, 1e-5,
                             policy, site)
    else:
        w_fold, bias = conv_spike.fold_bn(w_mat, bn_p["gamma"], bn_p["beta"],
                                          bn_s["mean"], bn_s["var"])
        y = matmul(w_fold) + bias.to(patches.dtype)
        new_bn = bn_s
    spikes = lif_scan(y, lif_cfg, site="tokenizer.lif")     # (T, M, K)
    return spikes.reshape(t, b, ho, wo, k_out), {"bn": new_bn}


@register_kernel("conv", "cuda")
def _conv_stage_im2col(params, state, x, lif_cfg, train, spike_in, policy,
                       site):
    """Dense-im2col arm of the fused conv_bn_lif pipeline (also the planned
    fallback of ``cuda_packed`` on ragged or float-input stages)."""
    return conv_bn_lif_fused(params, state, x, lif_cfg, train, spike_in,
                             policy, site, packed=False)


@register_kernel("conv", "cuda_packed")
def _conv_stage_packed(params, state, x, lif_cfg, train, spike_in, policy,
                       site):
    """Bit-packed arm: im2col patches cross device memory at 1 bit/element
    through the batched spike-matmul kernel."""
    return conv_bn_lif_fused(params, state, x, lif_cfg, train, spike_in,
                             policy, site, packed=True)


@register_kernel("conv", "fused_epilogue")
def _conv_stage_megakernel(params, state, x, lif_cfg, train, spike_in,
                           policy, site):
    """Single-launch eq. 4 stage: ONE kernel call computes the im2col
    matmul (bit-packed on spike inputs with ``k*k*c_in % 8 == 0``, dense arm
    otherwise — logged), applies BN (batch statistics in the kernel in
    train, folded weights in eval) and runs the SOMA membrane update with
    (U, S) in registers. Neither ``tokenizer.bn`` nor ``tokenizer.lif``
    dispatches — 3 dispatches -> 1 per stage. The train arm stays fused at
    every stage: the reference's demotion to the pipeline is a TPU VMEM
    rule with no meaning on this card. In train mode the active tuned
    table may have measured the pipeline arm as faster: the stage then
    runs :func:`conv_bn_lif_fused` with the entry's tile."""
    lowered = _im2col_patches(params, x)
    patches, w_mat, (t, b, ho, wo, cdim) = lowered
    packed = spike_in and cdim % 8 == 0
    if train:
        tb = _tuned_prefers_pipeline(
            site, "conv", "fused_epilogue",
            (t, patches.shape[1], cdim, w_mat.shape[-1]), packed, policy,
            x.device, "the conv_bn_lif pipeline")
        if tb is not None:
            return conv_bn_lif_fused(params, state, x, lif_cfg, train,
                                     spike_in, policy, site, packed=packed,
                                     tile=tb.tile(), lowered=lowered)
    if not packed:
        reason = (f"im2col dim {cdim} % 8 != 0" if spike_in
                  else "float (non-spike) input")
        runtime_fallback(site, "fused_epilogue",
                         reason + " -> dense arm (still fused)",
                         expected=not spike_in)
    spikes, bn_s = _neuron_layer_site(patches, w_mat, params["bn"],
                                      state["bn"], lif_cfg, train, packed)
    return spikes.reshape(t, b, ho, wo, w_mat.shape[-1]), {"bn": bn_s}


def init_tokenizer(generator, cfg: SpikingFormerConfig, device="cpu"):
    params, states = [], []
    for c_in, c_out in cfg.tokenizer_stage_channels():
        p_conv = _conv_init(generator, c_in, c_out, cfg.dtype, device)
        p_bn, s_bn = init_bn(c_out, cfg.dtype, device)
        params.append({"conv": p_conv, "bn": p_bn})
        states.append({"bn": s_bn})
    return params, states


def tokenizer_apply(params, state, images, cfg: SpikingFormerConfig, *,
                    train: bool):
    """images: (T, B, H, W, C) -> spike patches (T, B, N, D).

    Each stage dispatches the full-stage ``conv`` op at its own site
    (``tokenizer.conv.<i>``). Stage 1 sees spikes only under
    ``cfg.spike_input``; later stages always do (LIF outputs).
    """
    pol = cfg.policy
    x, spike_in = images, cfg.spike_input
    new_states = []
    for i, (p, s) in enumerate(zip(params, state)):
        site = f"tokenizer.conv.{i}"
        x, s_new = dispatch_kernel(site, "conv", pol.resolve(site, "conv"),
                                   p, s, x, cfg.lif_cfg, train, spike_in,
                                   pol, site)
        new_states.append(s_new)
        spike_in = True                        # LIF output feeds stage i+1
    t, b = x.shape[:2]
    return x.reshape(t, b, -1, x.shape[-1]), new_states


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def _stack_trees(trees):
    """List of identically-shaped nested dicts -> one dict whose leaves carry
    a leading axis (the reference's vmapped block parameters)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _index_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def init_spikingformer(generator: torch.Generator | None,
                       cfg: SpikingFormerConfig,
                       device: str | torch.device | None = None):
    """Random parameters and BN state with the reference pytree's keys and
    layouts, drawn from ``generator`` (a CPU ``torch.Generator``; the
    numbers differ from the reference's ``jax.random`` ones) and placed on
    ``device`` (``None`` = the card)."""
    device = resolve_device(device)
    p_tok, s_tok = init_tokenizer(generator, cfg, device)
    blocks = [init_block(generator, cfg.block, cfg.dtype, device)
              for _ in range(cfg.num_layers)]
    p_blocks = _stack_trees([p for p, _ in blocks])
    s_blocks = _stack_trees([s for _, s in blocks])
    p_head = init_linear(generator, cfg.d_model, cfg.num_classes, cfg.dtype,
                         device)
    p_head["b"] = torch.zeros(cfg.num_classes, dtype=cfg.dtype, device=device)
    params = {"tokenizer": p_tok, "blocks": p_blocks, "head": p_head}
    state = {"tokenizer": s_tok, "blocks": s_blocks}
    return params, state


def spikingformer_apply(params: Params, state: State, images: torch.Tensor,
                        cfg: SpikingFormerConfig, *, train: bool,
                        taps: list | None = None):
    """images: (T,B,H,W,C) or (B,H,W,C) (static image, repeated over T).

    Returns (logits (B, num_classes), new_state). ``taps``, when given a
    list, receives the tokenizer's output spikes and then each block's
    output (the residual stream), for comparing two policies layer by
    layer.
    """
    if images.ndim == 4:  # static dataset: replicate over time (direct coding)
        images = images.unsqueeze(0).expand(cfg.time_steps, *images.shape)
    x, s_tok = tokenizer_apply(params["tokenizer"], state["tokenizer"], images,
                               cfg, train=train)
    if taps is not None:
        taps.append(x)
    block_cfg = cfg.block
    new_blocks = []
    for i in range(cfg.num_layers):
        args = (_index_tree(params["blocks"], i),
                _index_tree(state["blocks"], i), x, block_cfg)
        if cfg.remat and torch.is_grad_enabled():
            # keep only the block's input; recompute its inside in backward
            x, s_new = torch.utils.checkpoint.checkpoint(
                block_apply, *args, train=train, use_reentrant=False)
        else:
            x, s_new = block_apply(*args, train=train)
        new_blocks.append(s_new)
        if taps is not None:
            taps.append(x)
    # eq. 7: GAP over tokens, rate-decode over time, then FC.
    feat = x.mean(dim=(0, 2))                                   # (B, D)
    logits = linear_apply(params["head"], feat) + params["head"]["b"]
    return logits.float(), {"tokenizer": s_tok,
                            "blocks": _stack_trees(new_blocks)}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    return nll.mean()


def spikingformer_loss(params, state, images, labels,
                       cfg: SpikingFormerConfig):
    """BPTT training loss: ``(loss, (new_state, {"loss", "accuracy"}))``."""
    logits, new_state = spikingformer_apply(params, state, images, cfg,
                                            train=True)
    loss = cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, (new_state, {"loss": loss.detach(), "accuracy": acc})


def tree_leaves(tree) -> list:
    """Leaves of a nested dict/list in the reference pytree's order (dict
    keys sorted, as ``jax.tree_util`` flattens them)."""
    return [leaf for _, leaf in _flatten(tree)]


def tree_paths(tree) -> list[str]:
    """Dotted names of the leaves, in :func:`tree_leaves` order."""
    return [name for name, _ in _flatten(tree)]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in :func:`tree_leaves` order)
    in place of its leaves."""
    return _rebuild(tree, dict(zip(tree_paths(tree), leaves)))


def tree_map(fn, *trees):
    """``fn`` applied leaf by leaf to trees of one structure."""
    return tree_unflatten(trees[0], [fn(*xs) for xs in
                                     zip(*map(tree_leaves, trees))])


def value_and_grad(loss_fn, params, *args):
    """``((loss, aux), grads)`` of ``loss_fn(params, *args) -> (loss,
    aux)``, the counterpart of ``jax.value_and_grad(loss_fn,
    has_aux=True)``: ``grads`` has the structure of ``params``, zeros where
    a leaf does not reach the loss. ``params`` is not modified: the
    gradients are taken with respect to detached copies of its leaves."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), aux), tree_unflatten(params, grads)


def spikingformer_grad_step(params, state, images, labels,
                            cfg: SpikingFormerConfig):
    """One BPTT step: returns ``(grads, new_state, metrics)``, ``grads``
    with the structure of ``params`` (see :func:`value_and_grad`)."""
    (_, (new_state, metrics)), grads = value_and_grad(
        spikingformer_loss, params, state, images, labels, cfg)
    return grads, new_state, metrics


# ---------------------------------------------------------------------------
# nn.Module wrapper: the serving entry
# ---------------------------------------------------------------------------

def _flatten(tree, prefix=""):
    """(dotted name, leaf) pairs, dict keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _rebuild(tree, leaves, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves, f"{prefix}{i}.")
                for i, v in enumerate(tree)]
    return leaves[prefix[:-1]]


class SpikingFormer(torch.nn.Module):
    """Thin module over :func:`spikingformer_apply`: holds the parameter
    dict's tensors as ``nn.Parameter``s and the BN running statistics as
    buffers (dots in the pytree paths become ``__`` in their names), and
    answers classification requests in eval mode.

    ``params``/``state`` default to a fresh :func:`init_spikingformer` from
    ``seed``; pass converted reference weights
    (:func:`repro_torch.convert.from_jax`) to serve those instead.
    """

    def __init__(self, cfg: SpikingFormerConfig, params: Params | None = None,
                 state: State | None = None, *, seed: int = 0,
                 device: str | torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        if params is None or state is None:
            gen = torch.Generator().manual_seed(seed)
            params, state = init_spikingformer(gen, cfg, device)
        self._params_tree, self._state_tree = params, state
        for name, leaf in _flatten(params):
            self.register_parameter(
                "p__" + name.replace(".", "__"),
                torch.nn.Parameter(leaf.to(device), requires_grad=False))
        for name, leaf in _flatten(state):
            self.register_buffer("s__" + name.replace(".", "__"),
                                 leaf.to(device))
        self.eval()

    def _tree(self, template, tag):
        named = dict(self.named_parameters() if tag == "p"
                     else self.named_buffers())
        leaves = {name: named[f"{tag}__" + name.replace(".", "__")]
                  for name, _ in _flatten(template)}
        return _rebuild(template, leaves)

    @property
    def params(self) -> Params:
        """The parameters as the nested dict the plain functions take."""
        return self._tree(self._params_tree, "p")

    @property
    def state(self) -> State:
        return self._tree(self._state_tree, "s")

    def with_policy(self, policy: ExecutionPolicy) -> "SpikingFormer":
        """A module sharing these weights under another execution policy."""
        return SpikingFormer(self.cfg.with_policy(policy), self.params,
                             self.state, device=self._device())

    def _device(self) -> torch.device:
        return next(self.parameters()).device

    @torch.no_grad()
    def forward(self, images: torch.Tensor,
                taps: list | None = None) -> torch.Tensor:
        """images (B, H, W, C) or (T, B, H, W, C), NHWC, on the module's
        device -> logits (B, num_classes), eval mode (running BN
        statistics, no state update)."""
        if images.device != self._device():
            raise ValueError(f"images on {images.device}, model on "
                             f"{self._device()}")
        logits, _ = spikingformer_apply(self.params, self.state, images,
                                        self.cfg, train=False, taps=taps)
        return logits
