"""Decoder LM assembled from an ArchConfig (the counterpart of
``repro.models.lm``).

Families:
  dense / moe / vlm : pre-norm attention (GQA, or MLA with ``cfg.mla``) +
                      pre-norm FFN (SwiGLU, or the mixture of experts with
                      ``cfg.moe``); vlm merges pre-embedded image patches
  rwkv              : ln + time mix, ln + channel mix blocks
  hybrid (zamba2)   : groups of Mamba2 blocks, each group followed by ONE
                      weight-shared attention + SwiGLU block

The layer leaves are stacked on a leading ``(L, ...)`` axis and looped over
(the reference scans over it); the hybrid family views them as ``(groups,
per, ...)``. With ``cfg.lif`` set it is the spiking LM: the E2ATST LIF
neuron sits on every block's FFN / channel-mix / mixer branch (site
``lm.ffn.lif``; the shared block has none), with the sequence axis as the
neuron's time axis in the forward and its ``(U, S)`` state carried in the
serving cache in decode.

The audio family is not a decoder LM: it runs through
``repro_torch.models.encdec``, as the reference routes it, and this
module's entry points refuse it.

On a mesh with a model axis (the ambient mesh, ``launch.mesh.use_mesh``)
every family is model parallel: the embedding and the unembedding
vocab-parallel, or split on D where the axis does not divide the
vocabulary; each block's attention (GQA or MLA) under the scheme the
reference chooses ("heads", "seq" or "none"; in decode heads,
flash-decode or head_dim, MLA's latent on its positions or its
features), entering its own region; the SwiGLU between
``copy_to_model`` and its row-parallel sum; the MoE expert parallel (the
rank's S/M rows routed and sent to their experts' ranks by all-to-all,
gathered back; in decode every rank routes every token to its own
experts and the results are summed); the RWKV time and channel mixes and
the Mamba2 mixer on the rank's heads (their decode states on the rank's
slice, never gathered); the LIF on the whole (B, S, D) after the
branch's sum or gather, so that its time axis is the whole sequence. The
serving entry points hand back whole-vocabulary logits.
:func:`check_lm_split` names what an axis cannot lay out.

Entry points:
  init_lm(generator, cfg, device)      -> augmented param tree (Leaf leaves)
  lm_forward(params, batch, cfg)       -> (hidden, aux_loss)
  lm_loss(params, batch, cfg)          -> (loss, metrics)    [training]
  lm_prefill(params, batch, cfg)       -> last-position logits  [serving]
  lm_decode_step(params, cache, tokens, pos, cfg) -> (logits, cache)
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.backend import resolve_device
from repro_torch.core.lif import lif_decode_step, lif_scan
from repro_torch.core.policy import register_site_table
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (copy_to_model, cross_entropy_loss,
                                       embed, gather_vocab, init_embedding,
                                       init_rmsnorm, lscan, model_coord,
                                       rmsnorm, stack_layer_trees, table_shape,
                                       table_split, tree_map, unembed)
from repro_torch.models.mlp import init_swiglu, swiglu

Params = dict[str, Any]


def _refuse_audio(cfg: ArchConfig) -> None:
    """Refuse the encoder-decoder (audio) family, whose path is
    ``models.encdec``."""
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.name}: the encoder-decoder (audio) family runs through "
            f"repro_torch.models.encdec (init_encdec, encdec_loss, "
            f"init_encdec_cache, encdec_decode_step); "
            f"repro_torch.models.lm runs the decoder families")


def check_lm_split(cfg: ArchConfig, m: int | None = None) -> None:
    """Raises ``ValueError`` where a model axis of ``m`` ranks (default:
    the ambient mesh's) cannot lay out a computation of ``cfg`` as the
    reference's plan stores it: the SwiGLU, GELU or channel-mix width, a
    recurrent family's heads (RWKV's, Mamba2's), or an MoE's experts
    that the axis does not divide. The attention's (and MLA's) scheme is
    chosen at the attention; a vocabulary the axis does not divide is
    stored and computed on D (``common.table_split``)."""
    m = model_coord()[1] if m is None else m
    if m == 1:
        return

    def need(n: int, what: str) -> None:
        if n % m:
            raise ValueError(f"{cfg.name}: {what} {n} does not split over "
                             f"a model axis of {m}")
    if cfg.family == "rwkv":
        need(cfg.rwkv.n_heads, "dim 'heads' of the time mix:")
        need(cfg.rwkv.d_ff, "dim 'd_ff' of the channel mix:")
        return
    if cfg.family == "hybrid":
        need(cfg.ssm.n_heads, "dim 'heads' of the Mamba2 mixer:")
    if cfg.family == "audio":
        need(cfg.d_ff, "dim 'd_ff' of the GELU MLP:")
        return
    width = cfg.d_ff if cfg.moe is None else \
        cfg.moe.d_ff_expert * cfg.moe.n_shared
    need(width, "dim 'd_ff' of the SwiGLU:")
    if cfg.moe is not None:
        e = cfg.moe.num_experts
        if (e % m if e >= m else m % e) or cfg.moe.d_ff_expert % max(
                1, m // e):
            raise ValueError(f"{cfg.name}: {e} experts of width "
                             f"{cfg.moe.d_ff_expert} do not lay out over "
                             f"a model axis of {m}")


# ---------------------------------------------------------------------------
# Spiking-LM branch neuron (cfg.lif): sequence-as-time stateful LIF
# ---------------------------------------------------------------------------

#: Registry site of the per-block branch neuron (per-site policy overrides).
LM_LIF_SITE = "lm.ffn.lif"

register_site_table("lm", (LM_LIF_SITE,))


def _seq_lif(f: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """LIF over a (B, S, D) branch output with the *sequence* axis as the
    neuron's time axis (eq. 11, starting from rest). Token-by-token decode
    (:func:`repro_torch.core.lif.lif_decode_step` fed the cached (U, S))
    continues this recursion, so forward and decode agree token for
    token."""
    spikes = lif_scan(f.transpose(0, 1), cfg.lif, site=LM_LIF_SITE)
    return spikes.transpose(0, 1)


def _lif_decode(f: torch.Tensor, st: dict[str, torch.Tensor],
                cfg: ArchConfig):
    """One SOMA step on a (B, 1, D) decode branch output; ``st`` is the
    slot-batched {"u","s"} membrane state from the serving cache."""
    spike, (u, s) = lif_decode_step(f[:, 0], st["u"], st["s"], cfg.lif,
                                    site=LM_LIF_SITE)
    return spike[:, None], {"u": u, "s": s}


def _init_lif_state(batch: int, cfg: ArchConfig, dtype, device):
    return {"u": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
            "s": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Dense / moe block: init / forward / decode
# ---------------------------------------------------------------------------

def _init_dense_block(generator, cfg: ArchConfig, device):
    p = {"ln1": init_rmsnorm(cfg.d_model, cfg.dtype, device),
         "ln2": init_rmsnorm(cfg.d_model, cfg.dtype, device)}
    if cfg.mla is not None:
        p["attn"] = mla_mod.init_mla(generator, cfg.mla, cfg.dtype, device)
    else:
        p["attn"] = attn_mod.init_attention(generator, cfg.attn, cfg.dtype,
                                            device)
    if cfg.moe is not None:
        p["ffn"] = moe_mod.init_moe(generator, cfg.moe, cfg.dtype, device)
    else:
        p["ffn"] = init_swiglu(generator, cfg.d_model, cfg.d_ff, cfg.dtype,
                               device)
    return p


def _dense_block(p, x, cfg: ArchConfig, *, use_flash: bool):
    """One block: (x + attention + FFN branch, the MoE's aux loss (0 for
    SwiGLU)). The attention and the MoE enter their model-parallel regions
    themselves (their schemes differ in how); the SwiGLU's input enters
    it here."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.mla is not None:
        a = mla_mod.mla_flash_attention(p["attn"], h, cfg.mla) if use_flash \
            else mla_mod.mla_attention(p["attn"], h, cfg.mla)
    elif use_flash:
        a = attn_mod.flash_attention(p["attn"], h, cfg.attn)
    else:
        a = attn_mod.attention(p["attn"], h, cfg.attn)
    x = x + a
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.moe is not None:
        f, aux = moe_mod.moe_apply(p["ffn"], h, cfg.moe)
    else:
        f = swiglu(p["ffn"], copy_to_model(h))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.lif is not None:
        f = _seq_lif(f, cfg)
    return x + f, aux


def _dense_block_decode(p, x, cache, pos, cfg: ArchConfig):
    kv = cache["kv"] if cfg.lif is not None else cache
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.mla is not None:
        a, kv = mla_mod.mla_decode(p["attn"], h, kv, pos, cfg.mla)
    else:
        a, kv = attn_mod.attention_decode(p["attn"], h, kv, pos, cfg.attn)
    x = x + a
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.moe is not None:
        f, _ = moe_mod.moe_apply(p["ffn"], h, cfg.moe)
    else:
        f = swiglu(p["ffn"], copy_to_model(h))
    if cfg.lif is not None:
        f, lif_st = _lif_decode(f, cache["lif"], cfg)
        return x + f, {"kv": kv, "lif": lif_st}
    return x + f, kv


def _shared_cfg(cfg: ArchConfig) -> ArchConfig:
    """The hybrid's weight-shared block: dense attention + SwiGLU, no LIF."""
    return cfg.replace(moe=None, mla=None, family="dense", lif=None)


# ---------------------------------------------------------------------------
# RWKV block: init / forward / decode
# ---------------------------------------------------------------------------

def _init_rwkv_block(generator, cfg: ArchConfig, device):
    return {"ln1": init_rmsnorm(cfg.d_model, cfg.dtype, device),
            "ln2": init_rmsnorm(cfg.d_model, cfg.dtype, device),
            "time": rwkv_mod.init_rwkv_time_mix(generator, cfg.rwkv,
                                                cfg.dtype, device),
            "chan": rwkv_mod.init_rwkv_channel_mix(generator, cfg.rwkv,
                                                   cfg.dtype, device)}


def _rwkv_block(p, x, cfg: ArchConfig):
    x = x + rwkv_mod.rwkv_time_mix(p["time"],
                                   rmsnorm(p["ln1"], x, cfg.norm_eps),
                                   cfg.rwkv)
    c_out = rwkv_mod.rwkv_channel_mix(p["chan"],
                                      rmsnorm(p["ln2"], x, cfg.norm_eps),
                                      cfg.rwkv)
    if cfg.lif is not None:
        c_out = _seq_lif(c_out, cfg)
    return x + c_out


def _rwkv_block_decode(p, x, state, cfg: ArchConfig):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    t_out, t_state = rwkv_mod.rwkv_time_mix_decode(p["time"], h,
                                                   state["time"], cfg.rwkv)
    x = x + t_out
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    c_out = rwkv_mod.rwkv_channel_mix(
        p["chan"], h, cfg.rwkv,
        x_prev=rwkv_mod.gather_carry(state["chan"], cfg.d_model))
    new_state = {"time": t_state,
                 "chan": rwkv_mod.keep_carry(h, state["chan"])}
    if cfg.lif is not None:
        c_out, new_state["lif"] = _lif_decode(c_out, state["lif"], cfg)
    return x + c_out, new_state


# ---------------------------------------------------------------------------
# Mamba2 block (hybrid family): init / forward / decode
# ---------------------------------------------------------------------------

def _init_mamba_block(generator, cfg: ArchConfig, device):
    return {"ln": init_rmsnorm(cfg.d_model, cfg.dtype, device),
            "ssm": ssm_mod.init_ssm(generator, cfg.ssm, cfg.dtype, device)}


def _mamba_block(p, x, cfg: ArchConfig):
    out = ssm_mod.ssm_mixer(p["ssm"], rmsnorm(p["ln"], x, cfg.norm_eps),
                            cfg.ssm)
    if cfg.lif is not None:
        out = _seq_lif(out, cfg)
    return x + out


def _mamba_block_decode(p, x, state, cfg: ArchConfig):
    ssm_state = {k: state[k] for k in ("h", "conv")}
    out, ssm_state = ssm_mod.ssm_decode(p["ssm"],
                                        rmsnorm(p["ln"], x, cfg.norm_eps),
                                        ssm_state, cfg.ssm)
    if cfg.lif is not None:
        out, ssm_state["lif"] = _lif_decode(out, state["lif"], cfg)
    return x + out, ssm_state


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------

def init_lm(generator: torch.Generator, cfg: ArchConfig,
            device: str | torch.device | None = None):
    """Random parameters with the reference tree's keys and layouts, as
    :class:`~repro_torch.models.common.Leaf` leaves (``split_tree`` takes
    the tensors out), drawn from ``generator`` on its own device and placed
    on ``device`` (``None`` = the card, raising without one). The hybrid
    family's one weight-shared block sits under ``"shared"``."""
    device = resolve_device(device)
    _refuse_audio(cfg)
    p: Params = {"embed": init_embedding(generator, cfg.vocab_size,
                                         cfg.d_model, cfg.dtype, device),
                 "ln_f": init_rmsnorm(cfg.d_model, cfg.dtype, device)}
    block_init = {"rwkv": _init_rwkv_block,
                  "hybrid": _init_mamba_block}.get(cfg.family,
                                                   _init_dense_block)
    p["blocks"] = stack_layer_trees(
        [block_init(generator, cfg, device) for _ in range(cfg.num_layers)])
    if cfg.family == "hybrid":
        p["shared"] = _init_dense_block(generator, _shared_cfg(cfg), device)
    return p


# ---------------------------------------------------------------------------
# Forward (training / prefill)
# ---------------------------------------------------------------------------

def _hybrid_group_shape(cfg: ArchConfig) -> tuple[int, int]:
    """(groups, Mamba2 layers per group)."""
    k = cfg.hybrid_attn_every or cfg.num_layers
    if cfg.num_layers % k:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not form "
                         f"groups of {k}")
    return cfg.num_layers // k, k


def _regroup(tree, groups: int, per: int):
    """``(L, ...)`` leaves as ``(groups, per, ...)`` (views of contiguous
    leaves)."""
    return tree_map(lambda a: a.reshape(groups, per, *a.shape[1:]), tree)


def lm_forward(params: Params, batch: dict[str, torch.Tensor],
               cfg: ArchConfig, *, use_flash: bool = False):
    """batch: tokens (B, S) [+ patch_embeds (B, S, D) / patch_mask (B, S)
    for the VLM stub]. Returns (hidden (B, S, D), aux_loss).

    Under ``cfg.remat`` each RWKV or dense layer is recomputed in the
    backward, and each hybrid group as a whole (its Mamba2 layers and the
    shared block), as the reference checkpoints them."""
    _refuse_audio(cfg)
    check_lm_split(cfg)
    x = embed(params["embed"], batch["tokens"], cfg.dtype, table_shape(cfg))
    if cfg.vlm_stub and "patch_embeds" in batch:
        # pixtral: image patches arrive pre-embedded (frontend stub); merge.
        x = torch.where(batch["patch_mask"][..., None],
                        batch["patch_embeds"].to(cfg.dtype), x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if cfg.family == "rwkv":
        x, _ = lscan(cfg, lambda x, p: (_rwkv_block(p, x, cfg), None), x,
                     params["blocks"])
    elif cfg.family == "hybrid":
        s_cfg = _shared_cfg(cfg)

        def group(x, gp):
            x, _ = lscan(cfg, lambda x, p: (_mamba_block(p, x, cfg), None),
                         x, gp, remat=False)
            return _dense_block(params["shared"], x, s_cfg,
                                use_flash=use_flash)[0], None
        x, _ = lscan(cfg, group, x,
                     _regroup(params["blocks"], *_hybrid_group_shape(cfg)))
    else:
        def body(x, p):
            return _dense_block(p, x, cfg, use_flash=use_flash)
        x, auxs = lscan(cfg, body, x, params["blocks"])
        aux = auxs.sum()
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return x, aux


def lm_loss(params: Params, batch: dict[str, torch.Tensor], cfg: ArchConfig,
            aux_weight: float = 0.01):
    """Next-token cross entropy (+ ``aux_weight`` times the forward's
    auxiliary loss, 0 but for the moe family): ``(loss, metrics)``, the
    metrics detached. ``batch``: tokens and labels (B, S), optional
    ``loss_mask`` (B, S)."""
    x, aux = lm_forward(params, batch, cfg, use_flash=cfg.flash_train)
    logits = unembed(params["embed"], x, table_shape(cfg))
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"),
                              cfg.vocab_size)
    total = loss + aux_weight * aux
    mean_abs = logits.detach().abs().mean()
    if table_split(params["embed"]["table"], table_shape(cfg)) == "vocab":
        # the mean over every rank's equal part of the vocabulary
        mean_abs = gather_vocab(mean_abs[None]).mean()
    return total, {"loss": loss.detach(), "aux_loss": aux.detach(),
                   "logits_mean_abs": mean_abs}


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode against a stacked per-layer cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device: str | torch.device | None = None):
    """Stacked (L, ...) decode state matching the family (``device=None`` =
    the card).

    dense / moe / vlm: the attention cache, {"k","v"}, or with ``cfg.mla``
    the latent cache {"c","kr"}; rwkv: {"time": {"s","x_prev"}, "chan"};
    hybrid: {"mamba": {"h","conv"} as (groups, per, ...), "shared": the
    shared block's attention cache (groups, ...)}. With ``cfg.lif`` every
    layer's state also holds the branch neuron's {"u","s"} membrane state
    under "lif" (the KV-cache analogue for neurons; a dense layer nests its
    attention cache under "kv" beside it), as in the reference.
    """
    device = resolve_device(device)
    _refuse_audio(cfg)

    def stacked(tree, *lead):
        return tree_map(lambda a: a.repeat(*lead, *([1] * a.ndim)), tree)

    def with_lif(st: dict):
        if cfg.lif is not None:
            st["lif"] = _init_lif_state(batch, cfg, dtype, device)
        return st

    if cfg.family == "rwkv":
        return stacked(with_lif({
            "time": rwkv_mod.init_rwkv_state(batch, cfg.rwkv, dtype, device),
            "chan": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                                device=device)}), cfg.num_layers)
    if cfg.family == "hybrid":
        groups, per = _hybrid_group_shape(cfg)
        return {"mamba": stacked(with_lif(ssm_mod.init_ssm_state(
                    batch, cfg.ssm, dtype, device)), groups, per),
                "shared": stacked(attn_mod.init_kv_cache(
                    batch, cfg.attn, max_seq, dtype, device), groups)}
    if cfg.mla is not None:
        kv = mla_mod.init_mla_cache(batch, cfg.mla, max_seq, dtype, device)
    else:
        kv = attn_mod.init_kv_cache(batch, cfg.attn, max_seq, dtype, device)
    return stacked(with_lif({"kv": kv}) if cfg.lif is not None else kv,
                   cfg.num_layers)


def cache_batch_axes(cfg: ArchConfig, cache):
    """Per-leaf slot(=batch)-axis index, same structure as ``cache``: every
    leaf is stacked ``(L, slots, ...)`` except the hybrid family's Mamba2
    states, which are ``(groups, per, slots, ...)``."""
    _refuse_audio(cfg)
    if cfg.family == "hybrid":
        return {"mamba": tree_map(lambda _: 2, cache["mamba"]),
                "shared": tree_map(lambda _: 1, cache["shared"])}
    return tree_map(lambda _: 1, cache)


def reset_cache_slots(cache, slot_mask: torch.Tensor, cfg: ArchConfig):
    """Reset the masked slots' decode state to init without disturbing the
    neighbouring slots. Every family's init state is all-zeros (attention
    KV, MLA latent, RWKV and SSM recurrences, LIF membrane), so reset is a
    masked zero-fill along each leaf's slot axis. ``slot_mask``: (slots,)
    bool. Returns a new cache."""
    axes = cache_batch_axes(cfg, cache)

    def reset(a, ax):
        m = slot_mask.reshape((1,) * ax + (-1,) + (1,) * (a.ndim - ax - 1))
        return torch.where(m, torch.zeros((), dtype=a.dtype, device=a.device),
                           a)

    return tree_map(reset, cache, axes)


def cache_slot_state(cache, slot: int, cfg: ArchConfig):
    """One slot's slice of the decode cache (test/debug helper)."""
    axes = cache_batch_axes(cfg, cache)
    return tree_map(lambda a, ax: a.select(ax, slot), cache, axes)


def lm_decode_step(params: Params, cache, tokens: torch.Tensor,
                   pos: torch.Tensor, cfg: ArchConfig):
    """tokens: (B, 1) -> (logits (B, V), new cache). pos: (B,). The cache
    passed in is not modified. On a model axis the cache holds the rank's
    part (its kv heads, positions or columns: ``attention.decode_mode``)
    and the logits are gathered whole."""
    _refuse_audio(cfg)
    check_lm_split(cfg)
    x = embed(params["embed"], tokens, cfg.dtype, table_shape(cfg))

    if cfg.family == "rwkv":
        def body(x, ps):
            p, st = ps
            return _rwkv_block_decode(p, x, st, cfg)
        x, cache = lscan(cfg, body, x, (params["blocks"], cache))
    elif cfg.family == "hybrid":
        s_cfg = _shared_cfg(cfg)

        def inner(x, ps):
            p, st = ps
            return _mamba_block_decode(p, x, st, cfg)

        def group(x, ps):
            gp, st_m, st_a = ps
            x, st_m = lscan(cfg, inner, x, (gp, st_m))
            x, st_a = _dense_block_decode(params["shared"], x, st_a, pos,
                                          s_cfg)
            return x, (st_m, st_a)
        blocks = _regroup(params["blocks"], *_hybrid_group_shape(cfg))
        x, (st_m, st_a) = lscan(cfg, group, x,
                                (blocks, cache["mamba"], cache["shared"]))
        cache = {"mamba": st_m, "shared": st_a}
    else:
        def body(x, ps):
            p, st = ps
            return _dense_block_decode(p, x, st, pos, cfg)
        x, cache = lscan(cfg, body, x, (params["blocks"], cache))
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return gather_vocab(unembed(params["embed"], x[:, 0], table_shape(cfg)),
                        cfg.vocab_size), cache


def lm_prefill(params: Params, batch: dict[str, torch.Tensor],
               cfg: ArchConfig):
    """Inference forward over a prompt; returns last-position logits
    (whole, gathered over a model axis)."""
    x, _ = lm_forward(params, batch, cfg,
                      use_flash=batch["tokens"].shape[1] > 8192)
    return gather_vocab(unembed(params["embed"], x[:, -1], table_shape(cfg)),
                        cfg.vocab_size)
