"""Decoder LM assembled from an ArchConfig (the counterpart of
``repro.models.lm``), the dense and moe families.

A block is pre-norm attention (GQA, or MLA with ``cfg.mla``) + pre-norm
FFN (SwiGLU, or the mixture of experts with ``cfg.moe``), with the layer
leaves stacked on a leading ``(L, ...)`` axis and looped over (the
reference scans over it). With ``cfg.lif`` set it is the spiking LM: the
E2ATST LIF neuron sits on every block's FFN branch (site ``lm.ffn.lif``),
with the sequence axis as the neuron's time axis in the forward and its
``(U, S)`` state carried in the serving cache in decode.

The other families (``rwkv``, ``hybrid``, ``audio``, ``vlm``) are still to
port (ROADMAP A9): their entry points raise ``NotImplementedError``, they
never run something else.

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
from repro_torch.models.common import (cross_entropy_loss, embed,
                                       init_embedding, init_rmsnorm, lscan,
                                       rmsnorm, stack_layer_trees, tree_map,
                                       unembed)
from repro_torch.models.mlp import init_swiglu, swiglu

Params = dict[str, Any]


def _require_ported(cfg: ArchConfig) -> None:
    """Raise for every architecture but the dense and moe families."""
    what = [n for n, on in (("family " + repr(cfg.family),
                             cfg.family not in ("dense", "moe")),
                            ("the VLM stub", cfg.vlm_stub)) if on]
    if what:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(what)} is not ported yet (ROADMAP A9); "
            f"repro_torch.models.lm runs the dense and moe families")


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
    SwiGLU))."""
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
        f = swiglu(p["ffn"], h)
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
        f = swiglu(p["ffn"], h)
    if cfg.lif is not None:
        f, lif_st = _lif_decode(f, cache["lif"], cfg)
        return x + f, {"kv": kv, "lif": lif_st}
    return x + f, kv


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------

def init_lm(generator: torch.Generator, cfg: ArchConfig,
            device: str | torch.device | None = None):
    """Random parameters with the reference tree's keys and layouts, as
    :class:`~repro_torch.models.common.Leaf` leaves (``split_tree`` takes
    the tensors out), drawn from ``generator`` on its own device and placed
    on ``device`` (``None`` = the card, raising without one)."""
    device = resolve_device(device)
    _require_ported(cfg)
    p: Params = {"embed": init_embedding(generator, cfg.vocab_size,
                                         cfg.d_model, cfg.dtype, device),
                 "ln_f": init_rmsnorm(cfg.d_model, cfg.dtype, device)}
    p["blocks"] = stack_layer_trees(
        [_init_dense_block(generator, cfg, device)
         for _ in range(cfg.num_layers)])
    return p


# ---------------------------------------------------------------------------
# Forward (training / prefill)
# ---------------------------------------------------------------------------

def lm_forward(params: Params, batch: dict[str, torch.Tensor],
               cfg: ArchConfig, *, use_flash: bool = False):
    """batch: tokens (B, S). Returns (hidden (B, S, D), aux_loss)."""
    _require_ported(cfg)
    x = embed(params["embed"], batch["tokens"], cfg.dtype)

    def body(x, p):
        return _dense_block(p, x, cfg, use_flash=use_flash)
    x, auxs = lscan(cfg, body, x, params["blocks"])
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return x, auxs.sum()


def lm_loss(params: Params, batch: dict[str, torch.Tensor], cfg: ArchConfig,
            aux_weight: float = 0.01):
    """Next-token cross entropy (+ ``aux_weight`` times the forward's
    auxiliary loss, 0 for the dense family): ``(loss, metrics)``, the
    metrics detached. ``batch``: tokens and labels (B, S), optional
    ``loss_mask`` (B, S)."""
    x, aux = lm_forward(params, batch, cfg, use_flash=cfg.flash_train)
    logits = unembed(params["embed"], x)
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))
    total = loss + aux_weight * aux
    return total, {"loss": loss.detach(), "aux_loss": aux.detach(),
                   "logits_mean_abs": logits.detach().abs().mean()}


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode against a stacked per-layer cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device: str | torch.device | None = None):
    """Stacked (L, ...) decode state (``device=None`` = the card).

    Without ``cfg.lif`` it is the attention cache, {"k","v"}, or with
    ``cfg.mla`` the latent cache {"c","kr"}; with it, every layer nests
    that cache under "kv" next to the branch neuron's {"u","s"} membrane
    state under "lif" (the KV-cache analogue for neurons), as in the
    reference.
    """
    device = resolve_device(device)
    _require_ported(cfg)
    n = cfg.num_layers

    def stacked(tree):
        return tree_map(lambda a: a[None].repeat(n, *([1] * a.ndim)), tree)

    if cfg.mla is not None:
        kv = mla_mod.init_mla_cache(batch, cfg.mla, max_seq, dtype, device)
    else:
        kv = attn_mod.init_kv_cache(batch, cfg.attn, max_seq, dtype, device)
    if cfg.lif is not None:
        return stacked({"kv": kv,
                        "lif": _init_lif_state(batch, cfg, dtype, device)})
    return stacked(kv)


def cache_batch_axes(cfg: ArchConfig, cache):
    """Per-leaf slot(=batch)-axis index, same structure as ``cache``: every
    leaf of the dense and moe families (attention KV, MLA latent, LIF
    membrane) is stacked ``(L, slots, ...)``."""
    _require_ported(cfg)
    return tree_map(lambda _: 1, cache)


def reset_cache_slots(cache, slot_mask: torch.Tensor, cfg: ArchConfig):
    """Reset the masked slots' decode state to init without disturbing the
    neighbouring slots. The init state is all-zeros (attention KV, MLA
    latent, LIF membrane), so reset is a masked zero-fill along each leaf's
    slot axis. ``slot_mask``: (slots,) bool. Returns a new cache."""
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
    passed in is not modified."""
    _require_ported(cfg)
    x = embed(params["embed"], tokens, cfg.dtype)

    def body(x, ps):
        p, st = ps
        return _dense_block_decode(p, x, st, pos, cfg)
    x, cache = lscan(cfg, body, x, (params["blocks"], cache))
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed(params["embed"], x[:, 0]), cache


def lm_prefill(params: Params, batch: dict[str, torch.Tensor],
               cfg: ArchConfig):
    """Inference forward over a prompt; returns last-position logits."""
    x, _ = lm_forward(params, batch, cfg,
                      use_flash=batch["tokens"].shape[1] > 8192)
    return unembed(params["embed"], x[:, -1])
