"""Whisper-style encoder-decoder backbone (arXiv:2212.04356; the
counterpart of ``repro.models.encdec``).

As in the reference, the conv audio frontend is a stub: the caller hands
over precomputed frame embeddings (B, S_enc, D). The backbone is the real
thing: a sinusoidal-position encoder (non-causal MHA + GELU MLP) and a
decoder with causal self-attention and cross-attention, served with a
self-attention KV cache plus a cross-attention memory computed once from
the encoder's output.

The family never reads ``cfg.lif``: no kernel of the port runs here (the
reference's path reaches no Pallas kernel either). The products are
``torch.matmul`` / ``einsum``. Under ``cfg.remat`` each layer is
recomputed in the backward by :func:`~repro_torch.models.common.lscan`,
the reference's ``jax.checkpoint`` of the scanned body.

Entry points:
  init_encdec(generator, cfg, device)            -> augmented param tree
  encode(params, frames, cfg)                    -> encoder output
  decode_train(params, tokens, enc_out, cfg)     -> decoder hidden states
  encdec_loss(params, batch, cfg)                -> (loss, metrics)
  init_encdec_cache(params, frames, cfg, batch, max_seq) -> decode cache
  encdec_decode_step(params, cache, tokens, pos, cfg) -> (logits, cache)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.backend import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (cross_entropy_loss, embed,
                                       init_embedding, init_layernorm,
                                       layernorm, lscan, stack_layer_trees,
                                       tree_map, unembed)
from repro_torch.models.mlp import gelu_mlp, init_gelu_mlp

Params = dict[str, Any]


def sinusoid_pos(seq: int, dim: int,
                 device: str | torch.device = "cpu") -> torch.Tensor:
    """(seq, dim) fp32: the sines of ``pos / 10000^(2i/dim)``, then the
    cosines."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    inv = torch.exp(-math.log(10000.0) * torch.arange(
        0, dim, 2, dtype=torch.float32, device=device) / dim)[None]
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_attn_cfg(cfg: ArchConfig) -> attn_mod.AttnConfig:
    return dataclasses.replace(cfg.attn, causal=False, use_rope=False)


def _dec_attn_cfg(cfg: ArchConfig) -> attn_mod.AttnConfig:
    return dataclasses.replace(cfg.attn, use_rope=False)


def init_cross_attention(generator, cfg: ArchConfig, device="cpu"):
    return attn_mod.init_attention(generator, _enc_attn_cfg(cfg), cfg.dtype,
                                   device)


def cross_attention(params, x: torch.Tensor, mem_k: torch.Tensor,
                    mem_v: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, Sd, D); mem_k / mem_v: precomputed (B, Se, HK, dh)."""
    acfg = _enc_attn_cfg(cfg)
    q = attn_mod._project(x, params["wq"])
    n_rep = acfg.n_heads // acfg.n_kv_heads
    k = attn_mod._repeat_kv(mem_k.to(x.dtype), n_rep)
    v = attn_mod._repeat_kv(mem_v.to(x.dtype), n_rep)
    logits = torch.einsum("bshe,bthe->bhst", q, k).float() \
        * acfg.d_head ** -0.5
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhst,bthe->bshe", probs, v)
    return attn_mod._out_proj(out, params["wo"])


def cross_memory(params, enc_out: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention's keys and values of the encoder output,
    (B, Se, HK, dh) each."""
    return (attn_mod._project(enc_out, params["wk"]),
            attn_mod._project(enc_out, params["wv"]))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_encdec(generator: torch.Generator, cfg: ArchConfig,
                device: str | torch.device | None = None):
    """Random parameters with the reference tree's keys and layouts
    (``embed``, ``enc_blocks``, ``dec_blocks``, ``ln_enc``, ``ln_dec``) as
    :class:`~repro_torch.models.common.Leaf` leaves, drawn from
    ``generator`` on its own device and placed on ``device`` (``None`` =
    the card, raising without one)."""
    device = resolve_device(device)
    d = cfg.d_model

    def enc_block():
        return {"ln1": init_layernorm(d, cfg.dtype, device),
                "attn": attn_mod.init_attention(generator, _enc_attn_cfg(cfg),
                                                cfg.dtype, device),
                "ln2": init_layernorm(d, cfg.dtype, device),
                "mlp": init_gelu_mlp(generator, d, cfg.d_ff, cfg.dtype,
                                     device)}

    def dec_block():
        return {"ln1": init_layernorm(d, cfg.dtype, device),
                "self": attn_mod.init_attention(generator, _dec_attn_cfg(cfg),
                                                cfg.dtype, device),
                "ln2": init_layernorm(d, cfg.dtype, device),
                "cross": init_cross_attention(generator, cfg, device),
                "ln3": init_layernorm(d, cfg.dtype, device),
                "mlp": init_gelu_mlp(generator, d, cfg.d_ff, cfg.dtype,
                                     device)}

    return {
        "embed": init_embedding(generator, cfg.vocab_size, d, cfg.dtype,
                                device),
        "enc_blocks": stack_layer_trees(
            [enc_block() for _ in range(cfg.encoder_layers)]),
        "dec_blocks": stack_layer_trees(
            [dec_block() for _ in range(cfg.num_layers)]),
        "ln_enc": init_layernorm(d, cfg.dtype, device),
        "ln_dec": init_layernorm(d, cfg.dtype, device),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def encode(params: Params, frames: torch.Tensor,
           cfg: ArchConfig) -> torch.Tensor:
    """frames: (B, Se, D) precomputed frame embeddings (conv frontend
    stub)."""
    x = frames.to(cfg.dtype) + sinusoid_pos(
        frames.shape[1], cfg.d_model, frames.device).to(cfg.dtype)[None]
    acfg = _enc_attn_cfg(cfg)

    def body(x, p):
        h = layernorm(p["ln1"], x, cfg.norm_eps)
        x = x + attn_mod.attention(p["attn"], h, acfg)
        h = layernorm(p["ln2"], x, cfg.norm_eps)
        return x + gelu_mlp(p["mlp"], h), None

    x, _ = lscan(cfg, body, x, params["enc_blocks"])
    return layernorm(params["ln_enc"], x, cfg.norm_eps)


def decode_train(params: Params, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ArchConfig, *, use_flash: bool | None = None
                 ) -> torch.Tensor:
    """The decoder over whole (B, Sd) token sequences (teacher forcing):
    hidden states (B, Sd, D). ``use_flash=None`` takes the chunked
    self-attention above 8192 tokens."""
    x = embed(params["embed"], tokens, cfg.dtype)
    x = x + sinusoid_pos(tokens.shape[1], cfg.d_model,
                         x.device).to(cfg.dtype)[None]
    acfg = _dec_attn_cfg(cfg)
    if use_flash is None:
        use_flash = tokens.shape[1] > 8192
    self_attn = attn_mod.flash_attention if use_flash else attn_mod.attention

    def body(x, p):
        h = layernorm(p["ln1"], x, cfg.norm_eps)
        x = x + self_attn(p["self"], h, acfg)
        h = layernorm(p["ln2"], x, cfg.norm_eps)
        mk, mv = cross_memory(p["cross"], enc_out)
        x = x + cross_attention(p["cross"], h, mk, mv, cfg)
        h = layernorm(p["ln3"], x, cfg.norm_eps)
        return x + gelu_mlp(p["mlp"], h), None

    x, _ = lscan(cfg, body, x, params["dec_blocks"])
    return layernorm(params["ln_dec"], x, cfg.norm_eps)


def encdec_loss(params: Params, batch: dict[str, torch.Tensor],
                cfg: ArchConfig):
    """Next-token cross entropy of the decoder over the encoded frames:
    ``(loss, {"loss"})``, the metric detached. ``batch``: frames (B, Se,
    D), tokens and labels (B, Sd), optional ``loss_mask`` (B, Sd)."""
    enc_out = encode(params, batch["frames"], cfg)
    x = decode_train(params, batch["tokens"], enc_out, cfg)
    logits = unembed(params["embed"], x)
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))
    return loss, {"loss": loss.detach()}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_encdec_cache(params: Params, frames: torch.Tensor, cfg: ArchConfig,
                      batch: int, max_seq: int, dtype=torch.bfloat16):
    """Runs the encoder once and precomputes each decoder layer's cross
    memory: ``{"self": {"k","v"} (L, B, max_seq, HK, dh) zeros, "cross":
    {"mk","mv"} (L, B, Se, HK, dh)}``, in ``dtype``, on ``frames``'
    device."""
    enc_out = encode(params, frames, cfg)

    def scan_mem(_, p):
        mk, mv = cross_memory(p["cross"], enc_out)
        return None, {"mk": mk.to(dtype), "mv": mv.to(dtype)}
    _, cross = lscan(cfg, scan_mem, None, params["dec_blocks"])

    self_cache = tree_map(
        lambda a: a[None].repeat(cfg.num_layers, *([1] * a.ndim)),
        attn_mod.init_kv_cache(batch, _dec_attn_cfg(cfg), max_seq, dtype,
                               frames.device))
    return {"self": self_cache, "cross": cross}


def encdec_decode_step(params: Params, cache, tokens: torch.Tensor,
                       pos: torch.Tensor, cfg: ArchConfig):
    """One decoder token against the cached encoder memory. tokens: (B, 1);
    pos: (B,). Returns (logits (B, V), new cache); the cache passed in is
    not modified."""
    x = embed(params["embed"], tokens, cfg.dtype)
    pos_emb = sinusoid_pos(cache["self"]["k"].shape[2], cfg.d_model,
                           x.device)
    x = x + pos_emb[pos.long()][:, None].to(cfg.dtype)
    acfg = _dec_attn_cfg(cfg)

    def body(x, ps):
        p, st, xm = ps
        h = layernorm(p["ln1"], x, cfg.norm_eps)
        a, st = attn_mod.attention_decode(p["self"], h, st, pos, acfg)
        x = x + a
        h = layernorm(p["ln2"], x, cfg.norm_eps)
        x = x + cross_attention(p["cross"], h, xm["mk"], xm["mv"], cfg)
        h = layernorm(p["ln3"], x, cfg.norm_eps)
        return x + gelu_mlp(p["mlp"], h), st

    x, self_cache = lscan(
        cfg, body, x, (params["dec_blocks"], cache["self"], cache["cross"]))
    x = layernorm(params["ln_dec"], x, cfg.norm_eps)
    logits = unembed(params["embed"], x[:, 0])
    return logits, {"self": self_cache, "cross": cache["cross"]}
