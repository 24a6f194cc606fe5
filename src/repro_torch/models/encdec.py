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

On a model axis (the ambient mesh) the encoder's and the decoder's
self-attention take the attention's schemes, the cross-attention the
decoder's (:func:`_cross_train`), the GELU MLP is Megatron's with
``b_out`` added after the sum, and the embedding table is vocab-parallel
or, where the axis does not divide the vocabulary (whisper's 51866),
split on D (``common.table_split``: each rank's columns of the rows
gathered, the logits' partial products summed, whole on every rank).
The decode cache is the rank's part as ``launch.specs.cache_structs``
lays it out, the cross memory included (:func:`cross_attention`).

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
from repro_torch.models.common import (cache_model_dim, copy_to_model,
                                       cross_entropy_loss, embed,
                                       gather_vocab, init_embedding,
                                       init_layernorm, layernorm, lscan,
                                       model_coord, rank_part,
                                       stack_layer_trees, table_shape,
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
    """x: (B, Sd, D); mem_k / mem_v: precomputed (B, Se, HK, dh), no
    write (decode's cross-attention over the cached memory).

    On a model axis the memory holds the rank's part as ``cache_structs``
    lays it out, and the step takes the self cache's modes
    (``attention.decode_mode``): the rank's kv heads, flash-decode over
    its encoder positions, or its head_dim columns (the logits' partial
    sums added before the softmax); the query comes whole from the stored
    slices and the memory is never gathered. Without a model axis the
    memory is whole and every region op the identity."""
    acfg = _enc_attn_cfg(cfg)
    mode = attn_mod.decode_mode(acfg, mem_k)
    d, h, dh = acfg.d_model, acfg.n_heads, acfg.d_head
    heads = attn_mod._heads(acfg) if mode == "heads" else None
    if mode in ("seq", "head_dim"):
        q = attn_mod._project_gathered(x, params["wq"], (d, h, dh))
    else:
        q = attn_mod._project(copy_to_model(x), params["wq"])
    q = rank_part(q, 3, mem_k.shape[3])
    k, v = (attn_mod._expand_kv(t.to(x.dtype), acfg, heads)
            for t in (mem_k, mem_v))
    out = attn_mod.decode_attend(q, k, v, mode, acfg)
    return attn_mod.out_decode(out, params["wo"], mode, acfg)


def cross_memory(params, enc_out: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention's keys and values of the encoder output,
    (B, Se, HK, dh) each."""
    return (attn_mod._project(enc_out, params["wk"]),
            attn_mod._project(enc_out, params["wv"]))


def _cross_train(params, x: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """The cross-attention of the decoder's (B, Sd, D) over the encoder
    output, its memory made from ``enc_out``. On a model axis it takes the
    decoder's scheme (``attention.attn_scheme`` at Sd): "heads" (the
    rank's query heads and the kv heads they read make the memory,
    ``enc_out`` and x enter the region, ``wo``'s rows summed), "seq" (q
    for the rank's rows against the whole memory, the rows gathered) or
    "none" (all of it on every rank); without one the memory is made
    whole and every region op is the identity."""
    acfg = _enc_attn_cfg(cfg)
    scheme = attn_mod.attn_scheme(acfg, x.shape[1])
    d, h, hk, dh = acfg.d_model, acfg.n_heads, acfg.n_kv_heads, acfg.d_head
    heads, q0 = None, 0
    if scheme in ("heads", "seq"):
        x, enc_out = copy_to_model(x), copy_to_model(enc_out)
    if scheme == "heads":
        heads = attn_mod._heads(acfg)
        wk, wv = (attn_mod._kv_part(params[k], (d, hk, dh), 1, heads[2],
                                    heads[3]) for k in ("wk", "wv"))
        params = {**params, "wk": wk, "wv": wv}
    elif scheme is not None:
        params = attn_mod._whole_params(params, acfg,
                                        summed=scheme == "seq")
    if scheme == "seq":
        r, m = model_coord()
        n = x.shape[1] // m
        q0, x = r * n, x.narrow(1, r * n, n)
    mk, mv = cross_memory(params, enc_out)
    q = attn_mod._project(x, params["wq"])
    k, v = (attn_mod._expand_kv(t.to(x.dtype), acfg, heads)
            for t in (mk, mv))
    logits = torch.einsum("bshe,bthe->bhst", q, k).float() * dh ** -0.5
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhst,bthe->bshe", probs, v)
    return attn_mod._leave(out, params["wo"], scheme)


def _model_part(x: torch.Tensor, dim: int | None) -> torch.Tensor:
    """This model rank's part of a whole tensor along ``dim``, a
    contiguous copy; ``x`` where ``dim`` is ``None``."""
    if dim is None:
        return x
    return rank_part(x, dim, x.shape[dim] // model_coord()[1]).contiguous()


def _layer_memory(p, enc_out: torch.Tensor, cfg: ArchConfig,
                  dim: int | None):
    """One decoder layer's cross memory (B, Se, HK, dh) as the rank holds
    it, split along ``dim`` (``None``: whole): projected with the rank's
    stored ``wk`` / ``wv`` where they hold the same heads or head_dim
    columns as the memory, else projected whole from the stored slices
    (activations gathered) and cut."""
    acfg = _enc_attn_cfg(cfg)
    whole = (acfg.d_model, acfg.n_kv_heads, acfg.d_head)
    out = []
    for k in ("wk", "wv"):
        w = p[k]
        stored = next((i for i, (a, b) in enumerate(zip(w.shape, whole))
                       if a != b), None)
        if dim is not None and stored is not None and dim == stored + 1:
            out.append(attn_mod._project(enc_out, w))
        else:
            out.append(_model_part(attn_mod._project_gathered(enc_out, w,
                                                              whole), dim))
    return out


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
        return x + gelu_mlp(p["mlp"], copy_to_model(h)), None

    x, _ = lscan(cfg, body, x, params["enc_blocks"])
    return layernorm(params["ln_enc"], x, cfg.norm_eps)


def decode_train(params: Params, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ArchConfig, *, use_flash: bool | None = None
                 ) -> torch.Tensor:
    """The decoder over whole (B, Sd) token sequences (teacher forcing):
    hidden states (B, Sd, D). ``use_flash=None`` takes the chunked
    self-attention above 8192 tokens."""
    x = embed(params["embed"], tokens, cfg.dtype, table_shape(cfg))
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
        x = x + _cross_train(p["cross"], h, enc_out, cfg)
        h = layernorm(p["ln3"], x, cfg.norm_eps)
        return x + gelu_mlp(p["mlp"], copy_to_model(h)), None

    x, _ = lscan(cfg, body, x, params["dec_blocks"])
    return layernorm(params["ln_dec"], x, cfg.norm_eps)


def encdec_loss(params: Params, batch: dict[str, torch.Tensor],
                cfg: ArchConfig):
    """Next-token cross entropy of the decoder over the encoded frames:
    ``(loss, {"loss"})``, the metric detached. ``batch``: frames (B, Se,
    D), tokens and labels (B, Sd), optional ``loss_mask`` (B, Sd)."""
    enc_out = encode(params, batch["frames"], cfg)
    x = decode_train(params, batch["tokens"], enc_out, cfg)
    logits = unembed(params["embed"], x, table_shape(cfg))
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"),
                              cfg.vocab_size)
    return loss, {"loss": loss.detach()}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_encdec_cache(params: Params, frames: torch.Tensor, cfg: ArchConfig,
                      batch: int, max_seq: int, dtype=torch.bfloat16):
    """Runs the encoder once and precomputes each decoder layer's cross
    memory: ``{"self": {"k","v"} (L, B, max_seq, HK, dh) zeros, "cross":
    {"mk","mv"} (L, B, Se, HK, dh)}``, in ``dtype``, on ``frames``'
    device. On a model axis each leaf is the rank's part as
    ``launch.specs.cache_structs`` lays it out
    (``common.cache_model_dim``: the memory on its kv heads, else its
    encoder positions, else its head_dim columns), the memory projected
    per layer (:func:`_layer_memory`)."""
    enc_out = encode(params, frames, cfg)
    acfg = _dec_attn_cfg(cfg)
    m = model_coord()[1]

    def split_dim(shape):       # of a stacked (L, B, S, HK, dh) leaf
        return None if m == 1 else cache_model_dim(shape, m,
                                                   cfg.cache_shard)
    mem_dim = split_dim((cfg.num_layers, batch, frames.shape[1],
                         acfg.n_kv_heads, acfg.d_head))

    def scan_mem(_, p):
        mk, mv = _layer_memory(p["cross"], enc_out, cfg,
                               None if mem_dim is None else mem_dim - 1)
        return None, {"mk": mk.to(dtype), "mv": mv.to(dtype)}
    _, cross = lscan(cfg, scan_mem, None, params["dec_blocks"])

    self_cache = tree_map(
        lambda a: a[None].repeat(cfg.num_layers, *([1] * a.ndim)),
        attn_mod.init_kv_cache(batch, acfg, max_seq, dtype, frames.device))
    self_cache = {k: _model_part(v, split_dim(v.shape))
                  for k, v in self_cache.items()}
    return {"self": self_cache, "cross": cross}


def encdec_decode_step(params: Params, cache, tokens: torch.Tensor,
                       pos: torch.Tensor, cfg: ArchConfig):
    """One decoder token against the cached encoder memory. tokens: (B, 1);
    pos: (B,). Returns (logits (B, V), new cache); the cache passed in is
    not modified."""
    x = embed(params["embed"], tokens, cfg.dtype, table_shape(cfg))
    acfg = _dec_attn_cfg(cfg)
    s_cache = cache["self"]["k"].shape[2]
    if attn_mod.decode_mode(acfg, cache["self"]["k"][0]) == "seq":
        s_cache *= model_coord()[1]     # the rank's positions of the cache
    pos_emb = sinusoid_pos(s_cache, cfg.d_model, x.device)
    x = x + pos_emb[pos.long()][:, None].to(cfg.dtype)

    def body(x, ps):
        p, st, xm = ps
        h = layernorm(p["ln1"], x, cfg.norm_eps)
        a, st = attn_mod.attention_decode(p["self"], h, st, pos, acfg)
        x = x + a
        h = layernorm(p["ln2"], x, cfg.norm_eps)
        x = x + cross_attention(p["cross"], h, xm["mk"], xm["mv"], cfg)
        h = layernorm(p["ln3"], x, cfg.norm_eps)
        return x + gelu_mlp(p["mlp"], copy_to_model(h)), st

    x, self_cache = lscan(
        cfg, body, x, (params["dec_blocks"], cache["self"], cache["cross"]))
    x = layernorm(params["ln_dec"], x, cfg.norm_eps)
    logits = gather_vocab(unembed(params["embed"], x[:, 0], table_shape(cfg)),
                          cfg.vocab_size)
    return logits, {"self": self_cache, "cross": cache["cross"]}
