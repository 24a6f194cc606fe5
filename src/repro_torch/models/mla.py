"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434; the
counterpart of ``repro.models.mla``).

KV is compressed to a ``kv_lora``-dim latent c_kv plus one shared RoPE key
of ``qk_rope`` dims; the cache stores only (c_kv, k_rope) per token. Decode
uses the absorbed form: W_uk folds into the query and W_uv into the output
projection, so attention runs against the latent cache directly and no
per-head K/V is built. The products are ``torch.einsum``/``matmul``, as the
reference leaves its einsums to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.attention import _bias, _out_proj, flash_core
from repro_torch.models.common import (MODEL, apply_rope, init_rmsnorm,
                                       normal_leaf, rmsnorm)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6

    @property
    def qk_head(self) -> int:
        return self.qk_nope + self.qk_rope


def init_mla(generator, cfg: MLAConfig, dtype=torch.float32, device="cpu"):
    d, h = cfg.d_model, cfg.n_heads

    def leaf(shape, spec, **kw):
        return normal_leaf(generator, shape, spec, dtype=dtype, device=device,
                           **kw)
    return {
        "w_dq": leaf((d, cfg.q_lora), (None, MODEL)),
        "q_norm": init_rmsnorm(cfg.q_lora, dtype, device),
        "w_uq": leaf((cfg.q_lora, h, cfg.qk_head), (None, MODEL, None)),
        # joint down-projection: latent c_kv (kv_lora) + shared rope key
        "w_dkv": leaf((d, cfg.kv_lora + cfg.qk_rope), (None, None)),
        "kv_norm": init_rmsnorm(cfg.kv_lora, dtype, device),
        "w_uk": leaf((cfg.kv_lora, h, cfg.qk_nope), (None, MODEL, None)),
        "w_uv": leaf((cfg.kv_lora, h, cfg.v_head), (None, MODEL, None)),
        "wo": leaf((h, cfg.v_head, d), (MODEL, None, None),
                   scale=(h * cfg.v_head) ** -0.5),
    }


def _up(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, E) x (E, H, F) -> (B, S, H, F), one matmul."""
    e, h, f = w.shape
    return torch.matmul(c, w.to(c.dtype).reshape(e, h * f)).reshape(
        *c.shape[:-1], h, f)


def _latent(params, x: torch.Tensor, cfg: MLAConfig, positions):
    """x (B,S,D) -> (c_kv (B,S,kv_lora), k_rope (B,S,1,qk_rope))."""
    dkv = torch.matmul(x, params["w_dkv"].to(x.dtype))
    c_kv, k_rope = dkv[..., :cfg.kv_lora], dkv[..., cfg.kv_lora:]
    c_kv = rmsnorm(params["kv_norm"], c_kv, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_rope


def _queries(params, x: torch.Tensor, cfg: MLAConfig, positions):
    cq = torch.matmul(x, params["w_dq"].to(x.dtype))
    cq = rmsnorm(params["q_norm"], cq, cfg.norm_eps)
    q = _up(cq, params["w_uq"])
    q_nope, q_rope = q[..., :cfg.qk_nope], q[..., cfg.qk_nope:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _heads(params, x: torch.Tensor, cfg: MLAConfig):
    """The prefill's per-head tensors: q_nope, q_rope (B,S,H,·), k_nope,
    v (B,S,H,·) from the latent, and k_rope (B,S,1,qk_rope)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q_nope, q_rope = _queries(params, x, cfg, positions)
    c_kv, k_rope = _latent(params, x, cfg, positions)
    return (q_nope, q_rope, _up(c_kv, params["w_uk"]), _up(c_kv,
                                                            params["w_uv"]),
            k_rope)


def mla_attention(params, x: torch.Tensor, cfg: MLAConfig) -> torch.Tensor:
    """Training / prefill path (naive: per-head K/V and the (S, S) scores
    are built)."""
    s = x.shape[1]
    q_nope, q_rope, k_nope, v, k_rope = _heads(params, x, cfg)
    scale = cfg.qk_head ** -0.5
    logits = (torch.einsum("bshf,bthf->bhst", q_nope, k_nope) +
              torch.einsum("bshf,btof->bhst", q_rope, k_rope)
              ).float() * scale
    qi = torch.arange(s, device=x.device)
    logits = logits + _bias(qi[None, :] <= qi[:, None])[None, None]
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhst,bthf->bshf", probs, v)
    return _out_proj(out, params["wo"])


def mla_flash_attention(params, x: torch.Tensor, cfg: MLAConfig,
                        kv_chunk: int = 512) -> torch.Tensor:
    """Long-prefill MLA: per-head K/V are built (cheap: S*H*d) but the
    (S, S) scores never are; q and k concatenate their nope and rope dims
    and go through the shared :func:`flash_core`."""
    b, s, _ = x.shape
    q_nope, q_rope, k_nope, v, k_rope = _heads(params, x, cfg)
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    k_cat = torch.cat([k_nope, k_rope.expand(b, s, cfg.n_heads,
                                             cfg.qk_rope)], dim=-1)
    out = flash_core(q_cat, k_cat, v, scale=cfg.qk_head ** -0.5, causal=True,
                     kv_chunk=kv_chunk)
    return _out_proj(out, params["wo"])


def mla_decode(params, x: torch.Tensor, cache: dict[str, torch.Tensor],
               pos: torch.Tensor, cfg: MLAConfig
               ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Absorbed decode: scores = (q_nope W_uk^T) @ c_cache + q_rope @ k_rope.

    cache: {"c": (B, S, kv_lora), "kr": (B, S, qk_rope)}; x: (B, 1, D);
    pos: (B,). The new latent is written at ``pos`` by the reference's
    one-hot blend; the cache passed in is not modified.
    """
    q_nope, q_rope = _queries(params, x, cfg, pos[:, None])
    c_new, kr_new = _latent(params, x, cfg, pos[:, None])

    s_cache = cache["c"].shape[1]
    idx = torch.arange(s_cache, device=x.device)
    onehot = (idx[None, :] == pos[:, None]).to(cache["c"].dtype)  # (B, S)
    oh = onehot[..., None]
    c = cache["c"] * (1 - oh) + oh * c_new[:, 0:1].to(cache["c"].dtype)
    kr = cache["kr"] * (1 - oh) + oh * kr_new[:, 0].to(cache["kr"].dtype)

    # absorb W_uk into the query: (B,1,H,nope) x (kv_lora,H,nope) -> latent q
    q_lat = torch.einsum("bshf,ehf->bshe", q_nope,
                         params["w_uk"].to(x.dtype))       # (B,1,H,kv_lora)
    scale = cfg.qk_head ** -0.5
    logits = (torch.einsum("bshe,bte->bhst", q_lat, c.to(x.dtype)) +
              torch.einsum("bshf,btf->bhst", q_rope, kr.to(x.dtype))
              ).float() * scale
    logits = logits + _bias(idx[None] <= pos[:, None])[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    # attend in latent space, then absorb W_uv on the way out
    out_lat = torch.einsum("bhst,bte->bshe", probs, c.to(x.dtype))
    out = torch.einsum("bshe,ehf->bshf", out_lat,
                       params["w_uv"].to(x.dtype))         # (B,1,H,v_head)
    return _out_proj(out, params["wo"]), {"c": c, "kr": kr}


def init_mla_cache(batch: int, cfg: MLAConfig, max_seq: int,
                   dtype=torch.bfloat16, device="cpu"
                   ) -> dict[str, torch.Tensor]:
    return {"c": torch.zeros((batch, max_seq, cfg.kv_lora), dtype=dtype,
                             device=device),
            "kr": torch.zeros((batch, max_seq, cfg.qk_rope), dtype=dtype,
                              device=device)}
