"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434; the
counterpart of ``repro.models.mla``).

KV is compressed to a ``kv_lora``-dim latent c_kv plus one shared RoPE key
of ``qk_rope`` dims; the cache stores only (c_kv, k_rope) per token. Decode
uses the absorbed form: W_uk folds into the query and W_uv into the output
projection, so attention runs against the latent cache directly and no
per-head K/V is built. The products are ``torch.einsum``/``matmul``, as the
reference leaves its einsums to XLA outside any Pallas kernel.

On a model axis of M (the ambient mesh) training and prefill take the
attention's scheme over MLA's heads (``attention.attn_scheme``): "heads"
(the rank's heads of ``w_uq`` / ``w_uk`` / ``w_uv`` and rows of ``wo``,
summed; ``w_dq`` gathered whole, its gradient reduce-scattered, since
``q_norm`` spans all of q_lora; the latent and the shared rope key whole
on every rank inside the region), "seq" (the rank's query rows against
the whole latent, as the attention's "seq") or "none". Decode reads its
mode off the latent cache (:func:`decode_mode`): flash-decode over the
rank's positions, or the rank's kv_lora columns; the latent cache is
never gathered.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch.mesh import gather_model, gather_seq
from repro_torch.models.attention import (_bias, _leave, _out_gathered,
                                          _out_proj, _project_gathered,
                                          attn_scheme, flash_core,
                                          merged_softmax, whole_leaf)
from repro_torch.models.common import (MODEL, apply_rope, copy_to_model,
                                       init_rmsnorm, matmul_whole,
                                       model_coord, normal_leaf, rank_part,
                                       reduce_from_model, rmsnorm,
                                       whole_part)


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


def _shapes(cfg: MLAConfig) -> dict[str, tuple[int, ...]]:
    """Every leaf's whole shape (the norms by their scale)."""
    d, h = cfg.d_model, cfg.n_heads
    return {"w_dq": (d, cfg.q_lora), "q_norm": (cfg.q_lora,),
            "w_uq": (cfg.q_lora, h, cfg.qk_head),
            "w_dkv": (d, cfg.kv_lora + cfg.qk_rope),
            "kv_norm": (cfg.kv_lora,), "w_uk": (cfg.kv_lora, h, cfg.qk_nope),
            "w_uv": (cfg.kv_lora, h, cfg.v_head), "wo": (h, cfg.v_head, d)}


def _region_params(params, cfg: MLAConfig, scheme):
    """The leaves as the scheme computes with them. "heads": ``w_dq``
    gathered whole (the plan stores it on q_lora; ``q_norm`` spans all of
    it), its gradient reduce-scattered, and the replicated ``q_norm``,
    ``w_dkv`` and ``kv_norm``, whose work each rank does inside the region
    for its heads, entering it; the per-head leaves are the rank's. "seq"
    and "none": every leaf whole (``attention.whole_leaf``), summed or
    not."""
    shapes = _shapes(cfg)

    def norm(k, summed):
        return {"scale": whole_leaf(params[k]["scale"], shapes[k], summed)}
    if scheme == "heads":
        return {**params,
                "w_dq": gather_model(params["w_dq"], shapes["w_dq"]),
                "w_dkv": copy_to_model(params["w_dkv"]),
                "q_norm": norm("q_norm", True),
                "kv_norm": norm("kv_norm", True)}
    summed = scheme == "seq"
    return {k: norm(k, summed) if k.endswith("norm") else
            whole_leaf(v, shapes[k], summed) for k, v in params.items()}


def _heads(params, x: torch.Tensor, cfg: MLAConfig, scheme=None):
    """The prefill's per-head tensors under ``scheme``
    (``attention.attn_scheme`` over MLA's heads): q_nope, q_rope
    (B,Sq,H,·) for the rows and heads the rank computes, k_nope, v
    (B,S,H,·) from the latent, k_rope (B,S,1,qk_rope), the first query
    row and the ``wo`` the scheme leaves through. The latent is computed
    for all S on every rank ("heads": inside the region)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    if scheme in ("heads", "seq"):
        x = copy_to_model(x)
    if scheme is not None:
        params = _region_params(params, cfg, scheme)
    xq, q_pos, q0 = x, positions, 0
    if scheme == "seq":
        r, m = model_coord()
        n = s // m
        q0 = r * n
        xq, q_pos = x.narrow(1, q0, n), positions.narrow(1, q0, n)
    q_nope, q_rope = _queries(params, xq, cfg, q_pos)
    c_kv, k_rope = _latent(params, x, cfg, positions)
    return (q_nope, q_rope, _up(c_kv, params["w_uk"]), _up(c_kv,
                                                            params["w_uv"]),
            k_rope, q0, params["wo"])


def mla_attention(params, x: torch.Tensor, cfg: MLAConfig) -> torch.Tensor:
    """Training / prefill path (naive: per-head K/V and the (S, S) scores
    are built), under the scheme ``attention.attn_scheme`` picks over
    MLA's heads on a model axis."""
    s = x.shape[1]
    scheme = attn_scheme(cfg, s)
    q_nope, q_rope, k_nope, v, k_rope, q0, wo = _heads(params, x, cfg,
                                                       scheme)
    scale = cfg.qk_head ** -0.5
    logits = (torch.einsum("bshf,bthf->bhst", q_nope, k_nope) +
              torch.einsum("bshf,btof->bhst", q_rope, k_rope)
              ).float() * scale
    qi = torch.arange(q_nope.shape[1], device=x.device) + q0
    ki = torch.arange(s, device=x.device)
    logits = logits + _bias(ki[None, :] <= qi[:, None])[None, None]
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhst,bthf->bshf", probs, v)
    return _leave(out, wo, scheme)


def mla_flash_attention(params, x: torch.Tensor, cfg: MLAConfig,
                        kv_chunk: int = 512) -> torch.Tensor:
    """Long-prefill MLA: per-head K/V are built (cheap: S*H*d) but the
    (S, S) scores never are; q and k concatenate their nope and rope dims
    and go through the shared :func:`flash_core` (the query rows at the
    scheme's offset)."""
    b, s, _ = x.shape
    scheme = attn_scheme(cfg, s)
    q_nope, q_rope, k_nope, v, k_rope, q0, wo = _heads(params, x, cfg,
                                                       scheme)
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    k_cat = torch.cat([k_nope, k_rope.expand(b, s, k_nope.shape[2],
                                             cfg.qk_rope)], dim=-1)
    out = flash_core(q_cat, k_cat, v, scale=cfg.qk_head ** -0.5, causal=True,
                     kv_chunk=kv_chunk, q_offset=q0)
    return _leave(out, wo, scheme)


def decode_mode(cfg: MLAConfig, cache_c: torch.Tensor) -> str | None:
    """The decode step's mode on the ambient model axis, from the rank's
    latent cache (B, S_loc, kv_loc) as ``launch.specs.cache_structs``
    lays it out: "seq" (S_cache/M positions of the whole latent,
    flash-decode) or "feature" (kv_lora/M columns of every position);
    ``None`` without a model axis."""
    m = model_coord()[1]
    if m == 1:
        return None
    kv = cache_c.shape[-1]
    if kv == cfg.kv_lora:
        return "seq"
    if kv * m == cfg.kv_lora:
        return "feature"
    raise ValueError(f"a latent cache of {kv} columns is no rank's part of "
                     f"kv_lora {cfg.kv_lora} over {m} ranks")


def _head_product(t: torch.Tensor, w: torch.Tensor, shape) -> torch.Tensor:
    """``t`` (B, S, H, E), whole on every rank, times this rank's slice of
    an (E, H, F) leaf (or view) of whole ``shape``, per head: the whole
    (B, S, H, F) on every rank from the rank's heads or F columns
    (gathered) or its E rows (summed); the weight never crosses the
    group (decode)."""
    w = w.to(t.dtype)
    dims = [i for i, (a, b) in enumerate(zip(w.shape, shape)) if a != b]
    if not dims:
        return torch.einsum("bshe,ehf->bshf", t, w)
    k, n = dims[0], w.shape[dims[0]]
    if k == 0:
        return reduce_from_model(torch.einsum(
            "bshe,ehf->bshf", rank_part(t, 3, n), w))
    if k == 1:
        return gather_seq(torch.einsum("bshe,ehf->bshf",
                                       rank_part(t, 2, n), w), 2)
    return gather_seq(torch.einsum("bshe,ehf->bshf", t, w), 3)


def _write_latent(cache, c_new, kr_new, pos, lo):
    """The cache with the token's latent written at global position
    ``pos`` where it falls in the rank's rows ``[lo, lo + S_loc)``, by the
    reference's one-hot blend."""
    idx = torch.arange(cache["c"].shape[1], device=pos.device) + lo
    oh = (idx[None, :] == pos[:, None]).to(cache["c"].dtype)[..., None]
    c = cache["c"] * (1 - oh) + oh * c_new.to(cache["c"].dtype)
    kr = cache["kr"] * (1 - oh) + oh * kr_new.to(cache["kr"].dtype)
    return c, kr


def mla_decode(params, x: torch.Tensor, cache: dict[str, torch.Tensor],
               pos: torch.Tensor, cfg: MLAConfig
               ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Absorbed decode: scores = (q_nope W_uk^T) @ c_cache + q_rope @ k_rope.

    cache: {"c": (B, S, kv_lora), "kr": (B, S, qk_rope)}; x: (B, 1, D);
    pos: (B,). The new latent is written at ``pos`` by the reference's
    one-hot blend; the cache passed in is not modified.

    On a model axis the token's query, latent query and rope key are
    whole on every rank from the stored slices (activations gathered,
    never a weight); the latent cache is the rank's (:func:`decode_mode`:
    "seq" its positions, the softmax merged over the group; "feature" its
    kv_lora and qk_rope columns, the logits' partial sums added before the
    softmax and the latent output's columns gathered after it); the
    output goes through the rank's heads of ``w_uv`` and ``wo``, summed.
    Without a model axis every part is the whole.
    """
    mode = decode_mode(cfg, cache["c"])
    sh = _shapes(cfg)
    cq = matmul_whole(x, params["w_dq"], sh["w_dq"])
    cq = rmsnorm(params["q_norm"], cq, cfg.norm_eps)
    q = _project_gathered(cq, params["w_uq"], sh["w_uq"])
    q_nope, q_rope = q[..., :cfg.qk_nope], q[..., cfg.qk_nope:]
    q_rope = apply_rope(q_rope, pos[:, None], cfg.rope_theta)
    c_new, kr_new = _latent(params, x, cfg, pos[:, None])
    c_new, kr_new = c_new[:, 0:1], kr_new[:, 0]            # (B, 1, ·)
    # absorb W_uk into the query: (B,1,H,nope) x (kv_lora,H,nope)
    q_lat = _head_product(q_nope, params["w_uk"].permute(2, 1, 0),
                          tuple(reversed(sh["w_uk"])))    # (B,1,H,kv_lora)
    s_loc = cache["c"].shape[1]
    lo = model_coord()[0] * s_loc if mode == "seq" else 0
    kl, rl = cache["c"].shape[-1], cache["kr"].shape[-1]
    q_lat, c_new = rank_part(q_lat, 3, kl), rank_part(c_new, 2, kl)
    q_rope, kr_new = rank_part(q_rope, 3, rl), rank_part(kr_new, 2, rl)
    c, kr = _write_latent(cache, c_new, kr_new, pos, lo)
    logits = (torch.einsum("bshe,bte->bhst", q_lat, c.to(x.dtype)) +
              torch.einsum("bshf,btf->bhst", q_rope, kr.to(x.dtype))
              ).float()
    if mode == "feature":
        logits = reduce_from_model(logits)
    logits = logits * cfg.qk_head ** -0.5
    idx = torch.arange(s_loc, device=x.device)[None] + lo
    logits = logits + _bias(idx <= pos[:, None])[:, None, None, :]
    # attend in latent space, then absorb W_uv on the way out
    if mode == "seq":
        probs = merged_softmax(logits, x.dtype)
        out_lat = reduce_from_model(torch.einsum("bhst,bte->bshe", probs,
                                                 c.to(x.dtype)))
    else:
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out_lat = whole_part(torch.einsum("bhst,bte->bshe", probs,
                                          c.to(x.dtype)), 3, cfg.kv_lora)
    w_uv, wo = params["w_uv"], params["wo"]
    if w_uv.shape[1] < cfg.n_heads and wo.shape[0] == w_uv.shape[1]:
        # the rank's heads through its w_uv heads and wo rows, summed
        out = torch.einsum("bshe,ehf->bshf",
                           rank_part(out_lat, 2, w_uv.shape[1]),
                           w_uv.to(x.dtype))
        return _out_proj(out, wo), {"c": c, "kr": kr}
    out = _head_product(out_lat, w_uv, sh["w_uv"])         # (B,1,H,v_head)
    return _out_gathered(out, wo, sh["wo"]), {"c": c, "kr": kr}


def init_mla_cache(batch: int, cfg: MLAConfig, max_seq: int,
                   dtype=torch.bfloat16, device="cpu"
                   ) -> dict[str, torch.Tensor]:
    return {"c": torch.zeros((batch, max_seq, cfg.kv_lora), dtype=dtype,
                             device=device),
            "kr": torch.zeros((batch, max_seq, cfg.qk_rope), dtype=dtype,
                              device=device)}
