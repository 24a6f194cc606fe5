"""Attention layers (the counterpart of ``repro.models.attention``): GQA with
RoPE / QKV bias / qk-norm / sliding window, a chunked (flash-style,
online-softmax) path for long prefill, and the single-token decode path
against a dense or ring-buffer KV cache.

The products are ``torch.matmul``/``einsum``, as the reference leaves its
einsums to XLA outside any Pallas kernel. The reference's sharding
constraints are identities here: each rank holds its rows whole, and on a
model axis of M (the ambient mesh) the "heads" scheme of the reference's
``_attn_scheme``: the rank's h/M query heads, the key/value heads they
read (its own hk/M where M divides hk, else the one or few its query heads
share, cut from ``wk``/``wv`` gathered over the group where the plan
stores them on another dim), ``wo`` row-parallel and summed over the
group. The caller enters the region (``copy_to_model`` on ``x``). The
"seq" and head_dim schemes raise (ROADMAP A11c-2).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch.mesh import gather_model
from repro_torch.models.common import (MODEL, apply_rope, copy_to_model,
                                       init_rmsnorm, model_coord, normal_leaf,
                                       reduce_from_model, refuse_model_axis,
                                       rmsnorm, zeros_leaf)

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int | None = None
    rope_theta: float = 1_000_000.0
    use_rope: bool = True
    causal: bool = True
    norm_eps: float = 1e-6
    # one-hot multiply rewrites the whole cache per step (O(S) traffic);
    # scatter writes only the touched row (O(1)).
    scatter_cache: bool = False


def init_attention(generator, cfg: AttnConfig, dtype=torch.float32,
                   device="cpu"):
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": normal_leaf(generator, (d, h, dh), (None, MODEL, None),
                          dtype=dtype, device=device),
        "wk": normal_leaf(generator, (d, hk, dh), (None, MODEL, None),
                          dtype=dtype, device=device),
        "wv": normal_leaf(generator, (d, hk, dh), (None, MODEL, None),
                          dtype=dtype, device=device),
        "wo": normal_leaf(generator, (h, dh, d), (MODEL, None, None),
                          scale=(h * dh) ** -0.5, dtype=dtype, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros_leaf((h, dh), (MODEL, None), dtype, device)
        p["bk"] = zeros_leaf((hk, dh), (MODEL, None), dtype, device)
        p["bv"] = zeros_leaf((hk, dh), (MODEL, None), dtype, device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(dh, dtype, device)
        p["k_norm"] = init_rmsnorm(dh, dtype, device)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) x (D, H, dh) -> (B, S, H, dh), one matmul."""
    d, h, dh = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, h * dh)).reshape(
        *x.shape[:-1], h, dh)


def _heads(cfg: AttnConfig, seq: int, decode: bool = False):
    """This rank's heads under the "heads" scheme on the ambient model
    axis: ``(first q head, q heads, first kv head, kv heads)``, ``None``
    without a model axis. Another scheme raises (A11c-2): training takes
    "heads" where M divides the query heads, decode where it divides the
    kv heads (the cache's layout), as the reference chooses."""
    r, m = model_coord()
    if m == 1:
        return None
    if decode and cfg.n_kv_heads % m:
        refuse_model_axis(
            f"decode attention with {cfg.n_kv_heads} kv heads (the "
            f"'{'seq' if seq % m == 0 else 'head_dim'}' scheme)")
    if cfg.n_heads % m:
        refuse_model_axis(
            f"attention with {cfg.n_heads} heads (the "
            f"'{'seq' if seq % m == 0 else 'none'}' scheme)")
    hl = cfg.n_heads // m
    n_rep = cfg.n_heads // cfg.n_kv_heads
    kv_lo = r * hl // n_rep
    return r * hl, hl, kv_lo, (r * hl + hl - 1) // n_rep + 1 - kv_lo


def _kv_part(leaf: torch.Tensor, whole, dim: int, lo: int, n: int
             ) -> torch.Tensor:
    """Kv heads ``[lo, lo + n)`` (along ``dim``) of a key/value leaf of
    shape ``whole``: the rank's own slice where the plan stores exactly
    those, else cut from the leaf gathered over the model group."""
    want = list(whole)
    want[dim] = n
    if list(leaf.shape) == want:
        return leaf
    return gather_model(leaf, whole).narrow(dim, lo, n)


def _project_qkv(params, x: torch.Tensor, cfg: AttnConfig,
                 positions: torch.Tensor, heads=None):
    """x: (B, S, D) -> q (B,S,H,dh), k/v (B,S,HK,dh), RoPE'd + normed; with
    ``heads`` (:func:`_heads`) the rank's query heads and the kv heads
    they read."""
    wk, wv = params["wk"], params["wv"]
    bk, bv = params.get("bk"), params.get("bv")
    if heads is not None:
        _, _, kv_lo, nkv = heads
        d, hk, dh = cfg.d_model, cfg.n_kv_heads, cfg.d_head
        wk, wv = (_kv_part(w, (d, hk, dh), 1, kv_lo, nkv) for w in (wk, wv))
        if cfg.qkv_bias:
            bk, bv = (_kv_part(b, (hk, dh), 0, kv_lo, nkv) for b in (bk, bv))
    q = _project(x, params["wq"])
    k = _project(x, wk)
    v = _project(x, wv)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + bk.to(x.dtype)
        v = v + bv.to(x.dtype)
    if cfg.qk_norm:
        qn, kn = params["q_norm"], params["k_norm"]
        if heads is not None:
            # replicated leaves inside the region: each rank's gradient
            # covers its heads only, so it is summed over the group
            qn, kn = ({"scale": copy_to_model(p["scale"])} for p in (qn, kn))
        q = rmsnorm(qn, q, cfg.norm_eps)
        k = rmsnorm(kn, k, cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(k: torch.Tensor, cfg: AttnConfig, heads) -> torch.Tensor:
    """The kv heads repeated to the query heads that read them: all of
    them (``_repeat_kv``), or the rank's (``heads``)."""
    n_rep = cfg.n_heads // cfg.n_kv_heads
    if heads is None:
        return _repeat_kv(k, n_rep)
    q_lo, hl, kv_lo, _ = heads
    idx = torch.arange(q_lo, q_lo + hl, device=k.device) // n_rep - kv_lo
    return k.index_select(2, idx)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, hk, dh = k.shape
    return k[:, :, :, None, :].expand(b, s, hk, n_rep, dh).reshape(
        b, s, hk * n_rep, dh)


def _mask_bias(sq: int, sk: int, cfg: AttnConfig, device,
               q_offset: int = 0) -> torch.Tensor:
    """(sq, sk) additive mask: causal + optional sliding window."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if cfg.causal:
        ok &= ki <= qi
    if cfg.sliding_window is not None:
        ok &= ki > qi - cfg.sliding_window
    return _bias(ok)


def _bias(ok: torch.Tensor) -> torch.Tensor:
    """0 where ``ok``, NEG_INF elsewhere, fp32."""
    return torch.where(ok, 0.0, NEG_INF).float()


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, dh) x (H, dh, D) -> (B, S, D), one matmul; on a model axis
    the rank's heads' partial sum, added over the group."""
    h, dh, d = wo.shape
    return reduce_from_model(torch.matmul(
        out.reshape(*out.shape[:-2], h * dh),
        wo.to(out.dtype).reshape(h * dh, d)))


def attention(params, x: torch.Tensor, cfg: AttnConfig,
              positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full (training / short-prefill) attention. x: (B, S, D)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    heads = _heads(cfg, s)
    q, k, v = _project_qkv(params, x, cfg, positions, heads)
    k, v = _expand_kv(k, cfg, heads), _expand_kv(v, cfg, heads)
    scale = cfg.d_head ** -0.5
    logits = torch.einsum("bshe,bthe->bhst", q, k).float() * scale
    logits = logits + _mask_bias(s, s, cfg, x.device)[None, None]
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhst,bthe->bshe", probs, v)
    return _out_proj(out, params["wo"])


def flash_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               scale: float, causal: bool = True,
               sliding_window: int | None = None,
               kv_chunk: int = 1024) -> torch.Tensor:
    """Chunked online-softmax attention core: q/k (B,S,H,dk), v (B,S,H,dv)
    -> (B,S,H,dv). Never materializes the (S,S) score matrix; walks KV in
    ``kv_chunk`` blocks carrying running (max, sum, acc) statistics, with
    the reference's chunking (``max(1, S // kv_chunk)`` equal chunks)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    n_chunks = max(1, s // kv_chunk)
    ck = s // n_chunks
    qi = torch.arange(s, device=q.device)
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, dv), dtype=torch.float32, device=q.device)
    for j in range(n_chunks):
        kj = k[:, j * ck:(j + 1) * ck]
        vj = v[:, j * ck:(j + 1) * ck]
        kpos = j * ck + torch.arange(ck, device=q.device)
        logit = torch.einsum("bshe,bthe->bhst", q, kj).float() * scale
        ok = torch.ones((s, ck), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kpos[None, :] <= qi[:, None]
        if sliding_window is not None:
            ok &= kpos[None, :] > qi[:, None] - sliding_window
        logit = logit + _bias(ok)[None, None]
        m_new = torch.maximum(m, logit.amax(-1))
        p = torch.exp(logit - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhst,bthe->bhse", p,
                                                   vj.float())
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out.transpose(1, 2)                           # (B, S, H, dv)


def flash_attention(params, x: torch.Tensor, cfg: AttnConfig,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """Long-prefill GQA attention built on :func:`flash_core`."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    heads = _heads(cfg, s)
    q, k, v = _project_qkv(params, x, cfg, positions, heads)
    k, v = _expand_kv(k, cfg, heads), _expand_kv(v, cfg, heads)
    out = flash_core(q, k, v, scale=cfg.d_head ** -0.5, causal=cfg.causal,
                     sliding_window=cfg.sliding_window, kv_chunk=kv_chunk)
    return _out_proj(out, params["wo"])


# ---------------------------------------------------------------------------
# Decode with KV cache
# ---------------------------------------------------------------------------

def attention_decode(params, x: torch.Tensor, cache: dict[str, torch.Tensor],
                     pos: torch.Tensor, cfg: AttnConfig
                     ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One-token decode. x: (B, 1, D); cache: {"k","v"} (B, S_cache, HK, dh);
    pos: (B,) current position (number of tokens already in cache).

    Sliding-window caches are ring buffers of size ``cfg.sliding_window``;
    dense caches are written at ``pos`` directly. The cache passed in is
    not modified: the updated one is returned. On a model axis the cache
    holds the rank's hk/M kv heads.
    """
    b = x.shape[0]
    s_cache = cache["k"].shape[1]
    heads = _heads(cfg, s_cache, decode=True)
    q, k, v = _project_qkv(params, x, cfg, pos[:, None], heads)

    slot = pos % s_cache if cfg.sliding_window is not None else pos
    if cfg.scatter_cache:
        bi = torch.arange(b, device=x.device)
        new_k, new_v = cache["k"].clone(), cache["v"].clone()
        new_k[bi, slot] = k[:, 0].to(new_k.dtype)
        new_v[bi, slot] = v[:, 0].to(new_v.dtype)
    else:
        idx = torch.arange(s_cache, device=x.device)
        onehot = (idx[None, :] == slot[:, None]).to(k.dtype)    # (B, S)
        oh = onehot[..., None, None]
        new_k = cache["k"] * (1 - oh) + oh * k.to(cache["k"].dtype)
        new_v = cache["v"] * (1 - oh) + oh * v.to(cache["v"].dtype)

    kk = _expand_kv(new_k.to(x.dtype), cfg, heads)
    vv = _expand_kv(new_v.to(x.dtype), cfg, heads)
    scale = cfg.d_head ** -0.5
    logits = torch.einsum("bshe,bthe->bhst", q, kk).float() * scale
    idx = torch.arange(s_cache, device=x.device)[None]         # (1, S)
    valid = idx <= slot[:, None] if cfg.sliding_window is None else \
        (idx <= slot[:, None]) | (pos[:, None] >= s_cache)
    logits = logits + _bias(valid)[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhst,bthe->bshe", probs, vv)
    return _out_proj(out, params["wo"]), {"k": new_k, "v": new_v}


def init_kv_cache(batch: int, cfg: AttnConfig, max_seq: int,
                  dtype=torch.bfloat16, device="cpu") -> dict[str, torch.Tensor]:
    size = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    shape = (batch, size, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
