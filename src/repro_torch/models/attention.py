"""Attention layers (the counterpart of ``repro.models.attention``): GQA with
RoPE / QKV bias / qk-norm / sliding window, a chunked (flash-style,
online-softmax) path for long prefill, and the single-token decode path
against a dense or ring-buffer KV cache.

The products are ``torch.matmul``/``einsum``, as the reference leaves its
einsums to XLA outside any Pallas kernel. The reference's sharding
constraints are identities here: each rank holds its rows whole. On a
model axis of M (the ambient mesh) the layer takes the scheme the
reference's ``_attn_scheme`` chooses by divisibility, and enters its own
region (the caller hands it the replicated input):

* "heads" (M divides the query heads): the rank's h/M query heads, the
  key/value heads they read (its own hk/M where M divides hk, else the
  one or few its query heads share, cut from ``wk``/``wv`` gathered over
  the group where the plan stores them on another dim), ``wo``
  row-parallel and summed over the group;
* "seq" (else, M divides the sequence): q for the rank's S/M rows, k and
  v for all S (as the reference keeps them replicated), the mask offset
  by the rank's first row, ``wo`` whole on the rank's rows, and the rows
  gathered back (``gather_seq``); each rank's weight and input gradients
  are partial and summed over the group;
* "none" (neither): the whole attention on every rank, whose gradients
  are whole on every rank and are not summed.

Decode keys its mode off the cache, as the reference does: heads where M
divides the kv heads; else flash-decode over a cache holding the rank's
S_cache/M positions ("seq": the row maximum, the exponent sum and P.V
merged over the group); else head_dim (the cache holds dh/M columns of
every head, the logits' partial sums added before the softmax).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch.mesh import all_reduce_max, gather_model, gather_seq
from repro_torch.models.common import (MODEL, apply_rope, copy_to_model,
                                       init_rmsnorm, model_coord, normal_leaf,
                                       reduce_from_model, rmsnorm, zeros_leaf)

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


def attn_scheme(cfg: AttnConfig, seq: int) -> str | None:
    """The training (and prefill) scheme on the ambient model axis, the
    reference's ``_attn_scheme``: "heads" where M divides the query heads,
    else "seq" where it divides the sequence, else "none"; ``None``
    without a model axis."""
    m = model_coord()[1]
    if m == 1:
        return None
    if cfg.n_heads % m == 0:
        return "heads"
    return "seq" if seq % m == 0 else "none"


def _heads(cfg: AttnConfig):
    """This rank's heads under the "heads" scheme: ``(first q head, q
    heads, first kv head, kv heads)``."""
    r, m = model_coord()
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


def _whole_params(params, cfg: AttnConfig, summed: bool):
    """Every leaf whole on this rank, for a scheme that computes with all
    of it: gathered over the model group where the plan stores a slice.
    ``summed``: each rank's gradient is partial (the "seq" scheme's rows),
    so a gathered leaf's is reduce-scattered and a whole one's summed
    (``copy_to_model``); else (replicated work) the rank's part of the
    whole gradient is kept, nothing summed."""
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    shapes = {"wq": (d, h, dh), "wk": (d, hk, dh), "wv": (d, hk, dh),
              "wo": (h, dh, d), "bq": (h, dh), "bk": (hk, dh),
              "bv": (hk, dh)}

    out = {k: whole_leaf(v, shapes[k], summed) for k, v in params.items()
           if k in shapes}
    for k in ("q_norm", "k_norm"):
        if k in params:
            out[k] = {"scale": whole_leaf(params[k]["scale"], (dh,), summed)}
    return out


def whole_leaf(leaf: torch.Tensor, shape, summed: bool) -> torch.Tensor:
    """One leaf whole on this rank (:func:`_whole_params`' rule):
    ``summed`` a whole leaf enters the region (``copy_to_model``) and a
    stored slice is gathered with its gradient reduce-scattered; else
    (replicated work) a slice is gathered keeping the rank's part of the
    whole gradient, and a whole leaf is itself."""
    if tuple(leaf.shape) == tuple(shape):
        return copy_to_model(leaf) if summed else leaf
    return gather_model(leaf, shape, summed=summed)


def _project_gathered(x: torch.Tensor, w: torch.Tensor, shape
                      ) -> torch.Tensor:
    """(B, S, D) x this rank's slice of a (D, H, dh) leaf of whole
    ``shape`` -> the whole (B, S, H, dh) on every rank, no weight crossing
    the group (decode, whose activations are the small side): the rank's
    heads or dh columns projected and all-gathered, or the partial
    products of its rows of D summed. No gradient is meant to pass."""
    dims = [i for i, (a, b) in enumerate(zip(w.shape, shape)) if a != b]
    if not dims:
        return _project(x, w)
    if dims[0] == 0:
        n = w.shape[0]
        return reduce_from_model(_project(
            x.narrow(-1, model_coord()[0] * n, n), w))
    return gather_seq(_project(x, w), dims[0] + 1)


def _out_gathered(out: torch.Tensor, wo: torch.Tensor, shape
                  ) -> torch.Tensor:
    """The whole (B, S, H, dh) ``out`` through this rank's slice of a
    (H, dh, D) ``wo`` of whole ``shape``: its D columns all-gathered, or
    the partial products of its heads or dh rows summed (decode)."""
    dims = [i for i, (a, b) in enumerate(zip(wo.shape, shape)) if a != b]
    if not dims:
        return _matmul_out(out, wo)
    k = dims[0]
    if k == 2:
        return gather_seq(_matmul_out(out, wo), 2)
    n = wo.shape[k]
    return reduce_from_model(_matmul_out(
        out.narrow(k + 2, model_coord()[0] * n, n), wo))


def _project_qkv(params, x: torch.Tensor, cfg: AttnConfig,
                 positions: torch.Tensor, heads=None, rows=None,
                 gathered: bool = False):
    """x: (B, S, D) -> q (B,S,H,dh), k/v (B,S,HK,dh), RoPE'd + normed; with
    ``heads`` (:func:`_heads`) the rank's query heads and the kv heads
    they read; with ``rows`` (first, count) q for those rows only; with
    ``gathered`` whole from the leaves' stored slices
    (:func:`_project_gathered`)."""
    wk, wv = params["wk"], params["wv"]
    bk, bv = params.get("bk"), params.get("bv")
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if heads is not None:
        _, _, kv_lo, nkv = heads
        wk, wv = (_kv_part(w, (d, hk, dh), 1, kv_lo, nkv) for w in (wk, wv))
        if cfg.qkv_bias:
            bk, bv = (_kv_part(b, (hk, dh), 0, kv_lo, nkv) for b in (bk, bv))
    xq, q_pos = x, positions
    if rows is not None:
        xq, q_pos = x.narrow(1, *rows), positions.narrow(1, *rows)
    if gathered:
        q = _project_gathered(xq, params["wq"], (d, h, dh))
        k = _project_gathered(x, wk, (d, hk, dh))
        v = _project_gathered(x, wv, (d, hk, dh))
        if cfg.qkv_bias:
            params = {**params, "bq": gather_model(params["bq"], (h, dh),
                                                   summed=False)}
            bk, bv = (gather_model(b, (hk, dh), summed=False)
                      for b in (bk, bv))
    else:
        q = _project(xq, params["wq"])
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
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _enter(params, x: torch.Tensor, cfg: AttnConfig, positions, scheme):
    """The scheme's region entry and projections: ``(q, k, v, first q
    row, wo)``, k and v expanded to the query heads q holds."""
    heads, rows, q0 = None, None, 0
    if scheme in ("heads", "seq"):
        x = copy_to_model(x)
    if scheme == "heads":
        heads = _heads(cfg)
    elif scheme is not None:
        params = _whole_params(params, cfg, summed=scheme == "seq")
    if scheme == "seq":
        r, m = model_coord()
        n = x.shape[1] // m
        rows, q0 = (r * n, n), r * n
    q, k, v = _project_qkv(params, x, cfg, positions, heads, rows)
    k, v = _expand_kv(k, cfg, heads), _expand_kv(v, cfg, heads)
    return q, k, v, q0, params["wo"]


def _leave(out: torch.Tensor, wo: torch.Tensor, scheme) -> torch.Tensor:
    """``out`` through ``wo`` and out of the scheme's region: the heads'
    partial sums added over the group ("heads"), the rank's rows gathered
    ("seq"), nothing ("none": every rank holds the whole result)."""
    if scheme == "heads" or scheme is None:
        return _out_proj(out, wo)
    y = _matmul_out(out, wo)
    return gather_seq(y, 1) if scheme == "seq" else y


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


def _matmul_out(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, dh) x (H, dh, D) -> (B, S, D), one matmul."""
    h, dh, d = wo.shape
    return torch.matmul(out.reshape(*out.shape[:-2], h * dh),
                        wo.to(out.dtype).reshape(h * dh, d))


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """:func:`_matmul_out`; on a model axis the rank's heads' partial sum,
    added over the group."""
    return reduce_from_model(_matmul_out(out, wo))


def attention(params, x: torch.Tensor, cfg: AttnConfig,
              positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full (training / short-prefill) attention. x: (B, S, D), replicated
    over a model axis (the layer enters its scheme's region itself)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    scheme = attn_scheme(cfg, s)
    q, k, v, q0, wo = _enter(params, x, cfg, positions, scheme)
    scale = cfg.d_head ** -0.5
    logits = torch.einsum("bshe,bthe->bhst", q, k).float() * scale
    logits = logits + _mask_bias(q.shape[1], s, cfg, x.device,
                                 q0)[None, None]
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhst,bthe->bshe", probs, v)
    return _leave(out, wo, scheme)


def flash_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               scale: float, causal: bool = True,
               sliding_window: int | None = None,
               kv_chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Chunked online-softmax attention core: q (B,Sq,H,dk), k (B,S,H,dk),
    v (B,S,H,dv) -> (B,Sq,H,dv), q's rows at positions ``q_offset`` on
    (Sq = S but under the "seq" scheme). Never materializes the (S,S)
    score matrix; walks KV in ``kv_chunk`` blocks carrying running (max,
    sum, acc) statistics, with the reference's chunking (``max(1, S //
    kv_chunk)`` equal chunks)."""
    b, sq, h, dk = q.shape
    s = k.shape[1]
    dv = v.shape[-1]
    n_chunks = max(1, s // kv_chunk)
    ck = s // n_chunks
    qi = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=q.device)
    for j in range(n_chunks):
        kj = k[:, j * ck:(j + 1) * ck]
        vj = v[:, j * ck:(j + 1) * ck]
        kpos = j * ck + torch.arange(ck, device=q.device)
        logit = torch.einsum("bshe,bthe->bhst", q, kj).float() * scale
        ok = torch.ones((sq, ck), dtype=torch.bool, device=q.device)
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
    return out.transpose(1, 2)                           # (B, Sq, H, dv)


def flash_attention(params, x: torch.Tensor, cfg: AttnConfig,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """Long-prefill GQA attention built on :func:`flash_core`, under the
    scheme :func:`attention` takes."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    scheme = attn_scheme(cfg, s)
    q, k, v, q0, wo = _enter(params, x, cfg, positions, scheme)
    out = flash_core(q, k, v, scale=cfg.d_head ** -0.5, causal=cfg.causal,
                     sliding_window=cfg.sliding_window, kv_chunk=kv_chunk,
                     q_offset=q0)
    return _leave(out, wo, scheme)


# ---------------------------------------------------------------------------
# Decode with KV cache
# ---------------------------------------------------------------------------

def decode_mode(cfg: AttnConfig, cache_k: torch.Tensor) -> str | None:
    """The decode step's mode on the ambient model axis, from the rank's
    cache (B, S_loc, HK, dh_loc) as ``launch.specs.cache_structs`` lays
    it out, the reference's rule: "heads" where M divides the kv heads,
    else "seq" (the cache holds S_cache/M positions of every column), else
    "head_dim" (dh/M columns); ``None`` without a model axis."""
    m = model_coord()[1]
    if m == 1:
        return None
    if cfg.n_kv_heads % m == 0:
        return "heads"
    if cache_k.shape[3] == cfg.d_head:
        return "seq"
    if cache_k.shape[3] * m == cfg.d_head:
        return "head_dim"
    raise ValueError(f"a cache of {cache_k.shape[3]} columns a head is no "
                     f"rank's part of d_head {cfg.d_head} over {m} ranks")


def _write_cache(cache, k, v, slot, lo, cfg: AttnConfig):
    """The cache with the new token's k and v written at global position
    ``slot`` (B,), where it falls in the rank's rows ``[lo, lo + S_loc)``
    (a rank whose rows do not hold it writes nothing)."""
    b, s_loc = cache["k"].shape[:2]
    if cfg.scatter_cache:
        bi = torch.arange(b, device=k.device)
        local = slot - lo
        mine = ((local >= 0) & (local < s_loc))[:, None, None]
        local = local.clamp(0, s_loc - 1)
        new_k, new_v = cache["k"].clone(), cache["v"].clone()
        new_k[bi, local] = torch.where(mine, k[:, 0].to(new_k.dtype),
                                       new_k[bi, local])
        new_v[bi, local] = torch.where(mine, v[:, 0].to(new_v.dtype),
                                       new_v[bi, local])
        return new_k, new_v
    idx = torch.arange(s_loc, device=k.device) + lo
    onehot = (idx[None, :] == slot[:, None]).to(k.dtype)        # (B, S)
    oh = onehot[..., None, None]
    new_k = cache["k"] * (1 - oh) + oh * k.to(cache["k"].dtype)
    new_v = cache["v"] * (1 - oh) + oh * v.to(cache["v"].dtype)
    return new_k, new_v


def attention_decode(params, x: torch.Tensor, cache: dict[str, torch.Tensor],
                     pos: torch.Tensor, cfg: AttnConfig
                     ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One-token decode. x: (B, 1, D); cache: {"k","v"} (B, S_cache, HK, dh);
    pos: (B,) current position (number of tokens already in cache).

    Sliding-window caches are ring buffers of size ``cfg.sliding_window``;
    dense caches are written at ``pos`` directly. The cache passed in is
    not modified: the updated one is returned. On a model axis the cache
    holds the rank's part (:func:`decode_mode`).
    """
    mode = decode_mode(cfg, cache["k"])
    if mode == "heads":
        x = copy_to_model(x)
    heads = _heads(cfg) if mode == "heads" else None
    # "seq" and head_dim: q, k and v of the one token whole on every rank,
    # from the stored slices (the activations cross the group, never a
    # weight or the cache)
    q, k, v = _project_qkv(params, x, cfg, pos[:, None], heads,
                           gathered=mode in ("seq", "head_dim"))

    r, m = model_coord()
    s_loc = cache["k"].shape[1]
    s_cache = s_loc * m if mode == "seq" else s_loc
    lo = r * s_loc if mode == "seq" else 0
    if mode == "head_dim":
        # RoPE's pairs and the qk-norm span all of d_head: cut after them
        dl = cfg.d_head // m
        q, k, v = (t.narrow(3, r * dl, dl) for t in (q, k, v))
    slot = pos % s_cache if cfg.sliding_window is not None else pos
    new_k, new_v = _write_cache(cache, k, v, slot, lo, cfg)

    kk = _expand_kv(new_k.to(x.dtype), cfg, heads)
    vv = _expand_kv(new_v.to(x.dtype), cfg, heads)
    idx = torch.arange(s_loc, device=x.device)[None] + lo        # (1, S)
    valid = idx <= slot[:, None] if cfg.sliding_window is None else \
        (idx <= slot[:, None]) | (pos[:, None] >= s_cache)
    out = decode_attend(q, kk, vv, mode, cfg,
                        _bias(valid)[:, None, None, :])
    return out_decode(out, params["wo"], mode, cfg), {"k": new_k,
                                                      "v": new_v}


def merged_softmax(logits: torch.Tensor, dtype) -> torch.Tensor:
    """Flash-decode's softmax over every rank's positions: the group's row
    maximum and exponent sum (P.V is then summed over the group)."""
    top = all_reduce_max(logits.amax(-1, keepdim=True))
    p = torch.exp(logits - top)
    return (p / reduce_from_model(p.sum(-1, keepdim=True))).to(dtype)


def decode_attend(q: torch.Tensor, kk: torch.Tensor, vv: torch.Tensor,
                  mode, cfg: AttnConfig, bias=None) -> torch.Tensor:
    """One token's q (B, 1, H, ·) against the rank's keys and values
    (B, S_loc, H, ·) under the decode ``mode`` (:func:`decode_mode`),
    ``bias`` added to the scaled logits: the logits' partial sums added
    over the group (head_dim), the softmax merged over it ("seq"); the
    output (B, 1, H, dh), head_dim's columns gathered whole."""
    logits = torch.einsum("bshe,bthe->bhst", q, kk).float()
    if mode == "head_dim":
        logits = reduce_from_model(logits)
    logits = logits * cfg.d_head ** -0.5
    if bias is not None:
        logits = logits + bias
    if mode == "seq":
        probs = merged_softmax(logits, q.dtype)
        out = reduce_from_model(torch.einsum("bhst,bthe->bshe", probs, vv))
    else:
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bhst,bthe->bshe", probs, vv)
    if mode == "head_dim":
        out = gather_seq(out, 3)            # the heads' dh columns, whole
    return out


def out_decode(out: torch.Tensor, wo: torch.Tensor, mode,
               cfg: AttnConfig) -> torch.Tensor:
    """A decode step's (B, 1, H, dh) through ``wo``: the rank's heads'
    partial sums added ("heads", or no model axis), else the whole
    ``out`` through the stored slice of ``wo`` (:func:`_out_gathered`)."""
    if mode in ("seq", "head_dim"):
        return _out_gathered(out, wo, (cfg.n_heads, cfg.d_head,
                                       cfg.d_model))
    return _out_proj(out, wo)


def init_kv_cache(batch: int, cfg: AttnConfig, max_seq: int,
                  dtype=torch.bfloat16, device="cpu") -> dict[str, torch.Tensor]:
    size = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    shape = (batch, size, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
