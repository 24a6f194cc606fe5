"""RWKV-6 "Finch" (arXiv:2404.05892; the counterpart of
``repro.models.rwkv``): attention-free time mix with a data-dependent
per-channel decay, plus the RWKV channel-mix FFN.

Recurrence per head (dk = dv = head_dim):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          S: (dk, dv)
    o_t = r_t @ (diag(u) k_t^T v_t + S_{t-1})
The forward uses the reference's chunked form (an intra-chunk matrix, the
chunk states, then a loop over chunks), decode the recurrent form. The
chunked WKV is plain tensor code (``torch.einsum`` / ``matmul``), as the
reference computes it outside any Pallas kernel: no kernel of the port
runs here.

As in the reference, the low-rank ddlerp token-shift mixers are collapsed
to per-channel mix weights and the decay LoRA to a direct projection.

On a model axis (the ambient mesh) the heads split over the ranks: the
time mix's projections are column-parallel on the rank's heads,
``ln_x`` normalises over the whole D from statistics summed over the
group, ``w_out`` is row-parallel; the channel mix is Megatron's with a
replicated gate. Decode keeps the state on the rank's slice
(``cache_structs``: dk, else heads) and never gathers it. One code path
serves every mesh: without a model axis each region op is the identity
and each rank's part the whole.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import sum_over_model
from repro_torch.models.common import (MODEL, copy_to_model, full_leaf,
                                       heads_on_axis, init_layernorm,
                                       layernorm, matmul_whole, model_coord,
                                       normal_leaf, ones_leaf, rank_part,
                                       reduce_from_model, whole_part,
                                       zeros_leaf)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    d_model: int
    d_ff: int
    head_dim: int = 64
    chunk: int = 64
    norm_eps: float = 1e-5

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


def init_rwkv_time_mix(generator, cfg: RWKVConfig, dtype=torch.float32,
                       device="cpu"):
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim

    def leaf(shape, spec, **kw):
        return normal_leaf(generator, shape, spec, dtype=dtype, device=device,
                           **kw)
    return {
        # token-shift interpolation weights for r/k/v/w/g
        "mu": ones_leaf((5, d), (None, None), dtype, device),
        "w_r": leaf((d, d), (None, MODEL)),
        "w_k": leaf((d, d), (None, MODEL)),
        "w_v": leaf((d, d), (None, MODEL)),
        "w_g": leaf((d, d), (None, MODEL)),
        # data-dependent decay projection (w_t = exp(-exp(decay)))
        "w_decay": leaf((d, d), (None, MODEL), scale=0.01),
        # bias -5 => initial decay exp(-exp(-5)) ~ 0.993 (slow forgetting)
        "decay_bias": full_leaf((d,), -5.0, (None,), torch.float32, device),
        "u_bonus": zeros_leaf((h, hd), (MODEL, None), torch.float32, device),
        "w_out": leaf((d, d), (MODEL, None)),
        "ln_x": init_layernorm(d, dtype, device),
    }


def _token_shift(x: torch.Tensor,
                 x_prev: torch.Tensor | None = None) -> torch.Tensor:
    """Shift the sequence right by one; ``x_prev`` supplies the carry in
    decode (zeros otherwise)."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, :1])
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def _rkvwg(params, x, shifted, cfg: RWKVConfig):
    """r, k, v, the log decay and g of the rank's heads' columns (all of
    them without a model axis): the token-shift mixes are made from the
    replicated x (``mu`` outside the region) and enter it, and so does
    ``decay_bias``, cut to the rank's columns."""
    mu = params["mu"].to(x.dtype)
    mix = [copy_to_model(x * mu[i] + shifted * (1 - mu[i]))
           for i in range(5)]
    r = torch.matmul(mix[0], params["w_r"].to(x.dtype))
    k = torch.matmul(mix[1], params["w_k"].to(x.dtype))
    v = torch.matmul(mix[2], params["w_v"].to(x.dtype))
    n = r.shape[-1]
    bias = copy_to_model(params["decay_bias"]).narrow(
        0, model_coord()[0] * n, n)
    lw = -torch.exp(torch.matmul(mix[3], params["w_decay"].to(x.dtype))
                    .float() + bias)                       # log w_t <= 0
    g = F.silu(torch.matmul(mix[4], params["w_g"].to(x.dtype)))
    return r, k, v, lw, g


def _wkv(r, k, v, lw, u, h: int, cfg: RWKVConfig) -> torch.Tensor:
    """The chunked WKV of ``h`` heads: r, k, v (B, S, h*hd), lw the log
    decay (B, S, h*hd), u (h, hd) -> (B, S, h*hd) fp32."""
    b, s, _ = r.shape
    hd = cfg.head_dim
    ck = cfg.chunk if s % cfg.chunk == 0 else s
    nc = s // ck
    rc, kc, vc = (a.reshape(b, nc, ck, h, hd).float() for a in (r, k, v))
    lc = lw.reshape(b, nc, ck, h, hd)                      # per-channel decay

    cum = torch.cumsum(lc, dim=2)                          # inclusive
    total = cum[:, :, -1]                                  # (B,nc,H,hd)
    excl = cum - lc                                        # exclusive

    # intra-chunk: o_t = sum_{i<t} (r_t*exp(excl_t)) . (k_i*exp(-cum_i)) v_i
    #              + (r_t*u) . k_t v_t
    r_dec = rc * torch.exp(excl)
    k_dec = kc * torch.exp(-cum)
    scores = torch.einsum("bnchd,bnihd->bnhci", r_dec, k_dec)
    mask = torch.ones((ck, ck), dtype=torch.bool, device=r.device).tril(-1)
    scores = torch.where(mask, scores, 0.0)                # strictly lower
    y_intra = torch.einsum("bnhci,bnihd->bnchd", scores, vc)
    bonus = (rc * u * kc).sum(-1)                          # (B,nc,ck,H)
    y_intra = y_intra + bonus[..., None] * vc

    # chunk state: S_next = diag(exp(total)) S + sum_i (k_i exp(total-cum_i))^T v_i
    k_tail = kc * torch.exp(total[:, :, None] - cum)
    s_chunk = torch.einsum("bnihd,bnihe->bnhde", k_tail, vc)
    s_prev = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    s_prevs = []
    for n in range(nc):
        s_prevs.append(s_prev)
        s_prev = s_prev * torch.exp(total[:, n])[..., None] + s_chunk[:, n]
    s_prevs = torch.stack(s_prevs, dim=1)                  # (B,nc,H,hd,hd)

    y_inter = torch.einsum("bnchd,bnhde->bnche", r_dec, s_prevs)
    return (y_intra + y_inter).reshape(b, s, h * hd)


def _ln_x(params, y: torch.Tensor, cfg: RWKVConfig) -> torch.Tensor:
    """``ln_x``, the LayerNorm over the whole D, on the rank's columns
    ``y`` (B, S, D/M): the mean and the variance from the group's sums of
    the rows' sums and squared deviations (``sum_over_model``: each
    rank's columns reach every rank's statistics), the scale and bias the
    rank's columns of the replicated leaves, which enter the region."""
    d, n = cfg.d_model, y.shape[-1]
    yf = y.float()
    mu = sum_over_model(yf.sum(-1, keepdim=True)) / d
    var = sum_over_model((yf - mu).square().sum(-1, keepdim=True)) / d
    out = (yf - mu) * torch.rsqrt(var + cfg.norm_eps)
    scale, bias = (copy_to_model(params["ln_x"][k]).narrow(
        0, model_coord()[0] * n, n) for k in ("scale", "bias"))
    return (out * scale.float() + bias.float()).to(y.dtype)


def rwkv_time_mix(params, x: torch.Tensor, cfg: RWKVConfig) -> torch.Tensor:
    """Chunked WKV. x: (B, S, D) -> (B, S, D). A sequence that is not a
    multiple of ``cfg.chunk`` is one chunk, as in the reference.

    On a model axis r, k, v, g and the decay are the rank's heads'
    columns (:func:`_rkvwg`), the WKV runs on its heads, ``ln_x``
    normalises over the whole D from the group's statistics, and
    ``w_out``'s rows' partial products are summed. Without a model axis
    every region op is the identity and the rank's heads are all of
    them."""
    hl = heads_on_axis(cfg.n_heads, "RWKV")
    r, k, v, lw, g = _rkvwg(params, x, _token_shift(x), cfg)
    y = _wkv(r, k, v, lw, params["u_bonus"], hl, cfg).to(x.dtype)
    y = _ln_x(params, y, cfg) * g
    return reduce_from_model(torch.matmul(y, params["w_out"].to(x.dtype)))


def gather_carry(x_prev: torch.Tensor, d: int) -> torch.Tensor:
    """A decode carry (B, 1, D) whole: gathered over the model axis where
    the cache holds the rank's D/M columns (``cache_structs``), the
    token's activations (no gradient)."""
    return whole_part(x_prev, 2, d)


def keep_carry(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The new carry as the cache holds it: the rank's columns of the
    whole (B, 1, D) ``x`` where ``like`` holds the rank's."""
    return rank_part(x, 2, like.shape[-1])


def rwkv_time_mix_decode(params, x: torch.Tensor, state: dict,
                         cfg: RWKVConfig):
    """One step. state: {"s": (B,H,hd,hd) fp32, "x_prev": (B,1,D)}.

    On a model axis each is the rank's part as ``cache_structs`` lays it
    out. The token's r, k, v, g and decay are projected with the rank's
    stored columns and gathered whole (activations, never a weight);
    ``x_prev`` is gathered to shift the token and the rank's columns of
    the new one kept. The state ``s`` stays the rank's, never gathered:
    on heads (each head's output gathered) or, where the axis divides dk,
    on dk (the output's partial sums over dk added, the bonus term
    ``(r u k) v`` from the rank's heads of ``u_bonus``, gathered);
    ``cache_structs``' third choice, dv, needs heads the axis does not
    divide, which :func:`~repro_torch.models.common.heads_on_axis`
    refuses. The output leaves through the rank's rows of ``w_out``,
    summed. Without a model axis every part is the whole."""
    b, _, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    hl = heads_on_axis(h, "RWKV")
    shifted = gather_carry(state["x_prev"], d)
    mu = params["mu"].to(x.dtype)
    mix = [x * mu[i] + shifted * (1 - mu[i]) for i in range(5)]
    r, k, v = (matmul_whole(mix[i], params[w], (d, d))
               for i, w in enumerate(("w_r", "w_k", "w_v")))
    dl = params["w_decay"].shape[1]
    lw = -torch.exp(torch.matmul(mix[3], params["w_decay"].to(x.dtype))
                    .float() + rank_part(params["decay_bias"], 0, dl))
    lw = whole_part(lw, 2, d)
    g = F.silu(matmul_whole(mix[4], params["w_g"], (d, d)))
    rh, kh, vh = (a.reshape(b, h, hd).float() for a in (r, k, v))
    w = torch.exp(lw.reshape(b, h, hd))                    # (B,H,hd) in (0,1)
    u = params["u_bonus"]                                  # (H/M, hd)
    s = state["s"]
    if s.shape[2] < hd:                                    # dk
        n = s.shape[2]
        bonus = whole_part((rank_part(rh, 1, hl) * u * rank_part(kh, 1, hl))
                           .sum(-1), 1, h)                 # (B, H)
        rl, kl, wl = (rank_part(a, 2, n) for a in (rh, kh, w))
        y = reduce_from_model(torch.matmul(rl[..., None, :], s)[..., 0, :]) \
            + bonus[..., None] * vh
        s_new = s * wl[..., None] + kl[..., :, None] * vh[..., None, :]
    else:                                                  # the rank's heads
        rl, kl, vl, wl = (rank_part(a, 1, hl) for a in (rh, kh, vh, w))
        kv = kl[..., :, None] * vl[..., None, :]           # (B,H/M,hd,hd)
        y = whole_part(torch.matmul(rl[..., None, :], s + u[None, ..., None]
                                    * kv)[..., 0, :], 1, h)
        s_new = s * wl[..., None] + kv
    y = y.reshape(b, 1, d).to(x.dtype)
    y = layernorm(params["ln_x"], y, cfg.norm_eps) * g
    out = matmul_whole(y, params["w_out"], (d, d))
    return out, {"s": s_new, "x_prev": keep_carry(x, state["x_prev"])}


def init_rwkv_state(batch: int, cfg: RWKVConfig, dtype=torch.float32,
                    device="cpu"):
    return {"s": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                             dtype=torch.float32, device=device),
            "x_prev": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                                  device=device)}


# ---------------------------------------------------------------------------
# Channel mix (RWKV FFN)
# ---------------------------------------------------------------------------

def init_rwkv_channel_mix(generator, cfg: RWKVConfig, dtype=torch.float32,
                          device="cpu"):
    d, f = cfg.d_model, cfg.d_ff

    def leaf(shape, spec, **kw):
        return normal_leaf(generator, shape, spec, dtype=dtype, device=device,
                           **kw)
    return {
        "mu": ones_leaf((2, d), (None, None), dtype, device),
        "w_k": leaf((d, f), (None, MODEL)),
        "w_v": leaf((f, d), (MODEL, None), scale=f ** -0.5),
        "w_r": leaf((d, d), (None, None)),
    }


def rwkv_channel_mix(params, x: torch.Tensor, cfg: RWKVConfig,
                     x_prev: torch.Tensor | None = None) -> torch.Tensor:
    """The channel mix; ``x_prev`` the decode carry, whole. On a model
    axis ``w_k`` is column-parallel (``xk`` enters the region) and
    ``w_v`` row-parallel, summed; the gate ``sigmoid(xr @ w_r)`` is
    replicated work with the replicated ``w_r``, its gradient whole on
    every rank and not summed."""
    shifted = _token_shift(x, x_prev)
    mu = params["mu"].to(x.dtype)
    xk = x * mu[0] + shifted * (1 - mu[0])
    xr = x * mu[1] + shifted * (1 - mu[1])
    k = torch.square(F.relu(torch.matmul(copy_to_model(xk),
                                         params["w_k"].to(x.dtype))))
    kv = reduce_from_model(torch.matmul(k, params["w_v"].to(x.dtype)))
    r = torch.sigmoid(torch.matmul(xr, params["w_r"].to(x.dtype)))
    return r * kv
