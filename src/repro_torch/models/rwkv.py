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
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.common import (MODEL, full_leaf, init_layernorm,
                                       layernorm, normal_leaf, ones_leaf,
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
    mu = params["mu"].to(x.dtype)
    mix = [x * mu[i] + shifted * (1 - mu[i]) for i in range(5)]
    r = torch.matmul(mix[0], params["w_r"].to(x.dtype))
    k = torch.matmul(mix[1], params["w_k"].to(x.dtype))
    v = torch.matmul(mix[2], params["w_v"].to(x.dtype))
    lw = -torch.exp(torch.matmul(mix[3], params["w_decay"].to(x.dtype))
                    .float() + params["decay_bias"])          # log w_t <= 0
    g = F.silu(torch.matmul(mix[4], params["w_g"].to(x.dtype)))
    return r, k, v, lw, g


def rwkv_time_mix(params, x: torch.Tensor, cfg: RWKVConfig) -> torch.Tensor:
    """Chunked WKV. x: (B, S, D) -> (B, S, D). A sequence that is not a
    multiple of ``cfg.chunk`` is one chunk, as in the reference."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    r, k, v, lw, g = _rkvwg(params, x, _token_shift(x), cfg)
    u = params["u_bonus"]                                  # (H, hd)

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
    mask = torch.ones((ck, ck), dtype=torch.bool, device=x.device).tril(-1)
    scores = torch.where(mask, scores, 0.0)                # strictly lower
    y_intra = torch.einsum("bnhci,bnihd->bnchd", scores, vc)
    bonus = (rc * u * kc).sum(-1)                          # (B,nc,ck,H)
    y_intra = y_intra + bonus[..., None] * vc

    # chunk state: S_next = diag(exp(total)) S + sum_i (k_i exp(total-cum_i))^T v_i
    k_tail = kc * torch.exp(total[:, :, None] - cum)
    s_chunk = torch.einsum("bnihd,bnihe->bnhde", k_tail, vc)
    s_prev = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    s_prevs = []
    for n in range(nc):
        s_prevs.append(s_prev)
        s_prev = s_prev * torch.exp(total[:, n])[..., None] + s_chunk[:, n]
    s_prevs = torch.stack(s_prevs, dim=1)                  # (B,nc,H,hd,hd)

    y_inter = torch.einsum("bnchd,bnhde->bnche", r_dec, s_prevs)
    y = (y_intra + y_inter).reshape(b, s, d).to(x.dtype)
    y = layernorm(params["ln_x"], y, cfg.norm_eps) * g
    return torch.matmul(y, params["w_out"].to(x.dtype))


def rwkv_time_mix_decode(params, x: torch.Tensor, state: dict,
                         cfg: RWKVConfig):
    """One step. state: {"s": (B,H,hd,hd) fp32, "x_prev": (B,1,D)}."""
    b, _, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    r, k, v, lw, g = _rkvwg(params, x, _token_shift(x, state["x_prev"]), cfg)
    rh, kh, vh = (a.reshape(b, h, hd).float() for a in (r, k, v))
    w = torch.exp(lw.reshape(b, h, hd))                    # (B,H,hd) in (0,1)
    u = params["u_bonus"]
    kv = kh[..., :, None] * vh[..., None, :]               # (B,H,hd,hd)
    y = torch.matmul(rh[..., None, :],
                     state["s"] + u[None, ..., None] * kv)[..., 0, :]
    s_new = state["s"] * w[..., None] + kv
    y = y.reshape(b, 1, d).to(x.dtype)
    y = layernorm(params["ln_x"], y, cfg.norm_eps) * g
    out = torch.matmul(y, params["w_out"].to(x.dtype))
    return out, {"s": s_new, "x_prev": x}


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
    shifted = _token_shift(x, x_prev)
    mu = params["mu"].to(x.dtype)
    xk = x * mu[0] + shifted * (1 - mu[0])
    xr = x * mu[1] + shifted * (1 - mu[1])
    k = torch.square(F.relu(torch.matmul(xk, params["w_k"].to(x.dtype))))
    kv = torch.matmul(k, params["w_v"].to(x.dtype))
    r = torch.sigmoid(torch.matmul(xr, params["w_r"].to(x.dtype)))
    return r * kv
