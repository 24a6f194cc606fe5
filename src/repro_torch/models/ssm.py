"""Mamba2 (SSD) mixer for the Zamba2 hybrid architecture
(arXiv:2411.15242; the counterpart of ``repro.models.ssm``).

State-space dynamics per head (scalar decay a_t = exp(-dt_t * A_h)):
    h_t = a_t * h_{t-1} + dt_t * x_t B_t^T        h: (d_head, d_state)
    y_t = h_t C_t + D_h * x_t
computed with the reference's chunked SSD: an intra-chunk quadratic term
plus inter-chunk state passing, and a single-step recurrent path for
decode. The chunked SSD is plain tensor code (``torch.einsum``), as the
reference computes it outside any Pallas kernel: no kernel of the port
runs here.

The reference's three-operand einsums are contracted in two steps, so that
no (B, nc, t, i, H, hd) intermediate exists: first the (B, nc, t, i, H)
decay-weighted scores, then over i. The masked ``exp`` is the reference's:
``exp(cum_t - cum_i)`` is taken on the whole (t, i) square and the upper
triangle zeroed after it, so a long chunk with fast decay overflows there
and its gradient is not finite (ROADMAP Queue C, C6).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.common import (MODEL, normal_leaf, ones_leaf,
                                       zeros_leaf)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def init_ssm(generator, cfg: SSMConfig, dtype=torch.float32, device="cpu"):
    d, di, h, ds = cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.d_state

    def leaf(shape, spec, **kw):
        return normal_leaf(generator, shape, spec, dtype=dtype, device=device,
                           **kw)
    # in_proj packs [z (di), x (di), B (ds), C (ds), dt (h)]
    return {
        "w_in": leaf((d, 2 * di + 2 * ds + h), (None, MODEL)),
        "conv_w": leaf((cfg.d_conv, di + 2 * ds), (None, MODEL),
                       scale=cfg.d_conv ** -0.5),
        "conv_b": zeros_leaf((di + 2 * ds,), (MODEL,), dtype, device),
        "a_log": zeros_leaf((h,), (MODEL,), torch.float32, device),
        "dt_bias": zeros_leaf((h,), (MODEL,), torch.float32, device),
        "d_skip": ones_leaf((h,), (MODEL,), torch.float32, device),
        "w_out": leaf((di, d), (MODEL, None), scale=di ** -0.5),
    }


def _split_proj(params, x, cfg: SSMConfig):
    """(z (.., di), xbc (.., di + 2 ds), dt (.., h))."""
    di, ds = cfg.d_inner, cfg.d_state
    zxbcdt = torch.matmul(x, params["w_in"].to(x.dtype))
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * ds],
            zxbcdt[..., 2 * di + 2 * ds:])


def _causal_conv(params, xbc, cfg: SSMConfig):
    """Depthwise causal conv over the sequence, kernel d_conv."""
    w = params["conv_w"].to(xbc.dtype)                     # (K, C)
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, cfg.d_conv - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i] for i in range(cfg.d_conv))
    return F.silu(out + params["conv_b"].to(xbc.dtype))


def _decay_log(params, dt):
    """(dt after softplus, log decay dt * A <= 0), both fp32."""
    dt = F.softplus(dt.float() + params["dt_bias"])
    return dt, dt * -torch.exp(params["a_log"])


def ssm_mixer(params, x: torch.Tensor, cfg: SSMConfig) -> torch.Tensor:
    """Training / prefill path (chunked SSD). x: (B, S, D). A sequence that
    is not a multiple of ``cfg.chunk`` is one chunk, as in the
    reference."""
    b, s, _ = x.shape
    di, ds, h, hd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    z, xbc, dt = _split_proj(params, x, cfg)
    xbc = _causal_conv(params, xbc, cfg)
    xin, bmat, cmat = xbc[..., :di], xbc[..., di:di + ds], xbc[..., di + ds:]
    dt, la = _decay_log(params, dt)                        # (B, S, H)

    xh = xin.reshape(b, s, h, hd).float() * dt[..., None]  # dt folded into x
    ck = cfg.chunk if s % cfg.chunk == 0 else s
    nc = s // ck
    xc = xh.reshape(b, nc, ck, h, hd)
    bc = bmat.float().reshape(b, nc, ck, ds)               # shared by heads
    cc = cmat.float().reshape(b, nc, ck, ds)
    cum = torch.cumsum(la.reshape(b, nc, ck, h), dim=2)    # within-chunk
    total = cum[:, :, -1, :]                               # (B, nc, H)

    # intra-chunk: y_t = sum_{i<=t} exp(cum_t - cum_i) (C_t.B_i) x_i
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,t,i,H)
    mask = torch.ones((ck, ck), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(mask[:, :, None], torch.exp(li), 0.0)
    scores = torch.einsum("bnts,bnis->bnti", cc, bc)       # (B,nc,t,i)
    y_intra = torch.einsum("bntih,bnihd->bnthd", scores[..., None] * decay,
                           xc)

    # chunk states: S_n = sum_i exp(total - cum_i) B_i^T x_i  (H, ds, hd)
    dec_i = torch.exp(total[:, :, None, :] - cum)          # (B,nc,ck,H)
    s_chunk = torch.einsum("bnis,bnihd->bnhsd", bc, dec_i[..., None] * xc)

    # inter-chunk state passing over nc
    h_prev = torch.zeros((b, h, ds, hd), dtype=torch.float32, device=x.device)
    h_prevs = []
    for n in range(nc):
        h_prevs.append(h_prev)
        h_prev = h_prev * torch.exp(total[:, n])[:, :, None, None] \
            + s_chunk[:, n]
    h_prevs = torch.stack(h_prevs, dim=1)                  # (B,nc,H,ds,hd)

    # inter-chunk contribution: y_t += exp(cum_t) C_t . h_prev
    y_inter = torch.einsum("bnts,bnhsd->bnthd", cc, h_prevs) \
        * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(b, s, h, hd)
    y = y + params["d_skip"][:, None] * xin.reshape(b, s, h, hd).float()
    y = y.reshape(b, s, di).to(x.dtype) * F.silu(z)
    return torch.matmul(y, params["w_out"].to(x.dtype))


def ssm_decode(params, x: torch.Tensor, state: dict[str, torch.Tensor],
               cfg: SSMConfig) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Single-token recurrent step. x: (B, 1, D);
    state: {"h": (B, H, ds, hd), "conv": (B, d_conv-1, di+2*ds)}."""
    b = x.shape[0]
    di, ds, h, hd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    z, xbc, dt = _split_proj(params, x, cfg)
    window = torch.cat([state["conv"], xbc], dim=1)        # (B, K, C)
    conv_out = (window * params["conv_w"].to(x.dtype)).sum(1) \
        + params["conv_b"].to(x.dtype)
    xbc1 = F.silu(conv_out)                                # (B, C)
    xin, bm, cm = xbc1[:, :di], xbc1[:, di:di + ds], xbc1[:, di + ds:]

    dt, la = _decay_log(params, dt[:, 0])                  # (B, H)
    xs = xin.reshape(b, h, hd).float()
    h_new = state["h"] * torch.exp(la)[:, :, None, None] \
        + bm.float()[:, None, :, None] * (xs * dt[..., None])[:, :, None, :]
    y = torch.matmul(cm.float()[:, None, None, :], h_new)[:, :, 0]  # (B,H,hd)
    y = y + params["d_skip"][:, None] * xs
    y = y.reshape(b, 1, di).to(x.dtype) * F.silu(z)
    out = torch.matmul(y, params["w_out"].to(x.dtype))
    return out, {"h": h_new, "conv": window[:, 1:]}


def init_ssm_state(batch: int, cfg: SSMConfig, dtype=torch.float32,
                   device="cpu"):
    return {"h": torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.head_dim),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.d_conv - 1,
                                 cfg.d_inner + 2 * cfg.d_state), dtype=dtype,
                                device=device)}
