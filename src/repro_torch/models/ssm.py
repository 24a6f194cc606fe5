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

On a model axis (the ambient mesh) the heads split over the ranks
(:func:`ssm_mixer`); decode keeps the state ``h`` and the conv state on
the rank's slices ``cache_structs`` gives them and never gathers either
(:func:`ssm_decode`). One code path serves every mesh: without a model
axis each region op is the identity and each rank's part the whole.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import gather_model
from repro_torch.models.common import (MODEL, copy_to_model, heads_on_axis,
                                       matmul_whole, model_coord,
                                       normal_leaf, ones_leaf, rank_part,
                                       reduce_from_model, whole_part,
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


def _split_proj(params, x, cfg: SSMConfig, heads: int | None = None):
    """(z (.., n), xbc (.., n + 2 ds), dt (.., heads)) from ``w_in``
    holding the columns of ``heads`` heads (all by default; n = heads *
    head_dim) with B and C whole."""
    n = (cfg.n_heads if heads is None else heads) * cfg.head_dim
    ds = cfg.d_state
    zxbcdt = torch.matmul(x, params["w_in"].to(x.dtype))
    return (zxbcdt[..., :n], zxbcdt[..., n:2 * n + 2 * ds],
            zxbcdt[..., 2 * n + 2 * ds:])


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


def _ssd(xin, dt, la, bmat, cmat, d_skip, h: int, cfg: SSMConfig
         ) -> torch.Tensor:
    """The chunked SSD of ``h`` heads: xin (B, S, h*hd), dt and la (B, S,
    h), B and C (B, S, ds), d_skip (h,) -> y (B, S, h, hd) fp32, the skip
    term added."""
    b, s, _ = xin.shape
    ds, hd = cfg.d_state, cfg.head_dim
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
    mask = torch.ones((ck, ck), dtype=torch.bool, device=xin.device).tril()
    decay = torch.where(mask[:, :, None], torch.exp(li), 0.0)
    scores = torch.einsum("bnts,bnis->bnti", cc, bc)       # (B,nc,t,i)
    y_intra = torch.einsum("bntih,bnihd->bnthd", scores[..., None] * decay,
                           xc)

    # chunk states: S_n = sum_i exp(total - cum_i) B_i^T x_i  (H, ds, hd)
    dec_i = torch.exp(total[:, :, None, :] - cum)          # (B,nc,ck,H)
    s_chunk = torch.einsum("bnis,bnihd->bnhsd", bc, dec_i[..., None] * xc)

    # inter-chunk state passing over nc
    h_prev = torch.zeros((b, h, ds, hd), dtype=torch.float32,
                         device=xin.device)
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
    return y + d_skip[:, None] * xin.reshape(b, s, h, hd).float()


def ssm_mixer(params, x: torch.Tensor, cfg: SSMConfig) -> torch.Tensor:
    """Training / prefill path (chunked SSD). x: (B, S, D). A sequence that
    is not a multiple of ``cfg.chunk`` is one chunk, as in the reference.

    On a model axis the rank computes its heads. The plan cuts ``w_in``
    (d, 2 di + 2 ds + H) and the conv's C = di + 2 ds channels into equal
    column blocks that do not line up with the heads, so ``w_in``,
    ``conv_w`` and ``conv_b`` are gathered whole (their gradients
    reduce-scattered) and the rank's z, x and dt columns are cut from
    them, with B and C whole (shared by every head, their gradient partial
    on each rank, as x's, which enters the region). ``a_log``,
    ``dt_bias`` and ``d_skip`` are the rank's heads; the SSD runs on them
    and ``w_out``'s rows' products are summed. Without a model axis every
    region op is the identity and the columns are all of them."""
    b, s, _ = x.shape
    d, di, ds, h, hd = (cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads,
                        cfg.head_dim)
    hl = heads_on_axis(h, "Mamba2")
    n, c = hl * hd, di + 2 * ds
    x = copy_to_model(x)
    w_in = gather_model(params["w_in"], (d, 2 * di + 2 * ds + h))
    conv = {"conv_w": gather_model(params["conv_w"], (cfg.d_conv, c)),
            "conv_b": gather_model(params["conv_b"], (c,))}
    if hl < h:              # the rank's z, x and dt columns, B and C whole
        r = model_coord()[0]
        z_cols = torch.arange(r * n, r * n + n, device=x.device)
        bc_cols = torch.arange(2 * di, 2 * di + 2 * ds, device=x.device)
        w_in = w_in.index_select(1, torch.cat([
            z_cols, di + z_cols, bc_cols, torch.arange(
                2 * di + 2 * ds + r * hl, 2 * di + 2 * ds + r * hl + hl,
                device=x.device)]))
        conv_cols = torch.cat([z_cols, bc_cols - di])
        conv = {k: v.index_select(v.ndim - 1, conv_cols)
                for k, v in conv.items()}
    z, xbc, dt = _split_proj({"w_in": w_in}, x, cfg, hl)
    xbc = _causal_conv(conv, xbc, cfg)
    xin, bmat, cmat = xbc[..., :n], xbc[..., n:n + ds], xbc[..., n + ds:]
    dt, la = _decay_log(params, dt)                        # (B, S, H/M)
    y = _ssd(xin, dt, la, bmat, cmat, params["d_skip"], hl, cfg)
    y = y.reshape(b, s, n).to(x.dtype) * F.silu(z)
    return reduce_from_model(torch.matmul(y, params["w_out"].to(x.dtype)))


def ssm_decode(params, x: torch.Tensor, state: dict[str, torch.Tensor],
               cfg: SSMConfig) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Single-token recurrent step. x: (B, 1, D);
    state: {"h": (B, H, ds, hd), "conv": (B, d_conv-1, di+2*ds)}.

    On a model axis each is the rank's part as ``cache_structs`` lays it
    out. The token's projection is made with the rank's stored ``w_in``
    columns and gathered whole; the depthwise conv runs on the rank's
    stored channels (those of its conv state and of ``conv_w`` /
    ``conv_b``) and its outputs are gathered; dt, the decay and the skip
    term come from the rank's heads of ``dt_bias`` / ``a_log`` /
    ``d_skip``. The state ``h`` stays the rank's and is never gathered:
    on heads, hd (its x columns of every head, the output's columns
    gathered) or ds (its columns of B and C; ``y = C h`` summed over the
    group). The output leaves through the rank's rows of ``w_out``,
    summed. Without a model axis every part is the whole."""
    b = x.shape[0]
    d, di, ds, h, hd = (cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads,
                        cfg.head_dim)
    hl = heads_on_axis(h, "Mamba2")
    c = di + 2 * ds
    proj = matmul_whole(x[:, 0], params["w_in"], (d, 2 * di + 2 * ds + h))
    z, xbc, dt = proj[:, :di], proj[:, di:di + c], proj[:, di + c:]
    conv, cw, cb = state["conv"], params["conv_w"], params["conv_b"]
    cl = min(conv.shape[-1], cw.shape[-1])     # the channels computed here
    window = torch.cat([conv, rank_part(xbc, 1, conv.shape[-1])[:, None]],
                       dim=1)                      # the state's channels
    xbc1 = F.silu((rank_part(window, 2, cl) * rank_part(cw, 1, cl).to(
        x.dtype)).sum(1) + rank_part(cb, 0, cl).to(x.dtype))
    xbc1 = whole_part(xbc1, 1, c)                          # (B, C)
    xin, bm, cm = xbc1[:, :di], xbc1[:, di:di + ds], xbc1[:, di + ds:]
    dt, la = _decay_log(params, rank_part(dt, 1, hl))      # (B, H/M)
    xs = xin.reshape(b, h, hd).float()
    skip = whole_part(params["d_skip"][:, None] * rank_part(xs, 1, hl), 1, h)
    hs = state["h"]                             # (B, H', ds', hd') the rank's
    if hs.shape[1] == h:
        dt, la = whole_part(dt, 1, h), whole_part(la, 1, h)
    xl = rank_part(rank_part(xs, 1, hs.shape[1]), 2, hs.shape[3])
    bl, cl_ = (rank_part(t, 1, hs.shape[2]) for t in (bm, cm))
    h_new = hs * torch.exp(la)[:, :, None, None] + \
        bl.float()[:, None, :, None] * (xl * dt[..., None])[:, :, None, :]
    y = torch.matmul(cl_.float()[:, None, None, :], h_new)[:, :, 0]
    if hs.shape[2] < ds:                        # partial sums over ds
        y = reduce_from_model(y)
    y = whole_part(whole_part(y, 1, h), 2, hd) + skip      # (B, H, hd)
    y = y.reshape(b, 1, di).to(x.dtype) * F.silu(z[:, None])
    out = matmul_whole(y, params["w_out"], (di, d))
    return out, {"h": h_new, "conv": window[:, 1:]}


def init_ssm_state(batch: int, cfg: SSMConfig, dtype=torch.float32,
                   device="cpu"):
    return {"h": torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.head_dim),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.d_conv - 1,
                                 cfg.d_inner + 2 * cfg.d_state), dtype=dtype,
                                device=device)}
