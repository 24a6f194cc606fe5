"""Mixture-of-experts layers (the counterpart of ``repro.models.moe``).

Physical expert layout ``(M, E_loc, D, F_loc)``, ``w_down`` ``(M, E_loc,
F_loc, D)``, with M the mesh "model" axis size, as in the reference: E >= M
gives ``E/M`` whole experts per shard, E < M gives ``tp = M/E`` F-slices of
one expert per shard. Routing is capacity-bounded with static shapes and
dispatched by scatter into per-expert buffers (no (T, E, C) one-hot
tensors); shared experts (DeepSeek) run densely beside the routed ones.

Only the reference's ``model_axis=None`` paths exist here, and
:func:`moe_apply` raises for ``model_shards > 1``: the expert all-to-all
over the mesh's "model" axis is ROADMAP A11c-2 (data parallelism, which
replicates the experts, is ported). The expert products are ``torch.bmm``, as the reference's
einsums run outside any Pallas kernel.

Two choices keep the result deterministic on the card, where a scatter-add
is an atomic add and its fp32 sum changes from run to run: the (token,
choice) rows of a token are adjacent (``tok = arange(n).repeat(k)``), so
the combine sums a token's ``k`` contributions in a loop over the choices,
from zero, in the reference's order; and the token copies that the dispatch
scatters are an expanded view (``x_flat[tok]`` as a broadcast), whose
gradient is a sum over the choices instead of an index-add.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.common import MODEL, normal_leaf


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    num_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0              # DeepSeek shared experts (always-on)
    capacity_factor: float = 1.25
    model_shards: int = 1          # mesh "model" axis size M (physical)
    router_dtype: torch.dtype = torch.float32

    @property
    def tp(self) -> int:
        return max(1, self.model_shards // self.num_experts)

    @property
    def e_loc(self) -> int:
        return max(1, self.num_experts // self.model_shards)

    @property
    def f_loc(self) -> int:
        if self.d_ff_expert % self.tp:
            raise ValueError(f"d_ff_expert {self.d_ff_expert} does not split "
                             f"over {self.tp} tensor-parallel shards")
        return self.d_ff_expert // self.tp

    def capacity(self, local_tokens: int) -> int:
        c = int(local_tokens * self.top_k / self.num_experts
                * self.capacity_factor)
        return max(4, -(-c // 4) * 4)


def init_moe(generator, cfg: MoEConfig, dtype=torch.float32, device="cpu"):
    """Experts in the device-local physical layout (M, E_loc, D, F_loc):
    shard m holds expert (m // tp) F-slice (m % tp) [E < M] or experts
    [m*E_loc, (m+1)*E_loc) with full F [E >= M]. The router is fp32."""
    m, el, fl = cfg.model_shards, cfg.e_loc, cfg.f_loc
    d = cfg.d_model
    spec = (MODEL, None, None, None)
    p = {
        "router": normal_leaf(generator, (d, cfg.num_experts), (None, None),
                              scale=0.02, dtype=torch.float32, device=device),
        "w_gate": normal_leaf(generator, (m, el, d, fl), spec,
                              scale=d ** -0.5, dtype=dtype, device=device),
        "w_up": normal_leaf(generator, (m, el, d, fl), spec, scale=d ** -0.5,
                            dtype=dtype, device=device),
        "w_down": normal_leaf(generator, (m, el, fl, d), spec,
                              scale=cfg.d_ff_expert ** -0.5, dtype=dtype,
                              device=device),
    }
    if cfg.n_shared:
        from repro_torch.models.mlp import init_swiglu
        p["shared"] = init_swiglu(generator, d, cfg.d_ff_expert * cfg.n_shared,
                                  dtype, device)
    return p


def _route(router_w: torch.Tensor, x_flat: torch.Tensor, cfg: MoEConfig):
    """(gates (n, k) in x's dtype, experts (n, k), Switch aux loss): fp32
    logits, softmax, the top k in descending order, gates renormalised."""
    logits = x_flat.to(cfg.router_dtype) @ router_w
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux loss
    me = probs.mean(0)
    ce = F.one_hot(experts[:, 0], cfg.num_experts).to(probs.dtype).mean(0)
    aux = cfg.num_experts * (me * ce).sum()
    return gates.to(x_flat.dtype), experts, aux


def _expert_positions(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Slot position of each (token, choice) within its expert's buffer, in
    token order (a stable sort, as ``jnp.argsort``: the capacity drops fall
    on the same tokens as in the reference)."""
    nk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, torch.arange(
        num_experts, dtype=sorted_e.dtype, device=flat_e.device))
    pos_sorted = torch.arange(nk, device=flat_e.device) - start[sorted_e]
    pos = torch.empty(nk, dtype=torch.int32, device=flat_e.device)
    pos[order] = pos_sorted.to(torch.int32)
    return pos


def _experts(xe: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
             wd: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU on its (E_loc, C, D) buffer."""
    h = F.silu(torch.bmm(xe, wg.to(xe.dtype))) * torch.bmm(xe,
                                                           wu.to(xe.dtype))
    return torch.bmm(h, wd.to(xe.dtype))


def _combine(y_tok: torch.Tensor, contrib: torch.Tensor, k: int
             ) -> torch.Tensor:
    """``y_tok.at[tok].add(contrib)`` for ``tok = arange(n).repeat(k)``: a
    token's k rows are adjacent, added one choice at a time in row order."""
    contrib = contrib.reshape(y_tok.shape[0], k, -1)
    for c in range(k):
        y_tok = y_tok + contrib[:, c]
    return y_tok


def _local_moe(x_loc, router_w, w_gate, w_up, w_down, cfg: MoEConfig):
    """The reference's per-shard MoE body with ``model_axis=None`` (no mesh:
    the send buffer is the receive buffer; the all-to-all is ROADMAP A11c-2).
    x_loc: (B_l, S_l, D); weights: local slices (1, E_loc, D, F_loc).
    Returns (y (B_l, S_l, D), aux)."""
    bl, sl, d = x_loc.shape
    n = bl * sl
    xf = x_loc.reshape(n, d)
    gates, experts, aux = _route(router_w, xf, cfg)

    m, el, tp = cfg.model_shards, cfg.e_loc, cfg.tp
    cap = cfg.capacity(n)
    k = cfg.top_k
    dev = x_loc.device
    flat_e = experts.reshape(-1)                                  # (n*k,)
    pos = _expert_positions(flat_e, cfg.num_experts)
    keep = pos < cap

    # destination shard(s) + local expert index; tp copies duplicate the token
    if cfg.num_experts >= m:
        dest = (flat_e // el)[:, None]                            # (n*k, 1)
        e_idx = (flat_e % el)[:, None]
    else:
        dest = flat_e[:, None] * tp + torch.arange(tp, device=dev)[None, :]
        e_idx = torch.zeros_like(dest)
    slot = dest * (el * cap) + e_idx * cap + pos[:, None]         # (n*k, tp)
    slot = torch.where(keep[:, None], slot, m * el * cap)         # drop row

    x_rep = xf[:, None].expand(n, k, d).reshape(n * k, d)         # xf[tok]
    send = torch.zeros((m * el * cap + 1, d), dtype=x_loc.dtype, device=dev)
    for j in range(tp):
        # kept slots are unique; the dropped rows all land on the last row
        send = send.index_put((slot[:, j],), x_rep)
    xe = send[:-1].reshape(m, el, cap, d).transpose(0, 1) \
        .reshape(el, m * cap, d)

    ye = _experts(xe, w_gate[0], w_up[0], w_down[0])

    back = ye.reshape(el, m, cap, d).transpose(0, 1).reshape(m * el * cap, d)
    ret = torch.cat([back, torch.zeros((1, d), dtype=back.dtype,
                                       device=dev)], dim=0)

    y_tok = torch.zeros((n, d), dtype=x_loc.dtype, device=dev)
    weight = (gates.reshape(-1) * keep.to(x_loc.dtype))[:, None]
    for j in range(tp):
        # for tp > 1 the partial down-projections of the F-slices sum here,
        # the tensor-parallel all-reduce of the expert MLP
        y_tok = _combine(y_tok, ret[slot[:, j]] * weight, k)
    return y_tok.reshape(bl, sl, d), aux


def _local_moe_replicated(x_loc, router_w, w_gate, w_up, w_down,
                          cfg: MoEConfig):
    """The reference's decode-time body with ``model_axis=None`` (this
    shard is shard 0): every local token is routed, only the tokens bound
    for this shard's experts are scattered and computed; with a mesh the
    combine is a sum over the model axis. Only a mesh dispatches to it
    (ROADMAP A11c-2)."""
    bl, sl, d = x_loc.shape
    n = bl * sl
    xf = x_loc.reshape(n, d)
    gates, experts, aux = _route(router_w, xf, cfg)

    m, el, tp = cfg.model_shards, cfg.e_loc, cfg.tp
    cap = cfg.capacity(n)
    k = cfg.top_k
    dev = x_loc.device
    flat_e = experts.reshape(-1)
    pos = _expert_positions(flat_e, cfg.num_experts)
    keep = pos < cap
    my = 0
    if cfg.num_experts >= m:
        mine = (flat_e // el) == my
        e_idx = flat_e % el
    else:
        mine = (flat_e * tp <= my) & (my < flat_e * tp + tp)
        e_idx = torch.zeros_like(flat_e)
    slot = torch.where(mine & keep, e_idx * cap + pos, el * cap)

    x_rep = xf[:, None].expand(n, k, d).reshape(n * k, d)
    send = torch.zeros((el * cap + 1, d), dtype=x_loc.dtype,
                       device=dev).index_put((slot,), x_rep)
    xe = send[:-1].reshape(el, cap, d)
    ye = _experts(xe, w_gate[0], w_up[0], w_down[0])
    ret = torch.cat([ye.reshape(el * cap, d),
                     torch.zeros((1, d), dtype=ye.dtype, device=dev)], dim=0)
    weight = (gates.reshape(-1) * (mine & keep).to(x_loc.dtype))[:, None]
    y_tok = _combine(torch.zeros((n, d), dtype=x_loc.dtype, device=dev),
                     ret[slot] * weight, k)
    return y_tok.reshape(bl, sl, d), aux


def moe_apply(params, x: torch.Tensor, cfg: MoEConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux load-balance loss). One device: the
    reference's path without a mesh, which needs ``model_shards == 1``."""
    if cfg.model_shards != 1:
        raise NotImplementedError(
            f"MoEConfig.model_shards={cfg.model_shards}: expert parallelism "
            f"over a mesh 'model' axis is not ported yet (ROADMAP A11c-2); the "
            f"port runs model_shards=1")
    y, aux = _local_moe(x, params["router"], params["w_gate"],
                        params["w_up"], params["w_down"], cfg)
    if cfg.n_shared:
        from repro_torch.models.mlp import swiglu
        y = y + swiglu(params["shared"], x)
    return y, aux
