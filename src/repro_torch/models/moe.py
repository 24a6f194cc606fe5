"""Mixture-of-experts layers (the counterpart of ``repro.models.moe``).

Physical expert layout ``(M, E_loc, D, F_loc)``, ``w_down`` ``(M, E_loc,
F_loc, D)``, with M the mesh "model" axis size, as in the reference: E >= M
gives ``E/M`` whole experts per shard, E < M gives ``tp = M/E`` F-slices of
one expert per shard. Routing is capacity-bounded with static shapes and
dispatched by scatter into per-expert buffers (no (T, E, C) one-hot
tensors); shared experts (DeepSeek) run densely beside the routed ones.

On a model axis of M ranks (the ambient mesh; ``model_shards`` must be
M, as ``ArchConfig.with_model_shards`` binds it) :func:`moe_apply` is the
reference's ``shard_map`` body: where M divides the sequence the rank
routes its S/M rows (``split_seq``), sends each kept (token, choice) to
the rank holding its expert (or to all ``tp`` ranks holding its F-slices)
by one all-to-all (:class:`~repro_torch.launch.mesh.AllToAll`), computes
its experts on what it receives, sends the results back by the same
all-to-all, combines, and gathers the rows (``gather_seq``); else
(decode) every rank routes every token, computes only its own experts'
and the sum over the group is the combine. Capacity is per rank, from its
own token count, as in the reference. The expert products are
``torch.bmm``, as the reference's einsums run outside any Pallas kernel.

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

from repro_torch.launch.mesh import all_to_all_model, gather_seq, split_seq
from repro_torch.models.common import (MODEL, copy_to_model, model_coord,
                                       normal_leaf, reduce_from_model)


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


def relayout(w: torch.Tensor, new_m: int, num_experts: int,
             f_dim: int = -1) -> torch.Tensor:
    """An expert leaf ``(..., M, E_loc, ., .)`` (any leading dims: the LM
    stacks its layers) relaid from its M model shards to ``new_m``, on its
    device: the logical (E, D, F) experts laid out again, F on ``f_dim``
    (-1 for ``w_gate`` / ``w_up``, -2 for ``w_down``). A view where the
    experts divide over both sizes. With F last it is the reference's
    ``reshape_moe_layout``; for ``w_down`` it follows F, where that
    function (ROADMAP C5) joins the slices along D."""
    if f_dim == -2:
        return relayout(w.transpose(-1, -2), new_m, num_experts
                        ).transpose(-1, -2)
    *lead, m, el, d, fl = w.shape
    e = num_experts
    if e >= m:
        logical = w.reshape(*lead, m * el, d, fl)
    else:
        logical = w.reshape(*lead, e, m // e, d, fl).movedim(-3, -2) \
            .reshape(*lead, e, d, (m // e) * fl)
    f = logical.shape[-1]
    if e >= new_m:
        return logical.reshape(*lead, new_m, e // new_m, d, f)
    tp = new_m // e
    return logical.reshape(*lead, e, d, tp, f // tp).movedim(-2, -3) \
        .reshape(*lead, new_m, 1, d, f // tp)


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


def _local_moe(x_loc, router_w, w_gate, w_up, w_down, cfg: MoEConfig,
               a2a=None):
    """The reference's per-shard MoE body. x_loc: (B_l, S_l, D); weights:
    local slices (1, E_loc, D, F_loc). ``a2a``: the exchange of the
    (M, E_loc * cap, D) send buffer over the model group (``None``, no
    mesh: the send buffer is the receive buffer). Returns (y (B_l, S_l,
    D), aux)."""
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
    recv = send[:-1].reshape(m, el * cap, d)
    if a2a is not None:
        recv = a2a(recv)
    xe = recv.reshape(m, el, cap, d).transpose(0, 1).reshape(el, m * cap, d)

    ye = _experts(xe, w_gate[0], w_up[0], w_down[0])

    back = ye.reshape(el, m, cap, d).transpose(0, 1).reshape(m, el * cap, d)
    if a2a is not None:
        back = a2a(back.contiguous())
    ret = torch.cat([back.reshape(m * el * cap, d),
                     torch.zeros((1, d), dtype=back.dtype, device=dev)],
                    dim=0)

    y_tok = torch.zeros((n, d), dtype=x_loc.dtype, device=dev)
    weight = (gates.reshape(-1) * keep.to(x_loc.dtype))[:, None]
    for j in range(tp):
        # for tp > 1 the partial down-projections of the F-slices sum here,
        # the tensor-parallel all-reduce of the expert MLP
        y_tok = _combine(y_tok, ret[slot[:, j]] * weight, k)
    return y_tok.reshape(bl, sl, d), aux


def _local_moe_replicated(x_loc, router_w, w_gate, w_up, w_down,
                          cfg: MoEConfig, my: int = 0):
    """The reference's decode-time body on shard ``my``: every local
    token is routed, only the tokens bound for this shard's experts (its
    F-slice's, E < M) are scattered and computed; the caller sums the
    result over the model group (the combine, and the F-slices'
    partial sums)."""
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
    """x: (B, S, D), replicated over a model axis -> (y, aux load-balance
    loss). Without a model axis the reference's mesh-less path. On one of
    M ranks (``cfg.model_shards`` must be M) the expert-parallel body of
    the module docstring: the sequence split where M divides S (training
    and prefill), the replicated routing otherwise (decode). The router
    is replicated and each rank routes a part of the tokens, so its
    gradient is summed (``copy_to_model``); the aux loss is the mean of
    the ranks' (the reference's ``pmean``), its gradient shared out."""
    r, m = model_coord()
    if cfg.model_shards != m:
        raise ValueError(
            f"MoEConfig.model_shards={cfg.model_shards} on a model axis of "
            f"{m}: bind it with ArchConfig.with_model_shards({m})")
    w = (params["w_gate"], params["w_up"], params["w_down"])
    if m == 1:
        y, aux = _local_moe(x, params["router"], *w, cfg)
    else:
        router = copy_to_model(params["router"])
        if x.shape[1] % m == 0 and x.shape[1] >= m:
            y, aux = _local_moe(split_seq(x, 1), router, *w, cfg,
                                a2a=all_to_all_model)
            y = gather_seq(y, 1)
        else:
            y, aux = _local_moe_replicated(copy_to_model(x), router, *w,
                                           cfg, my=r)
            y = reduce_from_model(y)
        aux = reduce_from_model(aux / m)
    if cfg.n_shared:
        from repro_torch.models.mlp import swiglu
        y = y + swiglu(params["shared"], copy_to_model(x))
    return y, aux
