"""Mixture-of-experts configuration (the counterpart of
``repro.models.moe``'s ``MoEConfig``).

Only the frozen config is ported, so that the registry holds every
architecture; the MoE layers are still to port (ROADMAP A9) and
``models.lm`` raises ``NotImplementedError`` for a config that needs them.
"""
from __future__ import annotations

import dataclasses

import torch


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
