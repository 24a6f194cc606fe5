"""RWKV-6 configuration (the counterpart of ``repro.models.rwkv``'s
``RWKVConfig``). Only the config is ported; the time- and channel-mix
layers are still to port (ROADMAP A9)."""
from __future__ import annotations

import dataclasses


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
