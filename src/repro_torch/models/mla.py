"""Multi-head latent attention configuration (the counterpart of
``repro.models.mla``'s ``MLAConfig``). Only the config is ported; the MLA
layers are still to port (ROADMAP A9)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6

    @property
    def qk_head(self) -> int:
        return self.qk_nope + self.qk_rope
