"""Mamba2 (SSD) configuration (the counterpart of ``repro.models.ssm``'s
``SSMConfig``). Only the config is ported; the mixer is still to port
(ROADMAP A9)."""
from __future__ import annotations

import dataclasses


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
