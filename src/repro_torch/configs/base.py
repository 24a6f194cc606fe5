"""Architecture configuration schema shared by all 10 assigned archs (the
counterpart of ``repro.configs.base``).

Every config is a frozen (hashable) dataclass. Family-specific sub-configs
(MoE / MLA / SSM / RWKV) plug into the same ``ArchConfig``; ``reduced()``
(``configs.registry``) produces the CPU-smoke-test variant of any
architecture. ``dtype`` is a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.lif import LIFConfig
from repro_torch.models.attention import AttnConfig
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.rwkv import RWKVConfig
from repro_torch.models.ssm import SSMConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | rwkv | hybrid | audio | vlm
    num_layers: int
    d_model: int
    d_ff: int = 0
    vocab_size: int = 32000
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0                   # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int | None = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rwkv: RWKVConfig | None = None
    hybrid_attn_every: int = 0        # zamba2: shared attn block period
    # Spiking-LM: a stateful LIF neuron (E2ATST eq. 11) on every block's
    # FFN/channel/mixer branch, with the sequence axis as the neuron's time
    # axis. The forward runs the sequence-as-time LIF scan; decode carries
    # the per-layer (U, S) membrane state in the serving cache (the KV-cache
    # analogue for neurons) and advances it one SOMA step per token. None =
    # dense (non-spiking) LM, the default.
    lif: LIFConfig | None = None
    encoder_layers: int = 0           # whisper
    encoder_seq: int = 1500
    vlm_stub: bool = False            # pixtral: patch embeddings merged in
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    scan_unroll: bool = False
    flash_train: bool = False      # chunked attention in the training path
    scatter_cache: bool = False    # O(1) scatter KV-cache update vs one-hot
    # KV-cache sharding: "auto" = heads if divisible, else sequence;
    # "trailing" = naive last-dim sharding. Read once sharding is ported.
    cache_shard: str = "auto"
    # long_500k policy: sub-quadratic archs run it; pure full attention skips
    subquadratic: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    @property
    def attn(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads or self.n_heads,
            d_head=self.head_dim, qkv_bias=self.qkv_bias,
            qk_norm=self.qk_norm, sliding_window=self.sliding_window,
            rope_theta=self.rope_theta, norm_eps=self.norm_eps,
            scatter_cache=self.scatter_cache)

    def with_model_shards(self, m: int) -> "ArchConfig":
        """Bind the mesh 'model'-axis size into the MoE physical layout."""
        if self.moe is None:
            return self
        return dataclasses.replace(
            self, moe=dataclasses.replace(self.moe, model_shards=m))

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        n_dec = self.num_layers

        def attn_params():
            h = self.n_heads * self.head_dim
            hk = (self.n_kv_heads or self.n_heads) * self.head_dim
            return d * h + 2 * d * hk + h * d

        if self.family == "rwkv":
            per = 4 * d * d + d * d + d * f + f * d + d * d + 7 * d
            total += n_dec * per
        elif self.family == "hybrid":
            s = self.ssm
            di = s.d_inner
            per = d * (2 * di + 2 * s.d_state + s.n_heads) + di * d \
                + s.d_conv * (di + 2 * s.d_state)
            total += n_dec * per
            total += attn_params() + 3 * d * f          # one shared block
        else:
            per = attn_params() if self.mla is None else (
                d * self.mla.q_lora
                + self.mla.q_lora * self.n_heads * self.mla.qk_head
                + d * (self.mla.kv_lora + self.mla.qk_rope)
                + self.mla.kv_lora * self.n_heads
                * (self.mla.qk_nope + self.mla.v_head)
                + self.n_heads * self.mla.v_head * d)
            if self.moe is not None:
                per += d * self.moe.num_experts
                per += 3 * d * self.moe.d_ff_expert * (
                    self.moe.num_experts + self.moe.n_shared)
            else:
                per += 3 * d * f
            total += n_dec * per
            if self.encoder_layers:
                total += self.encoder_layers * (attn_params() + 2 * d * f) \
                    + n_dec * attn_params()              # cross attention
        return total
