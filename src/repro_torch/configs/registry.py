"""The 10 assigned architectures as configs (the counterpart of
``repro.configs.registry``, entry for entry).

Sources are noted inline. ``reduced(cfg)`` shrinks any config to a
CPU-smoke size that preserves the family structure (hybrid grouping, MoE
top-k, GQA ratios).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.rwkv import RWKVConfig
from repro_torch.models.ssm import SSMConfig

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    return _REGISTRY[name]


def list_configs() -> list[str]:
    return sorted(_REGISTRY)


# --- [ssm] RWKV-6 Finch 7B: 32L d4096 d_ff 14336 vocab 65536 [arXiv:2404.05892]
register(ArchConfig(
    name="rwkv6-7b", family="rwkv", num_layers=32, d_model=4096,
    d_ff=14336, vocab_size=65536,
    rwkv=RWKVConfig(d_model=4096, d_ff=14336, head_dim=64),
    subquadratic=True))

# --- [dense] Qwen1.5-4B: 40L d2560 20H kv20, QKV bias [hf:Qwen/Qwen1.5]
register(ArchConfig(
    name="qwen1.5-4b", family="dense", num_layers=40, d_model=2560,
    n_heads=20, n_kv_heads=20, d_ff=6912, vocab_size=151936,
    qkv_bias=True, rope_theta=1e6))

# --- [dense] DeepSeek-7B: 30L d4096 32H kv32, llama arch [arXiv:2401.02954]
register(ArchConfig(
    name="deepseek-7b", family="dense", num_layers=30, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=11008, vocab_size=102400,
    rope_theta=1e4))

# --- [dense] Qwen3-0.6B: 28L d1024 16H kv8, qk_norm, head_dim 128 [hf:Qwen3]
register(ArchConfig(
    name="qwen3-0.6b", family="dense", num_layers=28, d_model=1024,
    n_heads=16, n_kv_heads=8, d_head=128, d_ff=3072, vocab_size=151936,
    qk_norm=True, rope_theta=1e6))

# --- [dense] Qwen3-14B: 40L d5120 40H kv8, qk_norm [hf:Qwen3]
register(ArchConfig(
    name="qwen3-14b", family="dense", num_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=8, d_head=128, d_ff=17408, vocab_size=151936,
    qk_norm=True, rope_theta=1e6))

# --- [hybrid] Zamba2-2.7B: 54 Mamba2 layers + shared attn block, ssm_state 64
#     [arXiv:2411.15242]; shared attention applied every 6 mamba blocks.
register(ArchConfig(
    name="zamba2-2.7b", family="hybrid", num_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab_size=32000,
    ssm=SSMConfig(d_model=2560, d_state=64, d_conv=4, expand=2, head_dim=64),
    hybrid_attn_every=6, rope_theta=1e4, subquadratic=True))

# --- [moe] Mixtral-8x7B: 32L d4096 32H kv8, 8 experts top-2, SWA 4096
#     [arXiv:2401.04088]
register(ArchConfig(
    name="mixtral-8x7b", family="moe", num_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=32000,
    sliding_window=4096, rope_theta=1e6,
    moe=MoEConfig(d_model=4096, num_experts=8, top_k=2, d_ff_expert=14336),
    subquadratic=True))  # SWA ring buffer => sub-quadratic long decode

# --- [moe] DeepSeek-V2-236B: 60L d5120 128H, MLA kv_lora 512,
#     2 shared + 160 routed top-6 experts d_ff_expert 1536 [arXiv:2405.04434]
register(ArchConfig(
    name="deepseek-v2-236b", family="moe", num_layers=60, d_model=5120,
    n_heads=128, n_kv_heads=128, d_ff=12288, vocab_size=102400,
    mla=MLAConfig(d_model=5120, n_heads=128, q_lora=1536, kv_lora=512,
                  qk_nope=128, qk_rope=64, v_head=128),
    moe=MoEConfig(d_model=5120, num_experts=160, top_k=6, d_ff_expert=1536,
                  n_shared=2),
    rope_theta=1e4))

# --- [audio] Whisper-large-v3: enc 32L + dec 32L d1280 20H, conv stub
#     [arXiv:2212.04356]
register(ArchConfig(
    name="whisper-large-v3", family="audio", num_layers=32, d_model=1280,
    n_heads=20, n_kv_heads=20, d_ff=5120, vocab_size=51866,
    encoder_layers=32, encoder_seq=1500))

# --- [vlm] Pixtral-12B: 40L d5120 32H kv8 d_ff 14336 vocab 131072,
#     ViT frontend stub [hf:mistralai/Pixtral-12B-2409]
register(ArchConfig(
    name="pixtral-12b", family="vlm", num_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_head=160, d_ff=14336, vocab_size=131072,
    vlm_stub=True, rope_theta=1e9))


ASSIGNED = ["rwkv6-7b", "qwen1.5-4b", "deepseek-7b", "qwen3-0.6b",
            "qwen3-14b", "zamba2-2.7b", "mixtral-8x7b", "deepseek-v2-236b",
            "whisper-large-v3", "pixtral-12b"]

# long_500k runs only for sub-quadratic archs (DESIGN.md §Arch-applicability)
LONG_CONTEXT = [n for n in ASSIGNED if _REGISTRY[n].subquadratic]


def reduced(cfg: ArchConfig) -> ArchConfig:
    """CPU smoke-test variant preserving the family structure."""
    kw: dict = dict(
        num_layers=4 if cfg.family != "hybrid" else 4,
        d_model=64, d_ff=128, vocab_size=512, dtype=torch.float32, remat=False)
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads
                  else 4, d_head=16)
    if cfg.rwkv is not None:
        kw["rwkv"] = RWKVConfig(d_model=64, d_ff=128, head_dim=16, chunk=8)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_model=64, d_state=16, d_conv=4, expand=2,
                              head_dim=16, chunk=8)
        kw["hybrid_attn_every"] = 2
    if cfg.moe is not None:
        # capacity_factor 8 => no token drops at smoke scale, so the
        # train-forward and decode MoE paths agree exactly (parity tests)
        kw["moe"] = MoEConfig(d_model=64, num_experts=cfg.moe.num_experts
                              if cfg.moe.num_experts <= 8 else 8,
                              top_k=2, d_ff_expert=64,
                              n_shared=min(cfg.moe.n_shared, 1),
                              capacity_factor=8.0)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(d_model=64, n_heads=4, q_lora=32, kv_lora=16,
                              qk_nope=16, qk_rope=8, v_head=16)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, encoder_seq=32, num_layers=2)
    return dataclasses.replace(cfg, **kw)
