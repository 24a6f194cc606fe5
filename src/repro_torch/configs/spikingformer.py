"""Named Spikingformer presets with execution-policy variants.

The counterpart of ``repro.configs.spikingformer``, with the same four
presets: ``get_spikingformer_config("spikingformer-8-512")`` is the paper
Table III model; ``"spikingformer-smoke"`` is the CPU test size.

Execution variants are spelled ``<name>@<policy>`` with a policy preset name
(``eager``/``cuda``/``cuda-full``, e.g. ``spikingformer-8-512@cuda-full``)
or requested via the ``policy=`` kwarg — the same parameters load under any
policy. When neither is given, the ``REPRO_BACKEND`` environment variable
(which takes the port's policy names here) selects the policy preset.

Every lookup resolves the policy against the preset's shapes once
(:meth:`SpikingFormerConfig.execution_plan`) and logs any packed-kernel
fallback — per-site, at config time, never silently per call.
"""
from __future__ import annotations

import dataclasses
import os

from repro_torch.core.policy import (ExecutionPolicy, default_policy,
                                     log_fallbacks, named_policy)
from repro_torch.core.spikingformer import SpikingFormerConfig

SPIKINGFORMER_PRESETS: dict[str, SpikingFormerConfig] = {
    # Paper Table III: L=8, d=512, h=8, T=4, 224x224, P=14.
    "spikingformer-8-512": SpikingFormerConfig(),
    # ~1M-param synthetic-task size.
    "spikingformer-tiny": SpikingFormerConfig(
        num_layers=2, d_model=96, n_heads=4, d_ff=384, time_steps=4,
        image_size=32, patch_grid=8, num_classes=4),
    # CPU smoke size for parity tests.
    "spikingformer-smoke": SpikingFormerConfig(
        num_layers=2, d_model=64, n_heads=2, d_ff=128, time_steps=2,
        image_size=32, patch_grid=8, num_classes=10),
    # Pre-encoded spike-frame (DVS-style event data) smoke variant: the
    # first tokenizer stage consumes {0,1} frames over 8 input channels
    # (9*8 = 72, a multiple of 8), so under "cuda-full" *every* eq. 4
    # stage — stage 1 included — rides the bit-packed arm.
    "spikingformer-smoke-dvs": SpikingFormerConfig(
        num_layers=2, d_model=64, n_heads=2, d_ff=128, time_steps=2,
        image_size=32, patch_grid=8, num_classes=10, in_channels=8,
        spike_input=True),
}


def list_spikingformer_configs() -> list[str]:
    return sorted(SPIKINGFORMER_PRESETS)


def get_spikingformer_config(name: str, *,
                             policy: ExecutionPolicy | None = None,
                             time_chunk: int | None = None
                             ) -> SpikingFormerConfig:
    """Look up a preset, optionally rebinding the execution policy and the
    temporal tile length.

    Precedence: ``policy=`` kwarg > ``@<policy>`` name suffix >
    ``REPRO_BACKEND`` env var > the preset's own policy (eager).
    """
    if "@" in name:
        name, suffix = name.rsplit("@", 1)
        if policy is None:
            policy = named_policy(suffix)
    cfg = SPIKINGFORMER_PRESETS[name]
    if time_chunk is not None:
        cfg = dataclasses.replace(cfg, time_chunk=time_chunk)
    if policy is not None:
        cfg = cfg.with_policy(policy)
    elif os.environ.get("REPRO_BACKEND"):
        cfg = cfg.with_policy(default_policy())
    # Resolve packing constraints per site once, here — and report them.
    log_fallbacks(cfg.execution_plan())
    return cfg
