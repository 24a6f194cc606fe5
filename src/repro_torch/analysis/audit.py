"""Execution-plan audit helpers (the counterpart of
``repro.analysis.audit``).

Only :func:`fused_site_geometries` is ported: ``repro_torch.tune.workloads``
takes every site's matmul geometry from it. The plan audit, the serving
cache audit and the tuned-table audit come with the rest of the module.
"""
from __future__ import annotations

__all__ = ["fused_site_geometries"]


def fused_site_geometries(cfg, batch: int) -> dict[str, tuple]:
    """``site -> (t, m, c, k)`` matmul geometry for every fused-epilogue
    candidate site of a Spikingformer config, at global batch ``batch``.
    Conv stages use their im2col geometry (rows = batch x out-pixel
    count, contraction = 9 x c_in); the Q/K/V projections share one site
    and one geometry."""
    t, n, d = cfg.time_steps, cfg.num_tokens, cfg.d_model
    geoms: dict[str, tuple] = {}
    h = cfg.image_size
    for i, (c_in, c_out) in enumerate(cfg.tokenizer_stage_channels()):
        h //= 2
        geoms[f"tokenizer.conv.{i}"] = (t, batch * h * h, 9 * c_in, c_out)
    geoms["pssa.qkv"] = (t, batch * n, d, d)
    geoms["pssa.proj"] = (t, batch * n, d, d)
    geoms["smlp.a"] = (t, batch * n, d, cfg.d_ff)
    geoms["smlp.b"] = (t, batch * n, cfg.d_ff, d)
    return geoms
