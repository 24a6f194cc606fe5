"""Shape stand-ins and partition specs for every (architecture x input
shape) cell (the counterpart of ``repro.launch.specs``).

Where the reference traces the initialisers with ``jax.eval_shape``, the
port runs them on ``torch.device("meta")``: tensors with shapes and dtypes
and no storage, so nothing is drawn or allocated. A struct here is such a
meta tensor (``.shape``, ``.dtype``).

``input_specs``, which hands XLA a step to lower for the compile-time
dry run, belongs to ROADMAP A11b.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch.mesh import (P, apply_fsdp, map_specs,
                                     sanitize_specs)
from repro_torch.models.common import split_tree

META = torch.device("meta")


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode", 32768, 128),
    "long_500k": ShapeSpec("decode", 524288, 1),
}


def param_structs(cfg):
    """(params struct tree, spec tree) of an LM or encoder-decoder config,
    from its initialiser on the meta device: zero allocation."""
    if cfg.family == "audio":
        from repro_torch.models.encdec import init_encdec as init
    else:
        from repro_torch.models.lm import init_lm as init
    return split_tree(init(None, cfg, META))


def spikingformer_structs(cfg, mesh, fsdp_min_elems: int = 1 << 20):
    """Spikingformer ``(params, bn-state)`` structs and their specs on
    ``mesh``: the logical specs of ``spikingformer_param_specs`` sanitised
    against the mesh and FSDP'd over "data" (the stacked block leaves keep
    their leading L axis unsharded). The one source of the vision plan:
    ``launch.train.build_spikingformer_state``, the train step and
    ``describe_execution(mesh)`` read it."""
    from repro_torch.core.spikingformer import (init_spikingformer,
                                                spikingformer_param_specs,
                                                spikingformer_scan_dims)
    p_struct, s_struct = init_spikingformer(None, cfg, META)
    p_specs, s_specs = spikingformer_param_specs(cfg)
    p_specs = sanitize_specs(p_specs, p_struct, mesh)
    p_specs = apply_fsdp(p_specs, p_struct, mesh, min_elems=fsdp_min_elems,
                         scan_dims=spikingformer_scan_dims(p_specs))
    s_specs = sanitize_specs(s_specs, s_struct, mesh)
    return (p_struct, s_struct), (p_specs, s_specs)


def lm_specs(cfg, mesh, fsdp_min_elems: int = 1 << 20):
    """(params structs, specs) of an LM or encoder-decoder on ``mesh``:
    sanitised, then FSDP'd over "data" (the training plan)."""
    p_struct, p_specs = param_structs(cfg)
    p_specs = sanitize_specs(p_specs, p_struct, mesh)
    return p_struct, apply_fsdp(p_specs, p_struct, mesh,
                                min_elems=fsdp_min_elems)


def opt_structs(params_struct, params_specs):
    """AdamW state structs and specs: moments like the parameters, the step
    replicated."""
    def like(tree):
        return map_specs(lambda _, s: _struct(s.shape, s.dtype),
                         params_specs, tree)
    state = {"m": like(params_struct), "v": like(params_struct),
             "step": _struct((), torch.int32), "err": None}
    specs = {"m": params_specs, "v": params_specs, "step": P(), "err": None}
    return state, specs


def _batch_structs(cfg, sh: ShapeSpec, batch_axes):
    b, s = sh.batch, sh.seq
    ba = batch_axes or None
    out = {"tokens": _struct((b, s), torch.int32),
           "labels": _struct((b, s), torch.int32)}
    spec = {"tokens": P(ba, None), "labels": P(ba, None)}
    if cfg.family == "audio":
        out["frames"] = _struct((b, cfg.encoder_seq, cfg.d_model),
                                torch.bfloat16)
        spec["frames"] = P(ba, None, None)
    if cfg.vlm_stub:
        out["patch_embeds"] = _struct((b, s, cfg.d_model), torch.bfloat16)
        out["patch_mask"] = _struct((b, s), torch.bool)
        spec["patch_embeds"] = P(ba, None, None)
        spec["patch_mask"] = P(ba, None)
    return out, spec


def cache_structs(cfg, batch: int, max_seq: int, batch_axes):
    """Decode-state structs and specs (mirrors ``models.lm.init_cache``):
    the leading layer axis unsharded, batch over the batch axes where
    batch > 1, and the model axis on heads (dim 3 of a 5-D attention
    cache) where they divide by 16, else the sequence (dim 2); a 4-D cache
    on seq, then features; ``cache_shard="trailing"`` on the last dim that
    divides."""
    ba = batch_axes or None
    bspec = ba if batch > 1 else None
    if cfg.family == "audio":
        from repro_torch.models.attention import init_kv_cache
        from repro_torch.models.encdec import _dec_attn_cfg
        self_c = {k: _struct((cfg.num_layers, *v.shape), torch.bfloat16)
                  for k, v in init_kv_cache(batch, _dec_attn_cfg(cfg),
                                            max_seq, torch.bfloat16,
                                            META).items()}
        hk = cfg.n_kv_heads or cfg.n_heads
        mem = (cfg.num_layers, batch, cfg.encoder_seq, hk, cfg.head_dim)
        struct = {"self": self_c,
                  "cross": {"mk": _struct(mem, torch.bfloat16),
                            "mv": _struct(mem, torch.bfloat16)}}
    else:
        from repro_torch.models.lm import init_cache
        struct = init_cache(cfg, batch, max_seq, torch.bfloat16, META)

    def spec_for(s) -> P:
        dims: list = [None] * s.ndim
        if s.ndim >= 2:
            dims[1] = bspec
        if cfg.cache_shard == "auto" and s.ndim == 5:
            order = (3, 2, 4)       # heads, seq, head_dim
        elif cfg.cache_shard == "auto" and s.ndim == 4:
            order = (2, 3)          # seq, feature (MLA latent / cross-mem)
        else:
            order = tuple(range(s.ndim - 1, 1, -1))
        for i in order:
            if i < s.ndim and s.shape[i] % 16 == 0 and s.shape[i] >= 16:
                dims[i] = "model"
                break
        return P(*dims)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return spec_for(tree)
    return struct, walk(struct)
