"""Shape stand-ins and partition specs for every (architecture x input
shape) cell (the counterpart of ``repro.launch.specs``).

Where the reference traces the initialisers with ``jax.eval_shape``, the
port runs them on ``torch.device("meta")``: tensors with shapes and dtypes
and no storage, so nothing is drawn or allocated. A struct here is such a
meta tensor (``.shape``, ``.dtype``).

``input_specs(cfg, shape_name, mesh)`` returns ``(fn, structs, specs)``
for a cell: the step callable, the meta structs of its inputs (the whole
leaves, as the reference's ``ShapeDtypeStruct``s are) and the matching
partition specs. The dry run (``launch.dryrun``) takes each rank's shard
of the structs under the specs and runs ``fn`` on them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.launch.mesh import (P, Mesh, apply_fsdp, batch_axes,
                                     map_specs, sanitize_specs)
from repro_torch.models.common import cache_model_dim, split_tree

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


def bind_model_axis(cfg, mesh):
    """``cfg`` with ``mesh``'s model-axis size bound into its MoE layout
    (``ArchConfig.with_model_shards``), as the reference's drivers bind
    it; ``cfg`` itself without an MoE (the Spikingformer included)."""
    if getattr(cfg, "moe", None) is None:
        return cfg
    return cfg.with_model_shards(mesh.shape.get("model", 1))


def lm_specs(cfg, mesh, fsdp_min_elems: int = 1 << 20):
    """(params structs, specs) of an LM or encoder-decoder on ``mesh``
    (an MoE's layout bound to its model axis, :func:`bind_model_axis`):
    sanitised, then FSDP'd over "data" (the training plan)."""
    p_struct, p_specs = param_structs(bind_model_axis(cfg, mesh))
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


def cache_structs(cfg, batch: int, max_seq: int, batch_axes,
                  model: int = 16, lif_replicated: bool = False):
    """Decode-state structs and specs (mirrors ``models.lm.init_cache``):
    the leading layer axis unsharded, batch over the batch axes where
    batch > 1, and the model axis on heads (dim 3 of a 5-D attention
    cache) where they divide by ``model`` (the reference's 16), else the
    sequence (dim 2); a 4-D cache on seq, then features;
    ``cache_shard="trailing"`` on the last dim that divides. The decode
    step's "heads" scheme holds the rank's kv heads, the layout this
    gives where ``model`` is the mesh's axis. ``lif_replicated`` keeps
    the spiking LM's LIF state (``"lif"``) whole on every model rank, as
    the decode step reads it (the neuron runs on the whole D after the
    FFN's sum); the reference's layout shards it as any other leaf."""
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

    def spec_for(s, replicated=False) -> P:
        dims: list = [None] * s.ndim
        if s.ndim >= 2:
            dims[1] = bspec
        if replicated:
            return P(*dims)
        i = cache_model_dim(s.shape, model, cfg.cache_shard)
        if i is not None:
            dims[i] = "model"
        return P(*dims)

    def walk(tree, lif=False):
        if isinstance(tree, dict):
            return {k: walk(v, lif or (k == "lif" and lif_replicated))
                    for k, v in tree.items()}
        return spec_for(tree, lif)
    return struct, walk(struct)


def _step_opt_structs(p_struct, p_specs):
    """:func:`opt_structs` as the step takes them: without the ``err``
    residual, which only gradient compression carries (the reference's
    ``None`` leaf, an empty subtree)."""
    o_struct, o_specs = opt_structs(p_struct, p_specs)
    o_struct.pop("err"), o_specs.pop("err")
    return o_struct, o_specs


def _step_mesh(mesh):
    """The mesh a step runs on: ``mesh`` where it is laid over ranks (a
    :class:`Mesh`); None (the mesh-less step) for an :class:`AbstractMesh`,
    which has no ranks to gather over, or for no mesh."""
    return mesh if isinstance(mesh, Mesh) else None


def _vision_input_specs(cfg, sh: ShapeSpec, mesh, ba):
    """(fn, args_structs, args_specs) for a Spikingformer train cell: the
    vision step of ``train.loop.make_train_step`` (functional: it returns
    new trees), ``sh.batch`` NHWC fp32 images and int32 labels."""
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptimizerConfig
    if sh.kind != "train":
        raise ValueError(
            f"vision cells are train-only (shape kind {sh.kind!r})")
    (p_struct, s_struct), (p_specs, s_specs) = spikingformer_structs(cfg,
                                                                     mesh)
    o_struct, o_specs = _step_opt_structs(p_struct, p_specs)
    b = sh.batch
    images = _struct((b, cfg.image_size, cfg.image_size, cfg.in_channels),
                     torch.float32)
    labels = _struct((b,), torch.int32)
    fn = make_train_step(cfg, OptimizerConfig(), mesh=_step_mesh(mesh),
                         donate=True)
    return fn, (p_struct, s_struct, o_struct, images, labels), \
        (p_specs, s_specs, o_specs, P(ba or None, None, None, None),
         P(ba or None))


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def input_specs(cfg, shape_name, mesh, microbatches: int = 1
                ) -> tuple[Callable, tuple, tuple]:
    """Returns ``(fn, args_structs, args_specs)`` for the cell
    ``shape_name`` (a key of :data:`SHAPES`, or a :class:`ShapeSpec`) of
    ``cfg`` on ``mesh``:

    * train: the step of ``train.loop.make_train_step(..., mesh=mesh,
      donate=True)``, the driver's (the LM families write AdamW into the
      leaves they are given; the vision step is functional), on
      ``(params, opt_state, batch)``, or ``(params, bn_state, opt_state,
      images, labels)`` for the Spikingformer;
    * prefill: ``models.lm.lm_prefill`` (the audio family: ``encode``,
      ``decode_train``, ``unembed`` of the last position) on ``(params,
      batch)``;
    * decode: ``lm_decode_step`` or ``encdec_decode_step`` on ``(params,
      cache, tokens, pos)``.

    The weights are FSDP'd over "data" for training, and for serving where
    the bytes of the weights over the model axis pass 8e9, as in the
    reference. A serving cell whose plan shards the weights over "data"
    gathers them over the batch group (``mesh.gather_leaf``, leaf by
    leaf) before the step, so its peak says whether they fit on one card;
    a leaf's "model" slice stays the rank's (the dense family's "heads"
    scheme computes on it). The steps run on ``mesh``, inside it, where it
    is a :class:`Mesh`; an :class:`AbstractMesh` gives the specs and the
    mesh-less step. An MoE's layout is bound to the mesh's model axis
    (:func:`bind_model_axis`). A layout the model axis cannot make raises
    ``ValueError`` (``train.loop.check_model_axis``)."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train.loop import check_model_axis
    sh = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    ba = batch_axes(mesh)
    cfg = bind_model_axis(cfg, mesh)
    check_model_axis(cfg, mesh)
    if getattr(cfg, "family", None) == "vision":
        return _vision_input_specs(cfg, sh, mesh, ba)
    p_struct, p_specs = param_structs(cfg)
    p_specs = sanitize_specs(p_specs, p_struct, mesh)
    # ZeRO-3 over "data": always for training; for serving only where the
    # weights over the model axis would pass 8e9 bytes
    if sh.kind == "train" or \
            _nbytes(p_struct) / mesh.shape.get("model", 1) > 8e9:
        p_specs = apply_fsdp(p_specs, p_struct, mesh)
    run_mesh = _step_mesh(mesh)

    if sh.kind == "train":
        from repro_torch.train.loop import make_train_step
        from repro_torch.train.optimizer import OptimizerConfig
        o_struct, o_specs = _step_opt_structs(p_struct, p_specs)
        b_struct, b_specs = _batch_structs(cfg, sh, ba)
        fn = make_train_step(cfg, OptimizerConfig(), microbatches,
                             mesh=run_mesh, donate=True)
        return fn, (p_struct, o_struct, b_struct), (p_specs, o_specs,
                                                    b_specs)

    def in_mesh(step):
        """``step`` run inside the mesh, whose model axis the model reads."""
        if run_mesh is None:
            return step

        def run(*args):
            with mesh_mod.use_mesh(run_mesh):
                return step(*args)
        return run

    def whole(params):
        """The weights gathered over the batch group (the serving plan's
        gather); tensor-parallel slices stay the rank's."""
        if run_mesh is None:
            return params
        return map_specs(lambda spec, leaf: mesh_mod.gather_leaf(
            leaf, spec, run_mesh), p_specs, params)

    if sh.kind == "prefill":
        b_struct, b_specs = _batch_structs(cfg, sh, ba)
        if cfg.family == "audio":
            from repro_torch.models.common import unembed
            from repro_torch.models.encdec import decode_train, encode

            def fn(params, batch):
                params = whole(params)
                enc = encode(params, batch["frames"], cfg)
                x = decode_train(params, batch["tokens"], enc, cfg)
                return unembed(params["embed"], x[:, -1],
                               (cfg.vocab_size, cfg.d_model))
            fn = in_mesh(fn)
        else:
            from repro_torch.models.lm import lm_prefill

            @in_mesh
            def fn(params, batch):
                return lm_prefill(whole(params), batch, cfg)
        b_struct.pop("labels"), b_specs.pop("labels")
        return fn, (p_struct, b_struct), (p_specs, b_specs)

    # decode
    m = mesh.shape.get("model", 1)
    c_struct, c_specs = cache_structs(cfg, sh.batch, sh.seq, ba,
                                      **({"model": m} if m > 1 else {}),
                                      lif_replicated=True)
    c_specs = sanitize_specs(c_specs, c_struct, mesh)
    tok = _struct((sh.batch, 1), torch.int32)
    pos = _struct((sh.batch,), torch.int32)
    tok_spec = P(ba if sh.batch > 1 else None, None)
    pos_spec = P(ba if sh.batch > 1 else None)
    if cfg.family == "audio":
        from repro_torch.models.encdec import encdec_decode_step as step
        axes = map_specs(lambda _s, _leaf: 1, c_specs, c_struct)
    else:
        from repro_torch.models.lm import cache_batch_axes
        from repro_torch.models.lm import lm_decode_step as step
        axes = cache_batch_axes(cfg, c_struct)

    def rows(spec, leaf, axis):
        """A cache leaf as the step reads it: this rank's rows along its
        batch axis. Where the plan shards "data" on another dim (the
        hybrid's Mamba2 state, whose batch sits on axis 2, not 1), the
        leaf is gathered over it and cut to the rank's rows, the reshard a
        compiler would make each step. Where it puts "model" on the batch
        axis (the hybrid's conv state on 16 ranks), the leaf is gathered
        whole and cut to the rank's rows and its model part of the last
        dim (the conv's channels, which the step computes on)."""
        if run_mesh is None or sh.batch == 1:
            return leaf
        if mesh_mod.model_dim(spec, run_mesh) == axis:
            full = mesh_mod.gather_full(leaf, spec, run_mesh)
            want = [None] * leaf.ndim
            want[axis] = ba
            if full.shape[-1] % mesh.shape["model"] == 0:
                want[-1] = "model"
            return mesh_mod.local_shard(full, P(*want), run_mesh)
        if mesh_mod.batch_dim(spec, run_mesh) in (None, axis):
            return leaf
        want = P(*([None] * axis + [ba]))
        return mesh_mod.local_shard(mesh_mod.gather_leaf(leaf, spec, run_mesh),
                                    want, run_mesh)

    @in_mesh
    def fn(params, cache, tokens, pos):
        cache = map_specs(rows, c_specs, cache, axes)
        return step(whole(params), cache, tokens, pos, cfg)
    return fn, (p_struct, c_struct, tok, pos), \
        (p_specs, c_specs, tok_spec, pos_spec)
