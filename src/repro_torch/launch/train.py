"""End-to-end training driver (the counterpart of ``repro.launch.train``).

Initialises the parameters and the optimizer state on the device, streams
the synthetic data, checkpoints asynchronously, watches for stragglers and
SIGTERM, budgets non-finite steps, and resumes from the newest good
checkpoint. The decoder LMs, the encoder-decoder and the Spikingformer
run through the same driver and the one train-step factory.

  python -m repro_torch.launch.train --arch qwen3-0.6b --reduced \\
      --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt [--device cpu]
  python -m repro_torch.launch.train --arch whisper-large-v3 --reduced \\
      --steps 5 --device cpu
  python -m repro_torch.launch.train --arch spikingformer-tiny \\
      --steps 100 --batch 16 --policy cuda-full --time-chunk 2

It runs on the CUDA device unless ``--device cpu`` is given, and raises
where there is none. As in the reference, the LM path checkpoints the
parameters (a resumed run starts a fresh optimizer state) and the vision
path the parameters, BN state and optimizer state. No fault injection
(ROADMAP A13). The audio family (``whisper-large-v3``) trains on zero
frame embeddings, the VLM stub on zero patches, as in the reference.

Data parallel over several GPUs, one process each:

  torchrun --nproc_per_node=N -m repro_torch.launch.train --arch ...

Under ``torchrun`` the driver builds a (world, 1) mesh, as the reference
builds (device_count, 1), and trains ZeRO-3 over "data"
(``train.loop.make_train_step(mesh=)``): every rank draws the global batch
of each step and keeps its rows (``train.data.place_batch``); rank 0
writes the checkpoints. ``train(mesh=...)`` takes a mesh from
``launch.mesh.make_test_mesh``; ``mesh=None`` is the single-device path.
A mesh with a model axis of more than 1 is ROADMAP A11c and raises.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.configs.registry import get_config, list_configs, reduced
from repro_torch.core.backend import resolve_device
from repro_torch.launch.mesh import local_shard, map_specs
from repro_torch.models.common import split_tree
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import (DataConfig, SyntheticLM, SyntheticVision,
                                    VisionDataConfig, place_batch)
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import (OptimizerConfig, init_opt_specs,
                                         init_opt_state)
from repro_torch.train.resilience import (NonFiniteGuard, PreemptionGuard,
                                          StragglerMonitor)


def _shard_tree(tree, specs, mesh):
    """Each leaf of ``tree`` (whole) -> this rank's slice under its
    spec."""
    return map_specs(lambda spec, leaf: local_shard(leaf, spec, mesh),
                     specs, tree)


def build_state(cfg, mesh=None, opt_cfg: OptimizerConfig | None = None,
                seed: int = 0, device=None):
    """LM (or, for the audio family, encoder-decoder) parameters from
    ``seed`` and a fresh AdamW state (with the compression residual where
    ``opt_cfg.compress_grads``): ``(params, opt_state, specs)``.

    Without a mesh the leaves are drawn on ``device`` (``None`` = the
    card) and ``specs`` are the logical ones. With one, every rank draws
    the whole leaves on the mesh's device from the same seed (the
    values do not depend on the mesh) and keeps its slices under the plan
    (``launch.specs.lm_specs``: sanitised, FSDP'd over "data"), which is
    ``specs``; the moments shard alike."""
    device = mesh.device if mesh is not None else resolve_device(device)
    if cfg.family == "audio":
        from repro_torch.models.encdec import init_encdec as init
    else:
        from repro_torch.models.lm import init_lm as init
    gen = torch.Generator(device=device).manual_seed(seed)
    params, specs = split_tree(init(gen, cfg, device))
    if mesh is not None:
        from repro_torch.launch.specs import lm_specs
        specs = lm_specs(cfg, mesh)[1]
        params = _shard_tree(params, specs, mesh)
    compress = opt_cfg is not None and opt_cfg.compress_grads
    return params, init_opt_state(params, compress), specs


def build_spikingformer_state(cfg, mesh=None,
                              opt_cfg: OptimizerConfig | None = None,
                              seed: int = 0, fsdp_min_elems: int = 1 << 20,
                              device=None):
    """Spikingformer parameters and BN state from ``seed`` and a fresh
    AdamW state: ``(params, state, opt_state, (p_specs, s_specs))``, the
    specs of the plan on ``mesh`` (``launch.specs.spikingformer_structs``;
    the logical ones without a mesh). With a mesh the parameters and
    moments are this rank's slices of the whole leaves, which every rank
    draws from the same seed; the BN state is whole on every rank."""
    from repro_torch.core.spikingformer import (init_spikingformer,
                                                spikingformer_param_specs)
    device = mesh.device if mesh is not None else resolve_device(device)
    params, state = init_spikingformer(torch.Generator().manual_seed(seed),
                                       cfg, device)
    if mesh is None:
        specs = spikingformer_param_specs(cfg)
    else:
        from repro_torch.launch.specs import spikingformer_structs
        specs = spikingformer_structs(cfg, mesh, fsdp_min_elems)[1]
        params = _shard_tree(params, specs[0], mesh)
    compress = opt_cfg is not None and opt_cfg.compress_grads
    return params, state, init_opt_state(params, compress), specs


def _opt_specs(p_specs, opt_cfg: OptimizerConfig):
    """The optimizer state's specs; the residual shards like the moments."""
    specs = init_opt_specs(p_specs)
    if opt_cfg.compress_grads:
        specs["err"] = p_specs
    return specs


def lm_step_batch(cfg, batch: dict, device, mesh=None
                  ) -> dict[str, torch.Tensor]:
    """A ``SyntheticLM`` batch on ``device`` (with ``mesh``, this rank's
    rows on the mesh's device) with the inputs the
    family's frontend stub takes, as the reference driver adds them: zero
    ``frames`` (B, encoder_seq, d_model) for the audio family, zero
    ``patch_embeds`` (B, S, d_model) and an all-False ``patch_mask``
    (B, S) for the VLM stub, in ``cfg.dtype``."""
    out = place_batch(batch, mesh, device)
    device = mesh.device if mesh is not None else device
    bsz, s = out["tokens"].shape
    if cfg.family == "audio":
        out["frames"] = torch.zeros((bsz, cfg.encoder_seq, cfg.d_model),
                                    dtype=cfg.dtype, device=device)
    if cfg.vlm_stub:
        out["patch_embeds"] = torch.zeros((bsz, s, cfg.d_model),
                                          dtype=cfg.dtype, device=device)
        out["patch_mask"] = torch.zeros((bsz, s), dtype=torch.bool,
                                        device=device)
    return out


def _drive(*, start: int, steps: int, step_once, save, log_line,
           log_every: int, ckpt_every: int, ckpt_dir: str | None,
           nonfinite_budget: int = 3, final_join_timeout: float = 120.0,
           on_step=None, mesh=None):
    """The loop every family shares: straggler monitor, preemption guard,
    non-finite skip budget, checkpoint cadence, and the final join of the
    asynchronous save (the last write must land before a restart scans
    the checkpoint directory).

    ``step_once(step) -> metrics`` advances the caller's state (held in a
    closure); ``save(step)`` persists it and returns the writer thread;
    ``log_line(step, metrics)`` formats the progress line. A step's time,
    as the straggler monitor records it, runs until its loss is on the
    host. ``on_step(step, metrics)``, when given, is called with every
    step's metrics once the loss is on the host. Returns the per-step loss
    history.

    More than ``nonfinite_budget`` consecutive skipped steps raise
    ``NonFiniteBudgetExceeded``; a final writer still alive after
    ``final_join_timeout`` seconds raises ``ckpt.CheckpointWriteTimeout``.
    On a mesh every rank waits for rank 0's last write at a barrier. Only
    rank 0 prints.
    """
    if mesh is not None and mesh.rank != 0:
        log_line = None
    monitor = StragglerMonitor(
        on_straggler=lambda dt, med: print(
            f"[straggler] step took {dt:.3f}s (median {med:.3f}s)"))
    guard = PreemptionGuard().install()
    nf_guard = NonFiniteGuard(budget=nonfinite_budget)
    history = []
    pending_save = None
    try:
        for step in range(start, steps):
            monitor.step_start()
            metrics = step_once(step)
            history.append(float(metrics["loss"]))
            monitor.step_end()
            if on_step is not None:
                on_step(step, metrics)
            if nf_guard.observe(float(metrics.get("nonfinite", 0.0)) > 0.0,
                                step):
                print(f"[guard] step {step} non-finite loss/grads: state "
                      f"unchanged, step skipped "
                      f"({nf_guard.consecutive}/{nf_guard.budget} "
                      f"consecutive)", flush=True)
            if log_line is not None and (step % log_every == 0
                                         or step == steps - 1):
                print(log_line(step, metrics), flush=True)
            if ckpt_dir and ((step + 1) % ckpt_every == 0
                             or guard.requested):
                pending_save = save(step + 1)
                if guard.requested:
                    print("[preempt] checkpoint saved, exiting")
                    break
    finally:
        guard.uninstall()
    if (pending_save is not None or (mesh is not None and ckpt_dir)) and \
            not ckpt.finish_save(pending_save, mesh, final_join_timeout):
        raise ckpt.CheckpointWriteTimeout(
            f"final async checkpoint write still running after "
            f"{final_join_timeout:.0f}s: the run's last state may not be on "
            f"disk; a restart would resume from an older step")
    return history


def train_vision(cfg, *, steps: int, global_batch: int,
                 ckpt_dir: str | None, mesh=None, microbatches: int = 1,
                 log_every: int = 10, ckpt_every: int = 100, seed: int = 0,
                 lr: float = 2e-3, device=None, on_step=None,
                 compress_grads: bool = False):
    """Spikingformer BPTT training through the shared driver: synthetic
    quadrant-blob data, checkpoints of parameters + BN state + optimizer
    state (restored onto any mesh). ``mesh``: data parallel, ZeRO-3 over
    "data", BN statistics of the global batch."""
    device = mesh.device if mesh is not None else resolve_device(device)
    opt_cfg = OptimizerConfig(lr=lr, total_steps=steps, weight_decay=0.01,
                              warmup_steps=max(steps // 20, 5),
                              compress_grads=compress_grads)
    params, state, opt_state, (p_specs, s_specs) = \
        build_spikingformer_state(cfg, mesh, opt_cfg, seed, device=device)
    specs = {"params": p_specs, "state": s_specs,
             "opt": _opt_specs(p_specs, opt_cfg)}

    start = 0
    if ckpt_dir:
        tree = {"params": params, "state": state, "opt": opt_state}
        latest, restored = ckpt.restore_latest_good(
            ckpt_dir, tree, mesh, specs if mesh is not None else None)
        if latest is not None:
            if mesh is None or mesh.rank == 0:
                print(f"[restore] step {latest} from {ckpt_dir}")
            params, state, opt_state = (restored["params"],
                                        restored["state"], restored["opt"])
            start = latest

    data = SyntheticVision(VisionDataConfig(
        image_size=cfg.image_size, num_classes=cfg.num_classes,
        global_batch=global_batch, channels=cfg.in_channels, seed=seed,
        spikes=cfg.spike_input))
    # microbatches != 1 raises in the factory (BN stats are per-global-batch)
    step_fn = make_train_step(cfg, opt_cfg, microbatches, mesh=mesh,
                              specs=p_specs if mesh is not None else None)

    def step_once(step):
        nonlocal params, state, opt_state
        batch = place_batch(data.batch(step), mesh, device)
        params, state, opt_state, metrics = step_fn(
            params, state, opt_state, batch["images"], batch["labels"])
        return metrics

    def save(step):
        return ckpt.save_checkpoint(
            ckpt_dir, step,
            {"params": params, "state": state, "opt": opt_state},
            specs if mesh is not None else None, async_save=True, mesh=mesh)

    def log_line(step, m):
        return (f"step {step:5d} loss {float(m['loss']):.4f} "
                f"acc {float(m['accuracy']):.2f} "
                f"gnorm {float(m['grad_norm']):.3f} "
                f"lr {float(m['lr']):.2e}")

    history = _drive(start=start, steps=steps, step_once=step_once,
                     save=save, log_line=log_line, log_every=log_every,
                     ckpt_every=ckpt_every, ckpt_dir=ckpt_dir,
                     on_step=on_step, mesh=mesh)
    return params, history


def train(cfg, *, steps: int, global_batch: int, seq_len: int = 128,
          ckpt_dir: str | None = None, mesh=None, microbatches: int = 1,
          log_every: int = 10, ckpt_every: int = 100, seed: int = 0,
          data_vocab: int | None = None, lr: float | None = None,
          device=None, on_step=None, compress_grads: bool = False):
    """Family dispatch: ``lr=None`` picks the family's default (3e-4 for an
    LM, 2e-3 for the small vision models). ``device=None`` is the card;
    ``mesh`` trains data parallel on it (the parameters returned are this
    rank's shards). ``compress_grads``: int8 compression of the reduced
    gradient with error feedback. Returns ``(params, loss history)``."""
    if getattr(cfg, "family", None) == "vision":
        return train_vision(cfg, steps=steps, global_batch=global_batch,
                            ckpt_dir=ckpt_dir, mesh=mesh,
                            microbatches=microbatches,
                            log_every=log_every, ckpt_every=ckpt_every,
                            seed=seed, lr=lr if lr is not None else 2e-3,
                            device=device, on_step=on_step,
                            compress_grads=compress_grads)
    device = mesh.device if mesh is not None else resolve_device(device)
    opt_cfg = OptimizerConfig(lr=lr if lr is not None else 3e-4,
                              total_steps=steps,
                              warmup_steps=max(steps // 20, 5),
                              compress_grads=compress_grads)
    params, opt_state, specs = build_state(cfg, mesh, opt_cfg, seed,
                                           device=device)

    start = 0
    if ckpt_dir:
        latest, restored = ckpt.restore_latest_good(
            ckpt_dir, params, mesh, specs if mesh is not None else None)
        if latest is not None:
            if mesh is None or mesh.rank == 0:
                print(f"[restore] step {latest} from {ckpt_dir}")
            params = restored
            start = latest

    data = SyntheticLM(DataConfig(
        vocab_size=data_vocab or cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, seed=seed))
    # The driver owns its state: the step updates it in place, as the
    # reference driver donates it to its jitted step.
    step_fn = make_train_step(cfg, opt_cfg, microbatches, mesh=mesh,
                              specs=specs if mesh is not None else None,
                              donate=True)

    def step_once(step):
        nonlocal params, opt_state
        params, opt_state, metrics = step_fn(
            params, opt_state,
            lm_step_batch(cfg, data.batch(step), device, mesh))
        return metrics

    def save(step):
        return ckpt.save_checkpoint(ckpt_dir, step, params, specs,
                                    async_save=True, mesh=mesh)

    def log_line(step, m):
        return (f"step {step:5d} loss {float(m['loss']):.4f} "
                f"gnorm {float(m['grad_norm']):.3f} "
                f"lr {float(m['lr']):.2e}")

    history = _drive(start=start, steps=steps, step_once=step_once,
                     save=save, log_line=log_line, log_every=log_every,
                     ckpt_every=ckpt_every, ckpt_dir=ckpt_dir,
                     on_step=on_step, mesh=mesh)
    return params, history


def _resolve_config(args):
    """LM registry first; Spikingformer preset names (optionally with an
    ``@<policy>`` suffix) route to the vision path. Flags that only exist
    for the other family are rejected, never silently dropped."""
    try:
        cfg = get_config(args.arch)
    except KeyError:
        from repro_torch.configs.spikingformer import (
            get_spikingformer_config, list_spikingformer_configs)
        from repro_torch.core.policy import named_policy
        if args.reduced:
            raise SystemExit("--reduced applies to LM/audio archs only; "
                             "pick a smaller spikingformer preset instead")
        if args.data_vocab is not None or args.seq is not None:
            raise SystemExit("--data-vocab/--seq apply to LM/audio archs "
                             "only (the vision data stream is sized by the "
                             "preset's image_size/num_classes)")
        try:
            return get_spikingformer_config(
                args.arch,
                policy=named_policy(args.policy) if args.policy else None,
                time_chunk=args.time_chunk)
        except KeyError:
            raise SystemExit(
                f"unknown --arch {args.arch!r}; LM/audio: {list_configs()}; "
                f"vision: {list_spikingformer_configs()}") from None
    if args.policy or args.time_chunk:
        raise SystemExit("--policy/--time-chunk apply to spikingformer "
                         f"archs only, not {args.arch!r}")
    if args.reduced:
        cfg = reduced(cfg)
    return cfg


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=None,
                    help="LM sequence length (default 128)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--data-vocab", type=int, default=None)
    ap.add_argument("--policy", default=None,
                    help="execution policy preset for spikingformer archs")
    ap.add_argument("--time-chunk", type=int, default=None,
                    help="temporal tile length for spikingformer BPTT")
    ap.add_argument("--chaos-schedule", default=None,
                    help="fault-injection schedule: not ported (ROADMAP A13)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "PyTorch versions of the kernels")
    args = ap.parse_args(argv)
    if args.chaos_schedule or os.environ.get("CHAOS_SCHEDULE"):
        raise NotImplementedError(
            "fault injection (--chaos-schedule, $CHAOS_SCHEDULE) is not "
            "ported yet (ROADMAP A13)")
    cfg = _resolve_config(args)
    mesh = None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        from repro_torch.launch.mesh import (init_distributed,
                                             make_test_mesh,
                                             shutdown_distributed)
        _, world, _ = init_distributed(args.device)
        mesh = make_test_mesh(world, 1)
    try:
        _, history = train(cfg, steps=args.steps, global_batch=args.batch,
                           seq_len=args.seq if args.seq is not None else 128,
                           ckpt_dir=args.ckpt_dir, mesh=mesh,
                           microbatches=args.microbatches,
                           data_vocab=args.data_vocab, device=args.device)
    finally:
        if mesh is not None:
            shutdown_distributed()
    if mesh is None or mesh.rank == 0:
        print(f"final loss {history[-1]:.4f} (from {history[0]:.4f})")


if __name__ == "__main__":
    main()
