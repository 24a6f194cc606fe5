"""End-to-end chaos run: seeded faults + orchestrator-style restarts.

``python -m repro_torch.chaos.runner`` (the counterpart of
``repro.chaos.runner``) drives a real training run through
``repro_torch.launch.train.train`` under an active :class:`FaultSchedule`
and plays the orchestrator: a crash (injected raise, kernel fault at an
undemotable site, exceeded non-finite budget, lost final checkpoint)
restarts the run, which resumes from the newest *restorable* checkpoint
(``restore_latest_good`` skips corrupted ones); a SIGTERM preemption
checkpoints and exits and is likewise restarted. The run is **clean** when
training reaches the target step and the final checkpoint passes its
integrity check; the command exits non-zero otherwise.

    python -m repro_torch.chaos.runner --arch spikingformer-8-512 \\
        --steps 8 --ckpt-every 2 --batch 16 --policy cuda-full --seed 9 \\
        --ckpt-dir ckpt [--device cpu]

It runs on the CUDA device unless ``--device cpu`` is given. Everything is
deterministic given the schedule (pass ``--schedule`` to replay a saved
one): the same faults fire at the same steps, recovery takes the same
path, and the injector's event log and the loss history come out
identical. The report (``--report-out``) holds no wall-clock figure; the
command prints the steps' wall times and the peak device memory on a line
of their own (``[chaos-runner] timing: {...}``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import time

import torch

from repro_torch.chaos.inject import (ChaosInjector, ChaosKernelFault,
                                      ChaosStepFault, activate, active,
                                      deactivate, load_schedule)
from repro_torch.chaos.schedule import FaultSchedule

__all__ = ["ChaosReport", "default_schedule", "run_chaos", "main"]


@dataclasses.dataclass
class ChaosReport:
    """Outcome of one chaos run (replay-comparable: no wall-clock)."""

    completed: bool
    restarts: int
    final_step: int | None
    final_ckpt_ok: bool
    events: list[str]
    history: list[float]
    breaker_sites: list[str]

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def summary(self) -> str:
        lines = [f"completed={self.completed} restarts={self.restarts} "
                 f"final_step={self.final_step} "
                 f"final_ckpt_ok={self.final_ckpt_ok}"]
        lines += [f"  event: {e}" for e in self.events]
        if self.breaker_sites:
            lines.append(f"  breaker-demoted sites: "
                         f"{', '.join(self.breaker_sites)}")
        return "\n".join(lines)


def default_schedule(seed: int, *, steps: int, ckpt_every: int,
                     kernel_sites: tuple[str, ...] = (),
                     n_faults: int = 4) -> FaultSchedule:
    return FaultSchedule.generate(seed, steps=steps, ckpt_every=ckpt_every,
                                  kernel_sites=kernel_sites,
                                  n_faults=n_faults)


def run_chaos(arch: str = "spikingformer-smoke", *, steps: int = 16,
              ckpt_every: int = 4, global_batch: int = 4, seed: int = 0,
              ckpt_dir: str, schedule: FaultSchedule | None = None,
              policy: str | None = None, max_restarts: int = 6,
              fresh: bool = True, device=None, on_step=None) -> ChaosReport:
    """Train ``arch`` to ``steps`` under chaos, restarting on failure.

    ``steps`` must be a multiple of ``ckpt_every``: the final save is the
    completion marker a restarting orchestrator can observe. Activates
    ``schedule`` unless an injector is already active (so a test can hold
    its own injector and inspect events); deactivates only what it
    activated. ``fresh`` wipes ``ckpt_dir`` first. ``device``: ``None`` is
    the card. ``on_step(step, metrics)`` is handed to every attempt's
    ``train``.
    """
    from repro_torch.configs.spikingformer import get_spikingformer_config
    from repro_torch.core.policy import breaker_trips, named_policy
    from repro_torch.launch.train import train
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.resilience import NonFiniteBudgetExceeded

    if steps % ckpt_every != 0:
        raise ValueError(f"steps ({steps}) must be a multiple of "
                         f"ckpt_every ({ckpt_every}) so completion is "
                         f"checkpoint-observable")
    if fresh and os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)

    owns_injector = active() is None
    injector: ChaosInjector = active() or activate(
        schedule or default_schedule(seed, steps=steps,
                                     ckpt_every=ckpt_every))
    cfg = get_spikingformer_config(
        arch, policy=named_policy(policy) if policy else None)

    restarts = 0
    history: list[float] = []
    try:
        while True:
            try:
                _, history = train(
                    cfg, steps=steps, global_batch=global_batch,
                    ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                    log_every=max(1, steps // 4), seed=seed, device=device,
                    on_step=on_step)
            except (ChaosStepFault, ChaosKernelFault,
                    NonFiniteBudgetExceeded,
                    ckpt.CheckpointWriteTimeout) as e:
                restarts += 1
                print(f"[chaos-runner] run died ({type(e).__name__}: {e}); "
                      f"restart {restarts}/{max_restarts}", flush=True)
                if restarts > max_restarts:
                    raise
                continue
            final = ckpt.latest_step(ckpt_dir)
            if final is not None and final >= steps:
                break               # completion marker on disk
            # Preemption (or a crash caught upstream): resume.
            restarts += 1
            print(f"[chaos-runner] run exited at checkpoint {final} < "
                  f"{steps}; restart {restarts}/{max_restarts}", flush=True)
            if restarts > max_restarts:
                break
        final = ckpt.latest_step(ckpt_dir)
        final_ok = final is not None and \
            not ckpt.verify_checkpoint(ckpt_dir, final)
        return ChaosReport(
            completed=bool(final is not None and final >= steps),
            restarts=restarts, final_step=final, final_ckpt_ok=final_ok,
            events=list(injector.events), history=list(history),
            breaker_sites=sorted(breaker_trips()))
    finally:
        if owns_injector:
            deactivate()


def _timing(stamps: list[tuple[int, float]], device) -> dict:
    """Wall ms of each step whose predecessor's number came just before
    it (the host clock between the driver's ``on_step`` calls, each made
    once the step's loss is on the host; a save's host copy falls in the
    next step's time, and so does a restore where a restart resumes at the
    step after the last one taken), and the peak device memory (None off
    the card)."""
    ms = [[b[0], (b[1] - a[1]) * 1e3] for a, b in zip(stamps, stamps[1:])
          if b[0] == a[0] + 1]
    on_card = str(device or "cuda").startswith("cuda")
    return {"step_ms": ms,
            "peak_memory_bytes": torch.cuda.max_memory_allocated()
            if on_card else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="spikingformer-smoke")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--ckpt-every", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--policy", default=None,
                    help="execution policy preset (cuda/cuda-full add "
                         "demotable kernel sites)")
    ap.add_argument("--schedule", default=None,
                    help="replay a saved schedule (JSON file or inline "
                         "JSON) instead of generating one from --seed")
    ap.add_argument("--n-faults", type=int, default=4)
    ap.add_argument("--max-restarts", type=int, default=6)
    ap.add_argument("--dump-schedule", default=None,
                    help="write the (generated or given) schedule JSON here")
    ap.add_argument("--report-out", default=None,
                    help="write the run report JSON here (replay "
                         "comparison: two runs of one schedule must match)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "PyTorch versions of the kernels")
    args = ap.parse_args(argv)

    if args.schedule:
        schedule = load_schedule(args.schedule)
    else:
        # Target a kernel site only when the policy routes it off the eager
        # arm (an eager-site fault has no demotion target: it would only
        # crash and restart, which chaos.step already covers).
        sites = ("pssa.qkv",) if args.policy and args.policy != "eager" \
            else ()
        schedule = default_schedule(args.seed, steps=args.steps,
                                    ckpt_every=args.ckpt_every,
                                    kernel_sites=sites,
                                    n_faults=args.n_faults)
    if args.dump_schedule:
        schedule.to_file(args.dump_schedule)
    print(f"[chaos-runner] schedule: "
          f"{json.dumps(json.loads(schedule.to_json()))}", flush=True)

    stamps: list[tuple[int, float]] = []
    report = run_chaos(args.arch, steps=args.steps,
                       ckpt_every=args.ckpt_every, global_batch=args.batch,
                       seed=args.seed, ckpt_dir=args.ckpt_dir,
                       schedule=schedule, policy=args.policy,
                       max_restarts=args.max_restarts, device=args.device,
                       on_step=lambda step, m: stamps.append(
                           (step, time.perf_counter())))
    print(report.summary(), flush=True)
    print(f"[chaos-runner] timing: "
          f"{json.dumps(_timing(stamps, args.device))}", flush=True)
    if args.report_out:
        with open(args.report_out, "w") as f:
            f.write(report.to_json())
    if not (report.completed and report.final_ckpt_ok):
        print("[chaos-runner] FAIL: run did not recover cleanly", flush=True)
        return 1
    print("[chaos-runner] clean recovery", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
