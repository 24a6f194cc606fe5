"""The chaos checkpoint read fault on a mesh, through the training driver.

    python benchmarks/torch/chaos_mesh_drill.py \\
        [--arch spikingformer-8-512] [--batch 16] [--device cpu]

Runs ``python -m torch.distributed.run --nproc_per_node=4 -m
repro_torch.launch.train --policy cuda-full`` at data = 4 on one checkpoint
directory (a temporary one), three times, each rank's output in a log file
of its own:

1. steps 0-5 with a checkpoint every 2 steps (steps 2, 4 and 6 retained);
   the step-6 directory is then copied aside (pristine), and the whole
   checkpoint directory, step 6 left out, copied for the control;
2. to step 8 with ``--chaos-schedule`` holding one ``chaos.ckpt`` corrupt
   read fault at step 6, which every rank holds, a checkpoint every 4
   steps (so step 8 alone is written, and the damaged step 6 stays);
3. the control: the same from the copy, which resumes step 4, no fault.

Held: every rank warns that step 6 failed to restore and no rank warns of
another step; rank 0 resumes step 4; the step-6 victim differs from its
pristine copy in exactly one byte; the faulted run's step-8 checkpoint
equals the control's leaf for leaf (a rank that resumed another step would
have trained other shards into it). Prints one JSON line and exits 1 where
a check fails. ``--device cpu`` runs the ranks on gloo.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
RANKS, POLICY, TIMEOUT_S = 4, "cuda-full", 600
FAULT_STEP, FIRST_STEPS, LAST_STEPS, EVERY, LAST_EVERY = 6, 6, 8, 2, 4


def driver(args, ckpt: Path, steps: int, every: int, logs: Path,
           extra=()) -> dict:
    """One torchrun of the driver; each rank's stdout and stderr, by rank."""
    cmd = [sys.executable, "-m", "torch.distributed.run",
           f"--nproc_per_node={RANKS}", "--log-dir", str(logs),
           "--redirects", "3", "-m", "repro_torch.launch.train",
           "--arch", args.arch, "--steps", str(steps), "--batch",
           str(args.batch), "--ckpt-dir", str(ckpt), "--ckpt-every",
           str(every), "--policy", POLICY,
           *(["--device", args.device] if args.device else []), *extra]
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=TIMEOUT_S)
    ranks = {}
    for f in logs.rglob("stdout.log"):
        rank = int(f.parent.name)
        ranks[rank] = {"stdout": f.read_text(),
                       "stderr": (f.parent / "stderr.log").read_text()}
    if out.returncode != 0 or len(ranks) != RANKS:
        tails = {r: v["stderr"][-1500:] for r, v in ranks.items()}
        raise SystemExit(f"torchrun {steps} steps exited {out.returncode} "
                         f"with {len(ranks)} rank logs: {out.stderr[-1500:]}"
                         f"\n{tails}")
    return {"ranks": ranks, "seconds": time.perf_counter() - t0}


def leaves(step_dir: Path) -> dict[str, tuple[str, bytes]]:
    """Each leaf of a step: its CRC and its file's bytes, by name."""
    index = json.loads((step_dir / "index.json").read_text())
    return {n: (m["crc"], (step_dir / m["file"]).read_bytes())
            for n, m in index["leaves"].items()}


def drill(args, out: Path) -> int:
    ckpt, control = out / "ckpt", out / "control"
    first = driver(args, ckpt, FIRST_STEPS, EVERY, out / "logs_first")
    victim_dir = ckpt / f"step_{FAULT_STEP:08d}"
    shutil.copytree(victim_dir, out / "pristine")
    shutil.copytree(ckpt, control, ignore=shutil.ignore_patterns(
        victim_dir.name))
    sched = json.dumps({"seed": 3, "faults": [
        {"scope": "chaos.ckpt", "step": FAULT_STEP, "action": "corrupt",
         "mode": "read"}]})
    faulted = driver(args, ckpt, LAST_STEPS, LAST_EVERY,
                     out / "logs_faulted", ("--chaos-schedule", sched))
    ctrl = driver(args, control, LAST_STEPS, LAST_EVERY,
                  out / "logs_control")

    refused = {r: sorted({int(s) for s in re.findall(
        r"checkpoint step (\d+) in \S+ failed to restore", v["stderr"])})
        for r, v in faulted["ranks"].items()}
    restored = re.findall(r"\[restore\] step (\d+)",
                          faulted["ranks"][0]["stdout"])
    differing = {}
    for f in sorted((out / "pristine").iterdir()):
        now = (victim_dir / f.name).read_bytes()
        before = f.read_bytes()
        n = sum(a != b for a, b in zip(now, before)) + abs(len(now)
                                                           - len(before))
        if n:
            differing[f.name] = n
    last = f"step_{LAST_STEPS:08d}"
    got, want = leaves(ckpt / last), leaves(control / last)
    unequal = sorted(n for n in want if got.get(n) != want[n])
    checks = {
        "every_rank_refused_only_the_faulted_step": all(
            v == [FAULT_STEP] for v in refused.values())
        and len(refused) == RANKS,
        "rank0_resumed": [int(s) for s in restored] == [FAULT_STEP - EVERY],
        "victim_one_byte": list(differing.values()) == [1],
        "step8_equals_control": not unequal and set(got) == set(want)}
    row = {"ranks": RANKS, "arch": args.arch, "policy": POLICY,
           "batch": args.batch, "device": args.device or "cuda",
           "refused_by_rank": refused, "rank0_restored": restored,
           "victim_bytes_differing": differing, "leaves": len(want),
           "leaves_unequal_to_control": unequal, "checks": checks,
           "seconds": {"first": first["seconds"],
                       "faulted": faulted["seconds"],
                       "control": ctrl["seconds"]}}
    print(json.dumps(row), flush=True)
    return 0 if all(checks.values()) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="spikingformer-8-512")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="default: one card a rank; 'cpu' runs gloo ranks")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="chaos_mesh_") as tmp:
        return drill(args, Path(tmp))


if __name__ == "__main__":
    sys.exit(main())
