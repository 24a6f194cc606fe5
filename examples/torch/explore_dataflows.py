"""Dataflow design-space exploration (the paper's §V study, interactive).

Sweeps the nine dataflow schemes over configurable workload/hardware knobs
(timesteps, batch, model width, spike sparsity, array size) and prints how
the optimal dataflow and the Table IX metrics move — the kind of hardware
trade-off study the E2ATST framework was built for. Also runs the T2
generalization: the E2ATST MM energy model applied to one of the assigned
LM architectures.

Run:  PYTHONPATH=src python examples/torch/explore_dataflows.py

The port's twin of ``examples/explore_dataflows.py``, on
``repro_torch.core.energy`` (the paper's analytic model, a copy of the
reference's): it prints the reference script's lines, figure for figure.
The model is arithmetic on the host, so this example uses no device.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.core.energy import (DEFAULT_ARRAY, E2ATSTSimulator,
                                     SpikingWorkloadConfig, Sparsity,
                                     best_dataflow, generic_mm_workload,
                                     mm_cost)


def headline(sim: E2ATSTSimulator) -> str:
    m = sim.table_ix()
    opt = sim.optimal("energy")
    return (f"opt={opt.dataflow:5s} E={opt.energy_j * 1e3:7.0f} mJ "
            f"t={opt.latency_s * 1e3:6.0f} ms "
            f"{m['eff_tflops']:.2f} TFLOPS {m['tflops_per_w']:.2f} TFLOPS/W")


def main(argv=None) -> None:
    argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]).parse_args(argv)
    print("== baseline (paper Table III config) ==")
    print("   ", headline(E2ATSTSimulator()))

    print("\n== timestep sweep (temporal dimension scaling) ==")
    for t in (1, 2, 4, 8):
        sim = E2ATSTSimulator(SpikingWorkloadConfig(T=t))
        print(f"T={t}: ", headline(sim))

    print("\n== spike-sparsity sweep (event-driven energy scaling) ==")
    for s in (0.5, 0.7, 0.8, 0.9, 0.95):
        sim = E2ATSTSimulator(SpikingWorkloadConfig(
            sparsity=Sparsity(s_s=s)))
        print(f"s_s={s}: ", headline(sim))

    print("\n== array-size sweep (64x64 is the paper's choice) ==")
    for n in (32, 64, 128, 256):
        arr = dataclasses.replace(DEFAULT_ARRAY, rows=n, cols=n)
        sim = E2ATSTSimulator(arr=arr)
        print(f"{n}x{n}: ", headline(sim))

    print("\n== T2 generalization: E2ATST MM energy for qwen3-0.6b "
          "(1 layer) ==")
    d, f, s = 1024, 3072, 4096
    mms = generic_mm_workload("qwen3", [
        ("qkv", s, d, 3 * d), ("o", s, d, d),
        ("gate_up", s, d, 2 * f), ("down", s, f, d)], num_layers=1)
    df = best_dataflow(mms)
    total = sum(mm_cost(m, df).total_j for m in mms) * 1e3
    print(f"best dataflow {df.name}; 1-layer fwd energy {total:.2f} mJ "
          f"on the 64x64 FP16 array")


if __name__ == "__main__":
    main()
