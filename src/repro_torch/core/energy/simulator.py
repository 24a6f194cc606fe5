"""End-to-end E2ATST training simulation (§IV-V).

Combines the workload extraction (Fig. 2 / Fig. 12), the dataflow model
(eq. 26-28) and the per-operator energy tables into the paper's headline
outputs: per-dataflow energy/latency breakdowns (Fig. 9, Fig. 10),
per-operator energy shares under the optimal dataflow (Fig. 11), and the
Table IX metrics (effective TFLOPS, array utilization, power, TFLOPS/W).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from repro_torch.core.energy.constants import (
    ArrayConfig, MemEnergies, OpEnergies, DEFAULT_ARRAY, DEFAULT_MEM,
    DEFAULT_OPS)
from repro_torch.core.energy.dataflow import ALL_DATAFLOWS, Dataflow
from repro_torch.core.energy.energy_model import OpCost, elem_cost, mm_cost
from repro_torch.core.energy.workload import (
    ElemOp, MMOp, SpikingWorkloadConfig, spikingformer_training_workload)

STAGES = ("FP", "BP", "WG")
KINDS = ("mm", "soma", "grad", "bn", "res")


@dataclasses.dataclass
class StageBreakdown:
    """Energy (J) by operator kind + latency (s) for one training stage."""

    energy_by_kind: dict[str, float]
    compute_j: float
    memory_j: float
    latency_s: float
    macs: int

    @property
    def energy_j(self) -> float:
        return self.compute_j + self.memory_j


@dataclasses.dataclass
class SimResult:
    dataflow: str
    stages: dict[str, StageBreakdown]

    @property
    def energy_j(self) -> float:
        return sum(s.energy_j for s in self.stages.values())

    @property
    def latency_s(self) -> float:
        return sum(s.latency_s for s in self.stages.values())

    @property
    def macs(self) -> int:
        return sum(s.macs for s in self.stages.values())

    @property
    def power_w(self) -> float:
        """Table IX: simulated power = total energy / total latency."""
        return self.energy_j / self.latency_s

    @property
    def eff_tflops(self) -> float:
        """Effective throughput: realized MAC flops over total runtime."""
        return 2 * self.macs / self.latency_s / 1e12

    @property
    def tflops_per_w(self) -> float:
        return self.eff_tflops / self.power_w


class E2ATSTSimulator:
    """The paper's integrated training simulator."""

    def __init__(self, workload: SpikingWorkloadConfig | None = None,
                 ops: OpEnergies = DEFAULT_OPS,
                 mem: MemEnergies = DEFAULT_MEM,
                 arr: ArrayConfig = DEFAULT_ARRAY,
                 spike_mm_energy: str = "add"):
        self.cfg = workload or SpikingWorkloadConfig()
        self.ops, self.mem, self.arr = ops, mem, arr
        self.spike_mm_energy = spike_mm_energy
        self.mms, self.elems = spikingformer_training_workload(self.cfg)

    # -- per-dataflow simulation -------------------------------------------
    def simulate(self, df: Dataflow) -> SimResult:
        costs: list[OpCost] = [
            mm_cost(m, df, self.ops, self.mem, self.arr, self.spike_mm_energy)
            for m in self.mms]
        costs += [elem_cost(e, self.ops, self.mem, self.arr)
                  for e in self.elems]
        stages = {}
        for st in STAGES:
            sel = [c for c in costs if c.stage == st]
            by_kind: dict[str, float] = defaultdict(float)
            for c in sel:
                key = "soma" if c.kind in ("soma", "grad") else c.kind
                by_kind[key] += c.total_j
            mm_cycles = sum(c.cycles for c in sel if c.kind == "mm")
            elem_cycles = sum(c.cycles for c in sel if c.kind != "mm")
            if self.arr.pipeline_elementwise:
                # Fig. 3: SOMA/BN/RES stream behind the MM array.
                cycles = max(mm_cycles, elem_cycles)
            else:
                cycles = mm_cycles + elem_cycles
            stages[st] = StageBreakdown(
                energy_by_kind=dict(by_kind),
                compute_j=sum(c.compute_j for c in sel),
                memory_j=sum(c.memory_j for c in sel),
                latency_s=cycles / self.arr.freq_hz,
                macs=sum(c.macs for c in sel))
        return SimResult(df.name, stages)

    def sweep(self) -> dict[str, SimResult]:
        """All nine dataflow schemes (Fig. 9 / Fig. 10)."""
        return {df.name: self.simulate(df) for df in ALL_DATAFLOWS}

    def optimal(self, metric: str = "energy") -> SimResult:
        res = self.sweep()
        key = (lambda r: r.energy_j) if metric == "energy" else \
              (lambda r: r.latency_s)
        return min(res.values(), key=key)

    # -- Table IX metrics ---------------------------------------------------
    def utilization(self, df: Dataflow) -> float:
        """Overall MAC-array utilization (eq. 28) over the MM workload."""
        from repro_torch.core.energy.dataflow import compute_cycles
        total_macs = sum(m.macs for m in self.mms)
        total_cycles = sum(compute_cycles(m, df, self.arr) for m in self.mms)
        return total_macs / (total_cycles * self.arr.rows * self.arr.cols)

    def table_ix(self, df: Dataflow | None = None) -> dict[str, float]:
        from repro_torch.core.energy.dataflow import Inner, Outer
        df = df or Dataflow(Inner.OS, Outer.C)
        r = self.simulate(df)
        return {
            "dataflow": df.name,
            "energy_mj": r.energy_j * 1e3,
            "latency_ms": r.latency_s * 1e3,
            "power_w": r.power_w,
            "eff_tflops": r.eff_tflops,
            "tflops_per_w": r.tflops_per_w,
            "mac_utilization": self.utilization(df),
            "peak_tflops": self.arr.peak_flops / 1e12,
        }


def inference_energy_mj(ops_g: float, sparsity: float,
                        e_mac_pj: float = 4.6, e_ac_pj: float = 0.9) -> float:
    """Table I-style SNN inference energy estimate (the standard 45 nm
    convention used by Spikformer/Spikingformer: E_MAC = 4.6 pJ for ANN MACs,
    E_AC = 0.9 pJ for spike-driven accumulates)."""
    return ops_g * 1e9 * (1.0 - sparsity) * e_ac_pj * 1e-12 * 1e3 \
        if sparsity > 0 else ops_g * 1e9 * e_mac_pj * 1e-12 * 1e3
