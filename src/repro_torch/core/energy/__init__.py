"""E2ATST temporal-spatial energy/latency simulation framework (§IV-V).

The counterpart of ``repro.core.energy``, copied expression for expression
(numpy-free Python floats), so that every result is the reference's bit for
bit. The port keeps its own copy: importing the reference's would import
JAX through ``repro.core``.
"""
from repro_torch.core.energy.constants import (
    ArrayConfig, MemEnergies, OpEnergies, Sparsity, DEFAULT_ARRAY,
    DEFAULT_MEM, DEFAULT_OPS, DEFAULT_SPARSITY)
from repro_torch.core.energy.dataflow import (
    ALL_DATAFLOWS, Dataflow, Inner, Outer, best_dataflow, compute_cycles,
    mm_latency_cycles, mm_traffic, utilization)
from repro_torch.core.energy.energy_model import OpCost, elem_cost, mm_cost
from repro_torch.core.energy.simulator import (
    E2ATSTSimulator, SimResult, StageBreakdown, inference_energy_mj)
from repro_torch.core.energy.workload import (
    ElemOp, MMOp, SpikingWorkloadConfig, generic_mm_workload,
    spikingformer_training_workload)

__all__ = [
    "ArrayConfig", "MemEnergies", "OpEnergies", "Sparsity", "DEFAULT_ARRAY",
    "DEFAULT_MEM", "DEFAULT_OPS", "DEFAULT_SPARSITY", "ALL_DATAFLOWS",
    "Dataflow", "Inner", "Outer", "best_dataflow", "compute_cycles",
    "mm_latency_cycles", "mm_traffic", "utilization", "OpCost", "elem_cost",
    "mm_cost", "E2ATSTSimulator", "SimResult", "StageBreakdown",
    "inference_energy_mj", "ElemOp", "MMOp", "SpikingWorkloadConfig",
    "generic_mm_workload", "spikingformer_training_workload",
]
