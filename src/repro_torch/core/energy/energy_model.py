"""Per-operator energy models (E2ATST Tables IV, V, VII, VIII).

Computation energy follows the paper's operator formulas verbatim; memory
access energy follows the three-level hierarchy of Table VI with the traffic
counts of ``dataflow.mm_traffic`` (MM) and the operand flows of Fig. 2
(element-wise SOMA / GRAD / BN / RES, including the temporal-signal
persistence: membrane potentials U, spikes S, and gradient masks written
during FP and read back during BP — the paper's "temporal-spatial" storage).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.energy.constants import (
    ArrayConfig, MemEnergies, OpEnergies, DEFAULT_ARRAY, DEFAULT_MEM,
    DEFAULT_OPS)
from repro_torch.core.energy.dataflow import Dataflow, Traffic, mm_traffic
from repro_torch.core.energy.workload import ElemOp, MMOp

PJ = 1e-12


@dataclasses.dataclass
class OpCost:
    """Energy (J) and latency (cycles) of one operator instance."""

    name: str
    stage: str            # FP | BP | WG
    kind: str             # mm | soma | grad | bn | res
    compute_j: float
    memory_j: float
    cycles: float
    macs: int = 0

    @property
    def total_j(self) -> float:
        return self.compute_j + self.memory_j


def traffic_energy(tr: Traffic, mem: MemEnergies) -> float:
    """Joules for a Traffic record (Table VI energies are pJ/bit)."""
    return PJ * (
        tr.dram_r * mem.dram_r + tr.dram_w * mem.dram_w +
        tr.sram_in_r * mem.sram_spike_r + tr.sram_in_w * mem.sram_spike_w +
        tr.sram_w_r * mem.sram_w_r + tr.sram_w_w * mem.sram_w_w +
        tr.sram_out_r * mem.sram_out_r + tr.sram_out_w * mem.sram_out_w +
        tr.reg_r * mem.reg_r + tr.reg_w * mem.reg_w)


# ---------------------------------------------------------------------------
# Matrix multiplication (Tables IV/V/VII/VIII, E_MM rows)
# ---------------------------------------------------------------------------

def mm_cost(mm: MMOp, df: Dataflow, ops: OpEnergies = DEFAULT_OPS,
            mem: MemEnergies = DEFAULT_MEM,
            arr: ArrayConfig = DEFAULT_ARRAY,
            spike_mm_energy: str = "add") -> OpCost:
    """Spike-operand MMs (FP & WG) use addition-only PEs (§III-A): each
    non-zero spike contributes one FP16 add. BP MMs are full FP16 MACs.
    ``spike_mm_energy='mac'`` reverts to Table IV's literal E_MAC charge."""
    dense = 1.0 - mm.in_sparsity
    if mm.in_bits == 1 and spike_mm_energy == "add":
        e_per = ops.E_ADD
    else:
        e_per = ops.E_MAC
    compute = mm.macs * dense * e_per * PJ
    tr = mm_traffic(mm, df, arr)
    from repro_torch.core.energy.dataflow import mm_latency_cycles
    # spike banks only hold 1-bit operands; FP16 inputs go to the act bank.
    mem_eff = mem if mm.in_bits == 1 else dataclasses.replace(
        mem, sram_spike_r=mem.sram_act_r, sram_spike_w=mem.sram_act_w)
    return OpCost(mm.name, mm.stage, "mm", compute,
                  traffic_energy(tr, mem_eff),
                  mm_latency_cycles(mm, df, arr), macs=mm.macs)


# ---------------------------------------------------------------------------
# Element-wise operators
# ---------------------------------------------------------------------------

def _elem_latency(n_ops: float, bits: float, arr: ArrayConfig,
                  lanes: int = 64) -> float:
    """Vector-unit latency bound by lanes and by memory streaming."""
    return max(n_ops / lanes, bits / 8 / arr.sram_bytes_per_cycle)


def soma_cost(op: ElemOp, ops: OpEnergies, mem: MemEnergies,
              arr: ArrayConfig) -> OpCost:
    """SOMA (Table IV): per neuron-timestep E_MUL + 4 E_MUX + E_ADD.

    Memory per element: read x (16b) + U_prev (16b) + S_prev (1b) from the
    activation banks; write U (16b), S (1b), grad-mask (1b). U / S / mask are
    also persisted to DRAM for the BP GRAD pass (temporal-signal storage)."""
    n = op.n_elems
    compute = n * (ops.E_MUL + 4 * ops.E_MUX + ops.E_ADD) * PJ
    sram_r = n * (16 + 16 + 1)
    sram_w = n * (16 + 1 + 1)
    dram_w = n * (16 + 1 + 1)          # persist U, S, mask for BP
    tr = Traffic(dram_w=dram_w, sram_in_r=n * 1, sram_in_w=n * 2,
                 sram_out_r=sram_r - n, sram_out_w=sram_w - n * 2,
                 reg_r=n * 33, reg_w=n * 18)
    return OpCost(op.name, op.stage, "soma", compute, traffic_energy(tr, mem),
                  _elem_latency(n, sram_r + sram_w, arr))


def grad_cost(op: ElemOp, ops: OpEnergies, mem: MemEnergies,
              arr: ArrayConfig) -> OpCost:
    """GRAD (Table VII): 3 E_MUX + 2 E_ADD + 3 E_MUL per element.

    Reads the persisted U (16b), S (1b), mask (1b) back from DRAM plus the
    upstream gradient (16b); writes the membrane-potential gradient (16b)."""
    n = op.n_elems
    compute = n * (3 * ops.E_MUX + 2 * ops.E_ADD + 3 * ops.E_MUL) * PJ
    dram_r = n * (16 + 1 + 1)
    tr = Traffic(dram_r=dram_r,
                 sram_out_r=n * 32, sram_out_w=n * 16,
                 reg_r=n * 50, reg_w=n * 16)
    return OpCost(op.name, op.stage, "grad", compute, traffic_energy(tr, mem),
                  _elem_latency(n, n * 66, arr))


def bn_fp_cost(op: ElemOp, ops: OpEnergies, mem: MemEnergies,
               arr: ArrayConfig) -> OpCost:
    """FP BatchNorm (Table IV): E_mu + E_sigma2 + E_y per feature lane d
    with S samples (eq. 13-18)."""
    d, s = op.n_features, op.n_samples
    e_mu = (ops.E_DIV + s * ops.E_ADD) * d
    e_var = (ops.E_SUB + (1 + s) * ops.E_MUL + ops.E_DIV) * d
    e_y = (ops.E_SQRT + ops.E_ADD) * d + \
        (ops.E_SUB + ops.E_MUL + ops.E_DIV + ops.E_ADD) * d * s
    compute = (e_mu + e_var + e_y) * PJ
    n = d * s
    # two passes over x (stats + normalize), write y; save mu/sqrt for BP.
    sram_bits = n * 16 * 3 + d * 32 * 2
    tr = Traffic(sram_out_r=n * 32, sram_out_w=n * 16 + d * 64,
                 reg_r=n * 48, reg_w=n * 16)
    return OpCost(op.name, op.stage, "bn", compute, traffic_energy(tr, mem),
                  _elem_latency(2 * n, sram_bits, arr))


def bn_bp_cost(op: ElemOp, ops: OpEnergies, mem: MemEnergies,
               arr: ArrayConfig) -> OpCost:
    """BP BatchNorm (Table VII): the eight sub-components of eq. 19-23."""
    d, s = op.n_features, op.n_samples
    e_m = (ops.E_MUL + ops.E_DIV) * d * s
    e_mn = ops.E_MUL * d * s
    e_sums = 3 * ops.E_ADD * (s - 1) * d          # S_N, S_M, S_MN
    e_dgamma = ops.E_DIV * d
    e_dbeta = ops.E_ADD * (s - 1) * d
    e_dx = (6 * ops.E_MUL + 3 * ops.E_DIV + 2 * ops.E_SUB + ops.E_ADD) * d * s
    compute = (e_m + e_mn + e_sums + e_dgamma + e_dbeta + e_dx) * PJ
    n = d * s
    # read g and N (= x normalized, recomputed from saved mu/sqrt), write dx.
    tr = Traffic(sram_out_r=n * 48, sram_out_w=n * 16,
                 reg_r=n * 64, reg_w=n * 24)
    return OpCost(op.name, op.stage, "bn", compute, traffic_energy(tr, mem),
                  _elem_latency(3 * n, n * 64, arr))


def res_cost(op: ElemOp, ops: OpEnergies, mem: MemEnergies,
             arr: ArrayConfig) -> OpCost:
    """Residual add (Tables IV/VII): one FP16 add per element; reads the two
    summands, writes the fused map (cyan path of Fig. 4)."""
    n = op.n_elems
    compute = n * ops.E_ADD * PJ
    tr = Traffic(sram_out_r=n * 32, sram_out_w=n * 16,
                 reg_r=n * 32, reg_w=n * 16)
    return OpCost(op.name, op.stage, "res", compute, traffic_energy(tr, mem),
                  _elem_latency(n, n * 48, arr))


def elem_cost(op: ElemOp, ops: OpEnergies = DEFAULT_OPS,
              mem: MemEnergies = DEFAULT_MEM,
              arr: ArrayConfig = DEFAULT_ARRAY) -> OpCost:
    fn = {"soma": soma_cost, "grad": grad_cost, "bn_fp": bn_fp_cost,
          "bn_bp": bn_bp_cost, "res": res_cost}[op.kind]
    return fn(op, ops, mem, arr)
