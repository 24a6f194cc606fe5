"""Process / memory energy constants for the E2ATST simulator.

The counterpart of ``repro.core.energy.constants``: the paper's 28 nm
constants (the model's inputs) copied as they are; the reference's TPU
roofline constants are replaced by the published peaks of the card the
port runs on, which only ``repro_torch.tune.oracle`` reads.

The paper uses a "well-validated existing process library (28nm)" plus
CACTI-derived SRAM energies (Table VI) but does not publish the raw numbers.
We derive them from Horowitz, ISSCC'14 [33] (45 nm) scaled to 28 nm
(~0.55x capacitance/energy scaling), and CACTI-7-style SRAM access energies.
The resulting end-to-end figures land inside the paper's reported envelope
(1.44 W, 2.36 TFLOPS/W, 83 % utilization at 64x64 / 500 MHz / FP16) — the
calibration is documented in EXPERIMENTS.md.

All compute energies are pJ per operation; memory energies are pJ per bit.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OpEnergies:
    """FP16 arithmetic energies at 28 nm (pJ/op)."""

    E_ADD: float = 0.22      # FP16 add      (0.4 pJ @45nm x 0.55)
    E_SUB: float = 0.22
    E_MUL: float = 0.61      # FP16 multiply (1.1 pJ @45nm x 0.55)
    E_MAC: float = 0.83      # multiply + accumulate
    E_MUX: float = 0.015     # 16-bit 2:1 mux
    E_CMP: float = 0.05      # 16-bit compare (fire threshold)
    E_DIV: float = 2.2       # iterative FP16 divide
    E_SQRT: float = 2.2      # FP16 square root


@dataclasses.dataclass(frozen=True)
class MemEnergies:
    """Per-bit access energies (pJ/bit), Table VI structure.

    DRAM: LPDDR4-class interface energy (~20 pJ/bit incl. PHY+IO).
    SRAM: CACTI-style, growing with bank size. Registers: pipeline latches.
    """

    dram_r: float = 10.0
    dram_w: float = 10.0
    sram_spike_r: float = 0.08   # 1-bit spike banks (small, wide)
    sram_spike_w: float = 0.08
    sram_act_r: float = 0.12     # FP16 activation / membrane banks
    sram_act_w: float = 0.12
    sram_w_r: float = 0.12       # FP16 weight banks
    sram_w_w: float = 0.12
    sram_out_r: float = 0.14     # FP16 output/psum banks
    sram_out_w: float = 0.14
    reg_r: float = 0.0045        # register file / latch, per bit
    reg_w: float = 0.0045


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    """The paper's accelerator configuration (§III-B, Table IX)."""

    rows: int = 64
    cols: int = 64
    freq_hz: float = 500e6
    # SRAM capacities (bytes) for the three-level hierarchy (Table VI).
    sram_in_bytes: int = 256 * 1024
    sram_w_bytes: int = 512 * 1024
    sram_out_bytes: int = 256 * 1024
    # Streaming bandwidths used by the uniform latency model [31]:
    dram_bytes_per_cycle: float = 64.0   # 256-bit LPDDR-class bus @ core clock
    sram_bytes_per_cycle: float = 256.0  # on-chip banks feed the 64-lane edges
    # eq. 26 wavefront accounting: "none" charges the full 2*D_row+D_col-2
    # fill per tile (verbatim eq. 26); "drain" overlaps result transmission
    # with the next tile's fill (D_row+D_col-2 per tile) — the deeply
    # pipelined behaviour the paper describes for its units.
    fill_overlap: str = "drain"
    # Fig. 3: MM / SOMA / BN / RES modules run as a pipeline; element-wise
    # latency hides behind the MM array when True.
    pipeline_elementwise: bool = True
    elem_lanes: int = 64

    @property
    def peak_macs_per_cycle(self) -> int:
        return self.rows * self.cols

    @property
    def peak_flops(self) -> float:
        """Peak throughput in FLOP/s (2 flops per MAC)."""
        return self.peak_macs_per_cycle * 2 * self.freq_hz


@dataclasses.dataclass(frozen=True)
class Sparsity:
    """Spike-domain sparsities (Table III). s_s is the fraction of *zero*
    spikes; typical trained Spikingformer fires at ~15-25 %."""

    s_s: float = 0.80      # spike sparsity (fraction zeros)
    s_smg: float = 0.60    # spike-gradient-mask sparsity
    s_pg: float = 0.50     # membrane-potential-gradient sparsity


# --- The card the port runs on (the oracle of repro_torch.tune, not the
# ASIC simulation): NVIDIA H100 80GB HBM3, SXM5, 700 W, published peaks. ---
H100_PEAK_FLOPS_BF16 = 989e12       # dense bf16 on the tensor cores
H100_PEAK_FLOPS_FP32 = 67e12        # fp32 outside the tensor cores
H100_HBM_BW = 3.35e12               # bytes/s of device memory
H100_L2_BYTES = 50 * 2 ** 20        # L2 cache
H100_SMS = 132                      # streaming multiprocessors
H100_SM_CLOCK_HZ = 1.98e9           # maximum SM clock
H100_SMEM_BYTES_PER_CLOCK = 128     # shared memory bandwidth of one SM
H100_SMEM_PER_BLOCK = 227 * 1024    # shared memory one block may opt in to


DEFAULT_OPS = OpEnergies()
DEFAULT_MEM = MemEnergies()
DEFAULT_ARRAY = ArrayConfig()
DEFAULT_SPARSITY = Sparsity()
