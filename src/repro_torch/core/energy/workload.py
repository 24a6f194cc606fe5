"""Training-workload extraction (E2ATST Fig. 2 / Fig. 12).

Turns a Spikingformer configuration (Table III parameters) into the explicit
list of matrix multiplications and element-wise operator counts executed in
one training step, split into the three BPTT stages FP / BP / WG.

Notation (Table III): S = BS x T x P^2 is the folded sequence length; the
Q/K/V/Z/A/B "Conv1D" layers are MMs over (S, d) operands. Attention MMs are
counted per (T x BS x head) slice of size (N, d_h) — the physically exact
count. (Table IV's ``2 S^2 d_h`` notation folds batch+time into S; we keep
the exact per-slice count and note the equivalence in EXPERIMENTS.md.)
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.energy.constants import DEFAULT_SPARSITY, Sparsity


@dataclasses.dataclass(frozen=True)
class MMOp:
    """One (B, C) x (C, K) matrix multiplication on the 64x64 array."""

    name: str
    stage: str                 # FP | BP | WG
    B: int
    C: int
    K: int
    in_bits: int = 16          # 1 for spike operands (FP & WG), 16 for BP
    w_bits: int = 16
    out_bits: int = 16
    in_sparsity: float = 0.0   # fraction of zero input elements
    count: int = 1             # independent repeats (heads x time x batch)

    @property
    def macs(self) -> int:
        return self.B * self.C * self.K * self.count

    @property
    def flops(self) -> int:
        return 2 * self.macs


@dataclasses.dataclass(frozen=True)
class ElemOp:
    """Element-wise operator block (SOMA / GRAD / BN / RES)."""

    name: str
    stage: str
    kind: str                  # soma | grad | bn_fp | bn_bp | res
    n_features: int = 0        # d-dim feature count (BN statistics lanes)
    n_samples: int = 0         # S (samples per feature)
    n_elems: int = 0           # total elements (soma/grad/res)


@dataclasses.dataclass(frozen=True)
class SpikingWorkloadConfig:
    """Paper Table III defaults."""

    num_layers: int = 8
    h: int = 8
    d_model: int = 512
    d_ff: int = 2048
    P: int = 14                # patch grid -> N = P^2 tokens
    T: int = 4
    BS: int = 16
    sparsity: Sparsity = DEFAULT_SPARSITY

    @property
    def d_h(self) -> int:
        return self.d_model // self.h

    @property
    def N(self) -> int:
        return self.P * self.P

    @property
    def S(self) -> int:
        return self.BS * self.T * self.N


def spikingformer_training_workload(cfg: SpikingWorkloadConfig
                                    ) -> tuple[list[MMOp], list[ElemOp]]:
    """One optimizer step of Spikingformer training on the E2ATST array."""
    S, d, f, h, dh, N = cfg.S, cfg.d_model, cfg.d_ff, cfg.h, cfg.d_h, cfg.N
    slices = cfg.T * cfg.BS * h           # independent attention slices
    ss = cfg.sparsity.s_s
    spg = cfg.sparsity.s_pg
    L = cfg.num_layers
    mms: list[MMOp] = []
    elems: list[ElemOp] = []

    for l in range(L):
        lay = f"L{l}"
        # ----------------------- FP (5 stages, Fig. 11a) --------------------
        for nm in ("q", "k", "v"):
            mms.append(MMOp(f"{lay}.fp.{nm}", "FP", S, d, d, in_bits=1,
                            in_sparsity=ss))
        mms.append(MMOp(f"{lay}.fp.attn_qk", "FP", N, dh, N, in_bits=1,
                        in_sparsity=ss, count=slices))
        mms.append(MMOp(f"{lay}.fp.attn_av", "FP", N, N, dh, in_bits=1,
                        in_sparsity=ss, count=slices))
        mms.append(MMOp(f"{lay}.fp.z", "FP", S, d, d, in_bits=1,
                        in_sparsity=ss))
        mms.append(MMOp(f"{lay}.fp.a", "FP", S, d, f, in_bits=1,
                        in_sparsity=ss))
        mms.append(MMOp(f"{lay}.fp.b", "FP", S, f, d, in_bits=1,
                        in_sparsity=ss))
        # SOMA sites: X' + 3 post-Q/K/V + attn-out + mlp-pre (each S*d) and
        # the hidden SN (S*f = 4 S d) == Table IV's h*(3 S d_h) + 7 S d_model.
        elems.append(ElemOp(f"{lay}.fp.soma", "FP", "soma",
                            n_elems=6 * S * d + S * f))
        # BN lanes: 3 QKV (3d) + Z (d) + A (f) + B (d) == Table IV
        # (3 h d_h + 6 d_model) with f = 4d.
        elems.append(ElemOp(f"{lay}.fp.bn", "FP", "bn_fp",
                            n_features=3 * d + 2 * d + f, n_samples=S))
        elems.append(ElemOp(f"{lay}.fp.res", "FP", "res",
                            n_elems=2 * S * d))

        # ----------------------- BP (13 stages, Fig. 12) --------------------
        # All BP MMs are FP16 x FP16 (paper §III-A).
        mms.append(MMOp(f"{lay}.bp.d_b", "BP", S, d, f, in_sparsity=spg))
        mms.append(MMOp(f"{lay}.bp.d_a", "BP", S, f, d, in_sparsity=spg))
        mms.append(MMOp(f"{lay}.bp.d_z", "BP", S, d, d, in_sparsity=spg))
        mms.append(MMOp(f"{lay}.bp.d_v", "BP", N, N, dh, count=slices,
                        in_sparsity=spg))
        mms.append(MMOp(f"{lay}.bp.d_attn", "BP", N, dh, N, count=slices,
                        in_sparsity=spg))
        mms.append(MMOp(f"{lay}.bp.d_q", "BP", N, N, dh, count=slices,
                        in_sparsity=spg))
        mms.append(MMOp(f"{lay}.bp.d_k", "BP", N, N, dh, count=slices,
                        in_sparsity=spg))
        for nm in ("q", "k", "v"):
            mms.append(MMOp(f"{lay}.bp.d_{nm}in", "BP", S, d, d,
                            in_sparsity=spg))
        elems.append(ElemOp(f"{lay}.bp.grad", "BP", "grad",
                            n_elems=6 * S * d + S * f))
        elems.append(ElemOp(f"{lay}.bp.bn", "BP", "bn_bp",
                            n_features=3 * d + 2 * d + f, n_samples=S))
        elems.append(ElemOp(f"{lay}.bp.res", "BP", "res",
                            n_elems=2 * S * d))

        # ----------------------- WG (4 stages, Fig. 11c) --------------------
        # W_grad = spike_acts^T @ upstream_grad: spike operand -> add-based.
        mms.append(MMOp(f"{lay}.wg.w_b", "WG", f, S, d, in_bits=1,
                        in_sparsity=ss))
        mms.append(MMOp(f"{lay}.wg.w_a", "WG", d, S, f, in_bits=1,
                        in_sparsity=ss))
        mms.append(MMOp(f"{lay}.wg.w_z", "WG", d, S, d, in_bits=1,
                        in_sparsity=ss))
        for nm in ("q", "k", "v"):
            mms.append(MMOp(f"{lay}.wg.w_{nm}", "WG", d, S, d, in_bits=1,
                            in_sparsity=ss))
    return mms, elems


def generic_mm_workload(name: str, layer_mms: list[tuple[str, int, int, int]],
                        num_layers: int, stage: str = "FP") -> list[MMOp]:
    """T2 applicability: build an MM workload for ANY architecture from a
    per-layer (name, B, C, K) list — used to run the E2ATST dataflow/energy
    study over the assigned (non-spiking) architectures."""
    out = []
    for l in range(num_layers):
        for nm, b, c, k in layer_mms:
            out.append(MMOp(f"L{l}.{nm}", stage, b, c, k))
    return out
