#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--depth 8] [--verbose-build]

Builds the CUDA kernels from the sources in this checkout and runs the
analysis phase (``repro_torch.analysis``'s contracts, with every launch of
every declared case read from the plan exports and held to the card's
limits, and its plan audit; then each kernel contract at each site geometry
at batch 1 against the oracles of ``kernels/ref.py``). Holds each kernel
against its plain PyTorch version on the card at the shapes the
``spikingformer-8-512`` forward and training step give it, then drives the
port's two main paths: it serves a few request batches through
``SpikingFormer.forward`` under the ``cuda-full`` policy, and it takes a few
BPTT + AdamW steps through ``repro_torch.train.loop.make_train_step``, each
compared with the same weights under the ``eager`` policy on the same card;
one block's forward and backward are compared on the same input. Training
runs at the preset's full depth; ``--depth`` cuts only the blocks served.
Then it drives the spiking LM, ``qwen3-0.6b`` at its published widths and
depth in fp32 with the LIF neuron on every FFN branch: ``lm_forward`` on
a (1, 256) and an (8, 256) token batch and 16 requests through
``ServingEngine(slots=8, max_seq=256)``, under ``cuda-full`` and ``eager``
on the same weights; forwards, every serving step's logits and spikes, and
the token streams must be equal bit for bit, and request 0 served again
alone must give the same tokens and logits (slot isolation). The serving
times come from runs that keep no host copy of the steps. Last, it trains
the same spiking LM (fp32, published widths and depth, each layer
recomputed in the backward): step 0's loss and every gradient leaf under
``cuda-full`` and ``eager`` from the same weights, then one warm-up and
three timed steps of 8 x 128 ``SyntheticLM`` tokens under each policy
through the training driver's ``repro_torch.launch.train.train``, with the
``lif_soma_fwd`` / ``lif_soma_bwd`` launches per step asserted (56 / 28:
the forward's 28, the recompute's 28 and the backward's 28). Then it
serves ``deepseek-v2-236b`` (MLA, 160 routed experts top-6 at the
published capacity factor 1.25, 2 shared experts) + LIF at its published
widths, cut to 2 of its 60 layers, fp32, weights drawn on the card: the
same forwards and 16 requests as ``qwen3-0.6b``'s, bit-equal between
``cuda-full`` and ``eager`` and between two runs of a policy, 2 launches a
forward and a decode step; slot isolation (the slots share each expert's
capacity at decode), decode against the forward and the pairs each MoE
layer drops are measured and printed, not held. Then it serves the
recurrent families at their published widths and depths, fp32, weights
drawn on the card: ``rwkv6-7b`` + LIF (32 layers, d 4096, the LIF on
every channel-mix branch) and ``zamba2-2.7b`` + LIF (54 Mamba2 layers, d
2560, the LIF on every Mamba2 branch, the weight-shared attention block
after every 6 without one), the same forwards and 16 requests, bit-equal
between ``cuda-full`` and ``eager`` and between two runs of a policy,
exact slot isolation, 32 and 54 launches a forward and a decode step;
decode against the forward, and for ``zamba2-2.7b`` the masked SSD
entries whose ``exp`` overflows in the (8, 256) forward (ROADMAP C6), are
measured and printed, not held. Then it serves and trains the
encoder-decoder, ``whisper-large-v3`` at its published size (32 + 32
layers, d 1280, 1,500 frames, fp32, nothing cut): the encoder pass and the
cross memory of 8 requests, a 4-token prompt and 60 greedy decode steps
against the teacher-forced forward, then 1 + 2 training steps through the
driver, first at the reference's init (the attention logits have a std of
about 64 at this width, ROADMAP C7: measured, not held), then with every
attention's query and key projections scaled by 1/4, decode held at the
reference's 2e-2 and training from those weights as a checkpoint the
driver resumes from; no kernel launches on any path (the family never
reads ``cfg.lif``). Then it trains the other
spiking LM families at published widths, fp32, each layer recomputed:
``mixtral-8x7b`` + LIF (2 of 32 layers), ``rwkv6-7b`` + LIF (13 of 32)
and ``zamba2-2.7b`` + LIF (54): step 0's loss bit-equal between
``cuda-full`` and ``eager`` and every gradient leaf within 1e-5 (the MoE's
run-to-run gradient difference measured, not held), then 1 + 2 steps
through the driver under ``cuda-full`` with the LIF launches per step
asserted; ``zamba2-2.7b`` first at its published SSD chunk of 128, where
the gradient is not finite (ROADMAP C6) and the guard skips every step
with every leaf bit-unchanged, then at a chunk of 16, where it trains (at
64 and 32 the SSD's masked ``exp`` still overflows in some layers; the
overflows at each chunk are counted). Then the chaos phase
(``repro_torch.chaos``): the reference's recovery drill (a NaN gradient
at step 3, a kernel fault at the first ``pssa.qkv`` dispatch, SIGTERM at
step 5, the step-6 checkpoint corrupted on write) at
``spikingformer-8-512``, batch 16, ``cuda-full``, 8 steps, through
``python -m repro_torch.chaos.runner`` in two child processes, each held
to the reference's assertions and the two to equal events and bit-equal
loss histories; one training step with ``pssa.qkv`` demoted by the
circuit breaker, bit-equal to the step with ``pssa.qkv: eager``, its
launches as the plan gives them, and no trip left after it; and
``qwen3-0.6b`` + LIF serving the 16 requests with a slot fault: request 0
quarantined, the others' tokens those of the ``lm`` phase, every slot
free. Then it trains data parallel on a
mesh (``mesh_train``): a world of 1 on this card (``init_distributed``:
NCCL, a file store, no network), a (1, 1) mesh. The BN kernels' split
path (the rank's column sums, their all-reduce over the data group, the
statistics from the global sums) runs ``bn_fwd`` and ``bn_bwd`` at the
blocks' (12,544, 512) and (12,544, 2,048) and the tokenizer stages' shapes
and ``neuron_layer_train`` at every site of batch 16: it must give the
fused path's outputs and statistics bit for bit, its replay the emitted
spikes, and the rows cut in two halves, their sums added as two ranks'
all-reduce adds them, mu and var within 1e-6 of the whole's (the spike
mismatch measured); both paths' times. Then ``train_vision`` at
``spikingformer-8-512``, batch 16, ``cuda-full``, full depth, 1 + 2 steps
on the mesh and without it from the same seed: every loss and every
parameter, BN-state and moment leaf (read back from each run's
checkpoint, the mesh run's restored by the mesh-less path) bit-equal;
launches and wall time per step. Then ``qwen3-0.6b`` + LIF at its
published size through the driver on the mesh with int8 gradient
compression: every step finite, every leaf moved, the residual non-zero,
56 / 28 LIF launches a step; then the same LM through the driver on the
mesh without compression, against the mesh-less driver from the same
seed: every loss and every parameter leaf bit-equal (the mesh's model
axis of 1 takes the tensor-parallel code path, whose region ops launch
nothing there). Then ``mesh_moe``: ``mixtral-8x7b`` + LIF (the
``moe_train`` cut, 2 layers) through ``launch.train.train`` on the
(1, 1) mesh, whose MoE takes the expert-parallel code path with a model
group of none, and 8 decode steps there, against the same without a
mesh from the same seed: every loss, parameter leaf and logit
bit-equal, the LIF launches per step. Then ``mesh_families``: the rest of
the model axis on the (1, 1) mesh against the mesh-less paths at
published widths, cut in depth: ``deepseek-v2-236b`` + LIF (MLA, 2
layers) a prefill of 8 x 64 tokens and 8 decode steps, and
``rwkv6-7b`` + LIF (4 layers), ``zamba2-2.7b`` + LIF (one group of 6,
SSD chunk 16) and whisper (4 + 4 layers) one train step and 8 decode
steps each: logits, metrics and every parameter leaf bit-equal, the LIF
launches of each path held. Each family has one code path for every mesh,
so at a model axis of 1 its split arithmetic runs with its region ops as
identities; the collectives of a larger axis run on cards only in
``benchmarks/torch/bench_data_parallel.py`` on four. Then the tensor-parallel kernel cases (``tp``): every
kernel of the training path at one rank's site shapes of
``spikingformer-8-512``, batch 16, on model axes of 2, 4 and 8 (the
column-parallel neuron layers ``pssa.qkv`` and ``smlp.a`` at K / M output
columns, train and eval arms; the row-parallel spike products
``pssa.proj`` and ``smlp.b`` at C / M input features; ``attn_qk`` on h / M
heads, the ``attn_av``-style product at N = 64 likewise; the LIF of the
attention output on D / M columns, forward and backward), each held
against its plain version as the ``kernels`` cases are, with its cold and
warm device time, bound and plain time, and each of the contracts of
those sites (``analysis.contracts.config_cases`` at the rank's shapes)
held against its oracle in ``kernels/ref.py``. Then it runs the
autotuner at
``spikingformer-8-512``, batch 16, ``cuda-full``, full width and depth:
sparsity measured on the card, the nine tunable sites,
each candidate (a spike-matmul tile, or a neuron layer's fused or pipeline
arm) timed with the L2 cold, the winners written as a table keyed by the
card and consulted by a forward and a training step, each compared with
the same call without a table (exact weights: the forward bit-equal), and
the paper's energy model (its 28 nm ASIC, not this card) at the default
and the measured sparsity. Every other phase runs with no table. Last,
the dry run (``repro_torch.launch.dryrun``): a child process counts the
``train`` and ``lm_train`` phases' steps on ``meta`` tensors at a world of
1, as they ran, and each estimate is held against the same step measured
here (one step after a warm-up): the peak within 15 % of
``max_memory_allocated`` above what was allocated before its inputs, the
roofline's largest term no more than the step's device busy ms, the useful
flops ratio at most 1.05, the kernel sites the launches; then
``qwen3-0.6b`` x ``decode_32k`` on ``data16`` through the module's
command line, its terms, peak and ``fits`` printed. bf16 (the reference's
kernels take it, its LMs default to it): right after the fp32 kernel cases,
each kernel's bf16 arm at the paths' shapes against its bf16 oracle
(``bf16_kernel_phase``; its rows join the ``kernels`` line with
``"dtype": "bfloat16"``); after the family training phases,
``spikingformer-8-512`` at bf16 under ``cuda-full`` (``bf16_vision``:
REQUESTS x 16 bf16 images served (every packed eval call, 35 a
forward, on the wgmma eval kernel; the per-head ``attn_qk``, 8 a forward
and a step, on the heads kernel), a gradient step and 2 training steps,
the launches those of fp32, every kernel call of one forward and of the
gradient step judged against its oracle on its own operands) and
``qwen3-0.6b`` + LIF at its published bf16 (``lm_bf16``: the 16 requests
with a bf16 cache, bit-equal between ``cuda-full`` and ``eager``; step 0's
forward and loss bit-equal and each gradient leaf within 2e-2 of its
scale; 1 + 3 driver steps). Then the vlm family (``vlm``): ``pixtral-12b``
+ LIF at its published bf16, widths and depth (40 layers, d 5120, 32 / 8
heads of 160, d_ff 14336, vocabulary 131072; 12.1 B parameters drawn on
the card): a (1, 256) forward with image patches merged and the 16
requests through ``ServingEngine(slots=16, max_seq=256)`` with a bf16
cache, bit-equal between ``cuda-full`` and ``eager`` (tokens, every
step's logits and branch spikes); then its training in fp32 at the deepest
depth whose world-1 dry-run estimate is within 64 GB (a child process
counts it): step 0 on a batch with patches against ``eager``, 1 + 2
driver steps from the reference's init (measured) and with every wq and
wk times 1/8 (held: every leaf moved), and the driver's step measured
alone against the estimate (the peak within 15 %). Then
the examples (``examples``): the four ``examples/torch/*.py`` in child
processes at their defaults, each to exit 0 with a finite loss. It
needs one CUDA device and ``nvcc`` and fails (non-zero exit, no result
line) without them. Every phase prints one JSON line; the line before the
last but one lists the kernels, and the last line is the verdict.

``ms`` times are CUDA-event times after a warm-up, inputs left warm in the
L2 cache as the model leaves them. ``bound_ms`` is the least time the card
could take: the larger of the bytes the function must move (inputs once,
outputs once) over 3.35 TB/s and the fp32 operations these inputs need over
67 TFLOP/s (the published H100 SXM rates; spikes are data, so the spike
products count one addition per set bit and output column). The spike
matmul cases run with the wrapper's tile rule and with each tile forced
(``tile``; the first case of a site carries ``tiles_bitwise_equal``),
and every kernel case carries its device time, ten calls back to back
behind a held stream (``queued_ms``), with the L2 cold (``device_ms``:
each call on the next of copies of its operands that span four L2s with
their outputs, ``l2_cold``, so its bytes come from and go to device
memory, as the byte bound counts them) and warm (``device_ms_l2_warm``:
the same operands every call). The spike
matmul cases also carry ``tc_bound_ms``, the ceiling of their tensor-core
design: the same bytes, or three dense bf16 passes (3 * 2MCK operations,
one per plane of the exact weight split) over 989 TFLOP/s. They carry as
well ``err_vs_fp64``, the errors of the kernel and of ``torch.matmul``
against an fp64 product, and, at the main path's sites,
``bitwise_21bit``, a check on 21-bit integer weights that must hold. The
packed ``neuron_layer_train`` cases run the same tensor-core product: they
carry ``tc_bound_ms`` computed the same way and ``bitwise_ternary``, a check
on weights in {-1, 0, 1} that must give the plain version's spikes, mu and
var bit for bit. So do the packed ``neuron_layer_eval`` cases, once per time
step: they carry ``tc_bound_ms``, ``z_pass_ms`` (the train arm's first pass
on the same operands) and ``bitwise_spike_matmul``, their spikes against
the spike matmul plus bias through the plain SOMA, which must hold bit for
bit. Every ``neuron_layer_train`` case, and the training phase at each
neuron-layer site of a real step, also hold the spikes that the autograd
op's backward replays to those the forward emitted, bit for bit. The dense
arms' cases (``tokenizer.conv.0``) carry the device time of each pass
(``passes``) and ``err_vs_fp64`` of the z that the train arm's first pass
writes; the eval case also ``bitwise_z_pass``, its spikes against the plain
SOMA on that z plus the bias, which must hold bit for bit. ``bn_bwd`` runs
at each distinct shape of a training step, with ``passes``,
``bitwise_dyadic`` (inputs whose column sums are exact: dx, dgamma and
dbeta equal to the plain version's bit for bit) and, as ``library_ms``,
ATen's batch-norm backward alone; its first case carries ``edges``, the
layouts where the kernel changes arm. ``lif_soma_fwd`` also runs at the
LM's shapes in the layouts the model hands it (decode (1, 8, 1024) from a
carried state, whose final state must match too; forward (256, 1 or 8,
1024) as the (S, B, D) view of a (B, S, D) tensor; the same three at
``deepseek-v2-236b``'s d = 5120, ``rwkv6-7b``'s 4096 and
``zamba2-2.7b``'s 2560), each case with
``bitwise`` and its launches per decode step or forward, as counted on
that path in this run; it and ``lif_soma_bwd`` run at the LM's training
shapes (128, 8, d) at d = 1024, 4096 (``mixtral-8x7b``, ``rwkv6-7b``)
and 2560, in that view, too, with their launches per training step;
``pixtral-12b``'s bf16 decode (1, 16, 5120) from the carry, bf16 forward
(256, 1, 5120) view and fp32 training (128, 8, 5120), with theirs.
Every LIF case names its ``arm`` (``flat`` or ``ring``) and bounds its
time by the recursion as well: ``bound_ms`` is the larger of the byte
time and T steps of the serial chain (the dependent fp32 instructions a
step of the built ring kernel's SASS holds, ``cuobjdump -sass``, at 4
cycles each and the card's maximum SM clock), ``bound_by`` ``"bytes"`` or
``"chain"``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.configs import get_spikingformer_config  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.lif import LIFConfig, _lif_scan_eager  # noqa: E402
from repro_torch.chaos import FaultSchedule, FaultSpec, chaos  # noqa: E402
from repro_torch.core.policy import (breaker_trips,  # noqa: E402
                                     named_policy, reset_breaker)
from repro_torch.core.spiking_layers import block_apply  # noqa: E402
from repro_torch.core.spikingformer import (SpikingFormer,  # noqa: E402
                                            _index_tree, init_spikingformer,
                                            spikingformer_apply,
                                            spikingformer_grad_step,
                                            tree_leaves, tree_map,
                                            tree_paths, tree_unflatten,
                                            value_and_grad)
from repro_torch.kernels import (COUNTED, KERNELS, build,  # noqa: E402
                                 conv_spike, fused_bn, launch_counts, lif_soma,
                                 neuron_layer, ops, reset_launch_counts,
                                 set_launch_counts, spike_matmul)
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.models.attention import attention  # noqa: E402
from repro_torch.models.common import (embed, layer, rmsnorm,  # noqa: E402
                                       split_tree, unembed)
from repro_torch.models.encdec import (decode_train,  # noqa: E402
                                       encdec_decode_step, encode,
                                       init_encdec_cache)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.train import (build_state, train,  # noqa: E402
                                     train_vision)
from repro_torch.models.lm import (_dense_block,  # noqa: E402
                                   _hybrid_group_shape, _seq_lif,
                                   _shared_cfg, init_lm, lm_forward,
                                   lm_loss)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import rwkv as rwkv_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.mla import mla_attention  # noqa: E402
from repro_torch.models.mlp import swiglu  # noqa: E402
from repro_torch.models.moe import moe_apply  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.train.data import (DataConfig, SyntheticLM,  # noqa: E402
                                    SyntheticVision, VisionDataConfig)
from repro_torch.train.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.train.loop import make_train_step  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         init_opt_state)
from repro_torch.tune.autotune import (L2_BYTES, l2_cold,  # noqa: E402,F401
                                       queued_ms)

# the H100 SXM's published rates, from the dry run's constants
HBM_BYTES_PER_S = dryrun.HBM_BW           # HBM3, bytes/s
FP32_FLOPS = dryrun.PEAK_FLOPS_FP32       # fp32 outside the tensor cores
BF16_FLOPS = dryrun.PEAK_FLOPS            # dense bf16 on the tensor cores
PRESET = "spikingformer-8-512"
REQUESTS, BATCH = 3, 16         # request batches served, images in each
TRAIN_STEPS = 3                 # training steps counted, after one warm-up
DEVICE = torch.device("cuda")


#: The host clock at import: each phase line carries the seconds since
#: (``elapsed_s``), so a run shows where its time limit goes.
_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - _T0}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def time_ms(fn, min_ms: float = 30.0, max_iters: int = 50) -> float:
    """CUDA-event time of one call of ``fn``, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = start.elapsed_time(end)
    iters = int(max(1, min(max_iters, min_ms / max(once, 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def spikes(gen, shape, rate=0.2):
    return (torch.rand(shape, generator=gen, device=DEVICE) < rate).float()


def dyadic(gen, shape, scale=64, span=16):
    """Multiples of 1/scale in [-span/scale, span/scale): every fp32 partial
    sum of such weights under {0,1} inputs is exact in any order."""
    return torch.randint(-span, span, shape, generator=gen,
                         device=DEVICE).float() / scale


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version at the preset's shapes
# ---------------------------------------------------------------------------

#: Cycles from one dependent fp32 instruction to the next on sm_90 (the FMA
#: pipe's fixed latency: FADD, FMUL, FSET, FSEL), the least a link of the
#: LIF recursions' serial chain can take.
DEP_CYCLES = 4
#: Stores a step of each LIF kernel's walk makes (S, U, mask; dx).
LIF_STORES = {"lif_soma_fwd": 3, "lif_soma_bwd": 1}
_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)\s*(.*?)\s*;")
_SASS_REG = re.compile(r"^[-!|]*(R\d+|P\d)(?:\.\w+)*\|?$")
_SASS_FLOAT = {"FADD", "FMUL", "FFMA", "FSET", "FSETP", "FSEL", "FMNMX"}


def sass_functions(text: str) -> dict[str, list[tuple[int, str, list[str]]]]:
    """``cuobjdump -sass`` text -> function name -> its instructions as
    (address, opcode, operands)."""
    out: dict[str, list] = {}
    name = None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = []
        elif name is not None and (m := _SASS_INSTR.search(line)):
            ops = [o.strip() for o in m.group(3).split(",")] \
                if m.group(3) else []
            out[name].append((int(m.group(1), 16), m.group(2), ops))
    return out


def _sass_regs(operands: list[str]) -> list[str]:
    return [m.group(1) for o in operands if (m := _SASS_REG.match(o))]


def sass_chain(instrs, stores_per_step: int) -> dict[str, int]:
    """The serial chain of a recursion's unrolled walk in one kernel's SASS:
    split the code into basic blocks (at branch targets and after
    branches), take the block with the most global stores (the unrolled
    chunk: ``steps`` = its stores over ``stores_per_step``), and in it the
    longest path of dependent fp32 instructions through registers and
    predicates (``chain``). ``per_step`` = chain / steps, rounded."""
    targets = set()
    for _, op, ops in instrs:
        if op.startswith("BRA") and (m := re.search(r"0x([0-9a-f]+)",
                                                    " ".join(ops))):
            targets.add(int(m.group(1), 16))
    blocks, cur = [], []
    for addr, op, ops in instrs:
        if addr in targets and cur:
            blocks.append(cur)
            cur = []
        cur.append((op, ops))
        if op.startswith(("BRA", "EXIT", "RET")):
            blocks.append(cur)
            cur = []
    blocks.append(cur)
    stores, chain = 0, 0
    for block in blocks:
        depth: dict[str, int] = {}
        n_st = deepest = 0
        for op, ops in block:
            base = op.split(".")[0]
            ndst = 2 if base.endswith("SETP") else \
                0 if base.startswith(("ST", "LDGSTS", "BAR", "DEPBAR")) else 1
            d = 0
            if base in _SASS_FLOAT:
                d = 1 + max([depth.get(r, 0)
                             for r in _sass_regs(ops[ndst:])] or [0])
                deepest = max(deepest, d)
            for r in _sass_regs(ops[:ndst]):
                depth[r] = d
            n_st += base == "STG"
        if n_st > stores:
            stores, chain = n_st, deepest
    steps = stores // stores_per_step
    return {"steps": steps, "chain": chain,
            "per_step": round(chain / steps) if steps else 0}


@functools.lru_cache(maxsize=None)
def lif_chain() -> dict:
    """Dependent fp32 instructions a step of each LIF kernel's ring walk
    (the fewest over its built fp32 instantiations: ``sass_chain`` on
    ``cuobjdump -sass`` of the built library), and the card's maximum SM
    clock (``nvidia-smi``). The bf16 instantiations do the same fp32
    operations and a rounding after each, which ``sass_chain`` does not
    follow: their walks' chains are at least the fp32 ones, which bound
    them too."""
    nvcc = Path(build.find_nvcc())
    lib = build.build()
    text = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass", str(lib)],
                          check=True, capture_output=True, text=True).stdout
    per_step = {}
    for name, instrs in sass_functions(text).items():
        for kernel, ring in (("lif_soma_fwd", "lif_fwd_ring"),
                             ("lif_soma_bwd", "lif_bwd_ring")):
            if ring in name and "bfloat16" not in name:
                got = sass_chain(instrs, LIF_STORES[kernel])["per_step"]
                per_step[kernel] = min(per_step.get(kernel, got), got)
    if set(per_step) != set(LIF_STORES) or not all(per_step.values()):
        fail(f"no ring walk found in the SASS of {lib.name}: {per_step}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True,
                         capture_output=True, text=True).stdout
    return {"per_step": per_step, "dep_cycles": DEP_CYCLES,
            "sm_clock_hz": float(smi.split()[0]) * 1e6}


def lif_bound(kernel: str, t: int, bytes_moved: float,
              flops: float) -> dict:
    """``bound_ms``: the larger of the bytes over 3.35 TB/s, the
    operations over 67 TFLOP/s and the serial chain (T steps of
    ``per_step`` dependent instructions of ``DEP_CYCLES`` each at the
    maximum SM clock); ``bound_by`` names it."""
    b_ms, b_by = bound(bytes_moved, flops)
    c = lif_chain()
    chain_ms = t * c["per_step"][kernel] * DEP_CYCLES / c["sm_clock_hz"] * 1e3
    return {"bound_ms": max(b_ms, chain_ms),
            "bound_by": b_by if b_ms >= chain_ms else "chain",
            "byte_bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "chain_bound_ms": chain_ms,
            "chain_per_step": c["per_step"][kernel]}


def lif_input(gen, t, m, d, layout):
    """(T, M, D) input currents: contiguous, or (``"lm"``) the spiking
    LM's (S, B, D) view of a contiguous (B, S, D) branch output."""
    if layout == "lm":
        return (torch.randn((m, t, d), generator=gen, device=DEVICE) * 1.2
                + 0.3).transpose(0, 1)
    return torch.randn((t, m, d), generator=gen, device=DEVICE) * 1.2 + 0.3


def cold_warm(call, operands: tuple, moved: int) -> dict:
    """Device ms per call of ``call(*operands)``, ten calls back to back
    behind a held stream (``queued_ms``): with the L2 cold (``l2_cold``) and
    warm (the same operands every call)."""
    return {"device_ms": queued_ms(l2_cold(call, operands, moved), 10,
                                   DEVICE),
            "device_ms_l2_warm": queued_ms(lambda: call(*operands), 10,
                                           DEVICE)}


def check_lif(gen, t, m, d, case="pssa.lif/smlp.lif", layout="dense",
              carry=False):
    """S, U and mask (with ``carry``, from a random (u0, s0), also u_last
    and s_last) bit-equal to the plain version, in the input's layout."""
    x = lif_input(gen, t, m, d, layout)
    state = (torch.randn((m, d), generator=gen, device=DEVICE) * 0.7 + 0.5,
             spikes(gen, (m, d), 0.4)) if carry else ()
    got = lif_soma.lif_soma_fwd(x, *state)
    want = lif_soma.lif_soma_fwd_plain(x, *state)
    torch.cuda.synchronize()
    bad = [n for n, a, b in zip(("S", "U", "mask", "u_last", "s_last"), got,
                                want) if not torch.equal(a, b)]
    if bad or len(got) != len(want):
        fail(f"lif_soma_fwd ({case}) differs from its plain version in {bad}")
    if any(a.stride() != x.stride() for a in got[:3]):
        fail(f"lif_soma_fwd ({case}) did not keep the input's layout")
    moved = nbytes(x, *state) + nbytes(*got)
    return {"case": case, "shape": [t, m, d], "layout": layout,
            "strides": list(x.stride()), "carry": carry,
            "arm": lif_soma.choose_arm(t, m * d, x.is_contiguous(), carry),
            "max_abs_err": float((got[1] - want[1]).abs().max()),
            "spike_mismatch": 0, "compared": x.numel(),
            "tolerance": "bitwise on S, U and mask"
                         + (", u_last and s_last" if carry else ""),
            "ms": time_ms(lambda: lif_soma.lif_soma_fwd(x, *state)),
            **cold_warm(lif_soma.lif_soma_fwd, (x, *state), moved),
            "plain_ms": time_ms(lambda: lif_soma.lif_soma_fwd_plain(
                x, *state)),
            "library_ms": None,
            **lif_bound("lif_soma_fwd", t, moved, 6.0 * x.numel())}


def int21(gen, shape):
    """Integers of up to 21 significant bits: a bf16 holds 8 of them, so
    every one of the three planes of the kernel's weight split carries
    bits."""
    return torch.randint(-2 ** 20, 2 ** 20, shape, generator=gen,
                         device=DEVICE).float()


def at_most_12(s):
    """{0,1} ``s`` with every row cut to its first 12 set bits: a sum of
    at most 12 products of 21-bit integers stays below 2^24, exact in fp32
    in any order."""
    return s * (s.cumsum(-1) <= 12)


def check_matmul(case, packed, w, fn, shared_w=False, exact=None, tile=0):
    """``fn(packed, w)`` against fp32 ``torch.matmul`` on the unpacked
    operand (rtol 1e-5, atol 1e-4: the same exact products, summed in
    another order and rounded otherwise). Both are also compared with an
    fp64 product (RMS and largest error), which tells the kernel's
    rounding apart from the library's. ``exact``, where given, is another
    ``(packed, w)`` of the same layout with ``int21`` weights on
    ``at_most_12`` rows: every partial sum is exact, so the kernel must
    equal ``torch.matmul`` bit for bit. ``tile`` is forced on the kernel
    (0: ``default_tile``). ``device_ms`` / ``device_ms_l2_warm``: the
    kernel's device time with the L2 cold and warm (``cold_warm``)."""
    fn = functools.partial(fn, tile=tile)
    got = fn(packed, w)
    dense = spike_matmul.spike_unpack(packed, torch.float32)
    want = torch.matmul(dense, w)
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"{case}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = (got - want).abs()
    if not bool((err <= 1e-4 + 1e-5 * want.abs()).all()):
        fail(f"{case}: max abs err {float(err.max())} beyond rtol 1e-5 / "
             f"atol 1e-4 of torch.matmul")
    fp64 = torch.matmul(dense.double(), w.double())
    vs_fp64 = {}
    for name, out in (("kernel", got), ("library", want)):
        e = out.double() - fp64
        vs_fp64[f"{name}_rms"] = float(e.square().mean().sqrt())
        vs_fp64[f"{name}_max"] = float(e.abs().max())
    del fp64
    exact_equal = None
    if exact is not None:
        xp, xw = exact
        xgot = fn(xp, xw)
        xwant = torch.matmul(spike_matmul.spike_unpack(xp, torch.float32), xw)
        torch.cuda.synchronize()
        exact_equal = torch.equal(xgot, xwant)
        if not exact_equal:
            fail(f"{case}: 21-bit integer weights on rows of <= 12 spikes "
                 f"differ from torch.matmul by "
                 f"{float((xgot - xwant).abs().max())} (must be bitwise)")
    k = w.shape[-1]
    w_bytes = nbytes(w) // (w.shape[0] if shared_w else 1)
    moved = nbytes(packed, got) + w_bytes
    b_ms, b_by = bound(moved, float(dense.sum()) * k)
    c = w.shape[-2]
    rows = packed.shape[-2]
    return {"case": case, "shape": {"packed": list(packed.shape),
                                    "w": list(w.shape),
                                    "w_stride": list(w.stride())},
            "tile": tile, "tile_ran": spike_matmul.TILES[
                tile or spike_matmul.default_tile(rows)].name,
            "max_abs_err": float(err.max()),
            "tolerance": "rtol 1e-5, atol 1e-4 vs fp32 torch.matmul"
                         + ("; bitwise on 21-bit integer weights, <= 12 "
                            "spikes a row" if exact is not None else ""),
            "bitwise_21bit": exact_equal, "err_vs_fp64": vs_fp64,
            "ms": time_ms(lambda: fn(packed, w)),
            **cold_warm(fn, (packed, w), moved),
            "plain_ms": time_ms(
                lambda: spike_matmul.spike_matmul_packed_plain(packed, w)),
            "library_ms": time_ms(lambda: torch.matmul(dense, w)),
            "bound_ms": b_ms, "bound_by": b_by,
            "tc_bound_ms": max(moved / HBM_BYTES_PER_S,
                               6.0 * got.numel() * c / BF16_FLOPS) * 1e3,
            "dense_fp32_bound_ms":
                2.0 * got.numel() * c / FP32_FLOPS * 1e3}


def check_neuron_layer(gen, case, t, m, c, k, packed):
    """Gaussian weights: spike mismatch <= 1e-4 of the elements (a membrane
    within rounding of the threshold may fire differently under another
    order of summation). Dyadic weights: every partial sum is exact, so the
    spikes must agree bit for bit. The packed arm's spikes must also equal,
    bit for bit on the Gaussian weights, those of the spike matmul on the
    same packed operands plus the bias through the plain SOMA
    (``bitwise_spike_matmul``: the same MMAs in the same order); its case
    carries ``tc_bound_ms`` and ``z_pass_ms``, the train arm's first pass
    on the same operands, the yardstick of its design."""
    if packed:
        x = spikes(gen, (t, m, c))
    else:   # float image patches; dyadic values keep the exact case exact
        x = dyadic(gen, (t, m, c), scale=16, span=32)
    out = {"case": case, "shape": [t, m, c, k], "arm": "packed" if packed
           else "dense", "compared": t * m * k}
    for kind in ("dyadic", "gaussian"):
        if kind == "dyadic":
            w, bias = dyadic(gen, (c, k)), dyadic(gen, (k,))
        else:
            w = torch.randn((c, k), generator=gen, device=DEVICE) * c ** -0.5
            bias = torch.randn((k,), generator=gen, device=DEVICE) * 0.1
        if packed:   # rate 0.2 of c inputs: bring the sums near threshold
            w = w * (2.0 if kind == "gaussian" else 1.0)
        got = neuron_layer.neuron_layer_eval(x, w, bias, packed=packed)
        want = neuron_layer.neuron_layer_eval_plain(x, w, bias)
        torch.cuda.synchronize()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"neuron_layer_eval {case}: bad output")
        n_bad = int((got != want).sum())
        out[f"{kind}_mismatch"] = n_bad
        out[f"{kind}_rate"] = float(want.mean())
        limit = 0 if kind == "dyadic" else 1e-4 * want.numel()
        if n_bad > limit:
            fail(f"neuron_layer_eval {case} ({kind} weights): {n_bad} of "
                 f"{want.numel()} spikes differ (limit {limit})")
        if kind == "dyadic":
            out["max_abs_err"] = float((got - want).abs().max())
    del want
    exact = dense = None
    if not packed:   # on the Gaussian weights: the train arm's first pass
        # and the eval arm's product are one product, the same bits
        z = neuron_layer.neuron_layer_train_z(x, w)
        dense = {"bitwise_z_pass": torch.equal(
            got, lif_soma.lif_soma_fwd_plain(z + bias)[0])}
        if not dense["bitwise_z_pass"]:
            fail(f"neuron_layer_eval {case}: spikes differ from the plain "
                 f"SOMA on the train arm's first pass plus the bias (must be "
                 f"bitwise)")
        del z
        dense["err_vs_fp64"] = z_err_vs_fp64(x, w)
        dense["passes"] = pass_ms(lambda: neuron_layer.neuron_layer_eval(
            x, w, bias))
    if packed:   # on the Gaussian weights
        xp = spike_matmul.spike_pack(x)
        mm = spike_matmul.spike_matmul_packed(xp.reshape(t * m, c // 8), w)
        ref = lif_soma.lif_soma_fwd_plain(mm.reshape(t, m, k) + bias)[0]
        torch.cuda.synchronize()
        exact = torch.equal(got, ref)
        if not exact:
            fail(f"neuron_layer_eval {case}: {int((got != ref).sum())} spikes "
                 f"differ from spike matmul + bias + plain SOMA (must be "
                 f"bitwise)")
        del mm, ref
    # timed on the Gaussian weights (the last ones)
    ops_ = (float(x.sum()) * k if packed else 2.0 * t * m * c * k) \
        + 8.0 * t * m * k
    moved = nbytes(x, w, bias, got)
    b_ms, b_by = bound(moved, ops_)
    out.update({
        "tolerance": "spikes: 0 differ on dyadic weights, <= 1e-4 of the "
                     "elements on Gaussian weights"
                     + ("; bitwise on Gaussian weights against spike matmul "
                        "+ bias + plain SOMA" if packed else ""),
        "bitwise_spike_matmul": exact, **(dense or {}),
        "ms": time_ms(lambda: neuron_layer.neuron_layer_eval(
            x, w, bias, packed=packed)),
        **cold_warm(functools.partial(neuron_layer.neuron_layer_eval,
                                      packed=packed), (x, w, bias), moved),
        "plain_ms": time_ms(lambda: neuron_layer.neuron_layer_eval_plain(
            x, w, bias)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        # the packed arm's tensor-core design: three dense bf16 passes
        "tc_bound_ms": max(moved / HBM_BYTES_PER_S,
                           6.0 * t * m * c * k / BF16_FLOPS) * 1e3
        if packed else None,
        "dense_fp32_bound_ms": 2.0 * t * m * c * k / FP32_FLOPS * 1e3})
    if packed:   # the pack alone: the spike_pack cases of this line
        out["z_pass_ms"] = time_ms(lambda: neuron_layer.neuron_layer_train_z(
            x, w, packed=True, xin=xp))
    return out


def z_err_vs_fp64(x, w) -> dict[str, float]:
    """RMS and largest error against an fp64 product of the z that the
    train arm's first pass writes and of fp32 ``torch.matmul``'s."""
    z64 = torch.matmul(x.double(), w.double())
    out = {}
    for name, z in (("kernel", neuron_layer.neuron_layer_train_z(x, w)),
                    ("library", torch.matmul(x, w))):
        e = z.double() - z64
        out[f"{name}_rms"] = float(e.square().mean().sqrt())
        out[f"{name}_max"] = float(e.abs().max())
    return out


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|: the error of a statistics vector
    relative to its scale (a column mean near 0 has no relative error of
    its own)."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def check_lif_bwd(gen, t, m, d, case="pssa.lif/smlp.lif", carry=True,
                  layout="dense"):
    """Bitwise: the kernel and the plain version round every operation of
    eq. 12 once, in the same order; dx in the operands' layout. With
    ``carry``, also the variant seeded by the carry's cotangent
    (``time_chunk``)."""
    x = lif_input(gen, t, m, d, layout)
    s, u, mask = lif_soma.lif_soma_fwd_plain(x)
    g = torch.empty_like(u).copy_(torch.randn((t, m, d), generator=gen,
                                              device=DEVICE))
    gu = torch.randn((m, d), generator=gen, device=DEVICE)
    rows = []
    cases = [(case, None)] + ([("time_chunk carry (gu_last)", gu)]
                              if carry else [])
    for name, gu_last in cases:
        got = lif_soma.lif_soma_bwd(g, u, s, mask, gu_last)
        want = lif_soma.lif_soma_bwd_plain(g, u, s, mask, gu_last)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"lif_soma_bwd ({name}) differs from its plain version")
        if got.stride() != g.stride():
            fail(f"lif_soma_bwd ({name}) did not keep the operands' layout")
        ins = (g, u, s, mask) + ((gu_last,) if gu_last is not None else ())
        rows.append({
            "case": name, "shape": [t, m, d], "layout": layout,
            "strides": list(g.stride()),
            "arm": lif_soma.choose_arm(t, m * d, g.is_contiguous()),
            "max_abs_err": 0.0, "tolerance": "bitwise",
            "ms": time_ms(lambda: lif_soma.lif_soma_bwd(g, u, s, mask,
                                                        gu_last)),
            **cold_warm(lif_soma.lif_soma_bwd, (g, u, s, mask, gu_last),
                        nbytes(*ins, got)),
            "plain_ms": time_ms(lambda: lif_soma.lif_soma_bwd_plain(
                g, u, s, mask, gu_last)),
            "library_ms": None,
            **lif_bound("lif_soma_bwd", t, nbytes(*ins, got),
                        7.0 * x.numel())})
    return rows


#: Idle host time a profiling session leaves before its first call and
#: after its last. The profiler places the card's kernel records on the
#: host's clock with an error of up to about a millisecond, and drops a
#: record that lands outside the session (seen on the H100: the first
#: kernel of a session lost, its neighbours stamped before their launches).
PROFILE_MARGIN_S = 0.02


def pass_ms(fn, iters: int = 10) -> dict[str, float]:
    """Device ms per call of every kernel one call of ``fn`` launches, from
    ``torch.profiler`` over ``iters`` calls after a warm-up. A session can
    still come back without some kernels' records, so a session counts
    only when every kernel in it launched a multiple of ``iters`` times,
    and the result is that of the first such session whose kernels and
    launch counts another such session gave too (four sessions at most);
    {} when no two agree."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen: list[dict[str, int]] = []
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.device_time_total > 0]
        if not rows or any(e.count % iters for e in rows):
            continue
        counts = {e.key[:90]: e.count for e in rows}
        if counts in seen:
            return {e.key[:90]: e.device_time_total / 1e3 / iters
                    for e in rows}
        seen.append(counts)
    return {}


def check_bn_fwd(gen, m, d):
    """bn_fwd at (T*B*N, d): y within rtol 1e-5 / atol 1e-5 of the plain
    version, mu and var within 1e-6 of their scale: the column sums run
    over 12,544 rows in another order (per-chunk partials added in double
    against a library reduction)."""
    x = torch.randn((m, d), generator=gen, device=DEVICE) * 2.0 + 0.5
    gamma = torch.rand((d,), generator=gen, device=DEVICE) + 0.5
    beta = torch.randn((d,), generator=gen, device=DEVICE) * 0.3
    y, mu, sd = fused_bn.bn_fwd(x, gamma, beta)
    wy, wmu, wsd = fused_bn.bn_fwd_plain(x, gamma, beta)
    torch.cuda.synchronize()
    var, wvar = sd * sd - 1e-5, wsd * wsd - 1e-5
    stats = {"mu": rel_err(mu, wmu), "var": rel_err(var, wvar)}
    if not torch.allclose(y, wy, rtol=1e-5, atol=1e-5):
        fail(f"bn y beyond rtol/atol 1e-5 of its plain version: "
             f"{float((y - wy).abs().max())}")
    if stats["mu"] > 1e-6 or stats["var"] > 1e-6:
        fail(f"bn_fwd statistics beyond 1e-6 of their scale: {stats}")
    b_ms, b_by = bound(nbytes(x, gamma, beta, y, mu, sd), 8.0 * x.numel())
    return {"case": "pssa.proj/smlp.b", "shape": [m, d],
            "max_abs_err": float((y - wy).abs().max()), "rel_err": stats,
            "tolerance": "y within rtol 1e-5 / atol 1e-5, mu and var within "
                         "1e-6 of their scale: column sums in another order",
            "ms": time_ms(lambda: fused_bn.bn_fwd(x, gamma, beta)),
            **cold_warm(fused_bn.bn_fwd, (x, gamma, beta),
                        nbytes(x, gamma, beta, y, mu, sd)),
            "plain_ms": time_ms(lambda: fused_bn.bn_fwd_plain(x, gamma, beta)),
            "library_ms": time_ms(lambda: F.batch_norm(
                x, None, None, gamma, beta, training=True, eps=1e-5)),
            "bound_ms": b_ms, "bound_by": b_by}


def dyadic_bn_bwd(gen, m, d):
    """(g, x, gamma, mu, sqrt_d) whose every column sum is exact in fp32 in
    any order (m < 2^22): g and x - mu in {-1, 0, 1}, mu a multiple of 1/8,
    gamma in {0.5, 1}, sqrt_d in {1, 2}; mi and mi * n are then multiples
    of 1/4 of magnitude <= 1."""
    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             device=DEVICE).float()
    mu = ints(-8, 8, (1, d)) / 8
    return (ints(-1, 2, (m, d)), mu + ints(-1, 2, (m, d)),
            ints(1, 3, (d,)) / 2, mu, ints(1, 3, (1, d)))


def check_bn_bwd(gen, m, d):
    """bn_bwd at one (rows, D) of a step. Gaussian inputs: dx within rtol
    1e-5 / atol 1e-5 of the plain version, dgamma and dbeta within 1e-5 of
    their scale (column sums in another order). ``bitwise_dyadic``: on
    inputs whose every column sum is exact, dx, dgamma and dbeta equal the
    plain version's bit for bit (fails a per-column term of eq. 23 rounded
    otherwise than the plain version rounds it). ``library_ms``: ATen's
    batch-norm backward alone, one call, no autograd."""
    x = torch.randn((m, d), generator=gen, device=DEVICE) * 2.0 + 0.5
    gamma = torch.rand((d,), generator=gen, device=DEVICE) + 0.5
    g = torch.randn((m, d), generator=gen, device=DEVICE)
    _, mu, sd = fused_bn.bn_fwd_plain(x, gamma, gamma)
    got = fused_bn.bn_bwd(g, x, gamma, mu, sd)
    want = fused_bn.bn_bwd_plain(g, x, gamma, mu, sd)
    torch.cuda.synchronize()
    errs = {"dgamma": rel_err(got[1], want[1]),
            "dbeta": rel_err(got[2], want[2])}
    if not torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-5):
        fail(f"bn_bwd {m}x{d}: dx beyond rtol/atol 1e-5 of its plain "
             f"version: {float((got[0] - want[0]).abs().max())}")
    if max(errs.values()) > 1e-5:
        fail(f"bn_bwd {m}x{d}: parameter gradients beyond 1e-5 of their "
             f"scale: {errs}")
    exact = dyadic_bn_bwd(gen, m, d)
    dyadic = all(torch.equal(a, b) for a, b in zip(
        fused_bn.bn_bwd(*exact), fused_bn.bn_bwd_plain(*exact)))
    if not dyadic:
        fail(f"bn_bwd {m}x{d}: differs from its plain version on dyadic "
             f"inputs (must be bitwise)")
    del exact

    def library():
        return torch.ops.aten.native_batch_norm_backward(
            g, x, gamma, None, None, mu.reshape(-1), inv, True, 1e-5,
            [True, True, True])

    inv = (1.0 / sd).reshape(-1)
    lib = library()
    lib_err = max(rel_err(lib[0], want[0]),
                  rel_err(lib[1].reshape(1, -1), want[1]),
                  rel_err(lib[2].reshape(1, -1), want[2]))
    if lib_err > 1e-4:
        fail(f"bn_bwd {m}x{d}: the ATen yardstick computes another "
             f"function ({lib_err})")
    b_ms, b_by = bound(nbytes(g, x, gamma, mu, sd, *got), 12.0 * x.numel())

    def call():
        return fused_bn.bn_bwd(g, x, gamma, mu, sd)

    return {"case": f"{m}x{d}", "shape": [m, d],
            "max_abs_err": float((got[0] - want[0]).abs().max()),
            "rel_err": errs, "bitwise_dyadic": dyadic,
            "library_rel_err": lib_err,
            "tolerance": "dx within rtol 1e-5 / atol 1e-5, dgamma and "
                         "dbeta within 1e-5 of their scale (column sums in "
                         "another order); bitwise on dyadic inputs",
            "ms": time_ms(call),
            **cold_warm(fused_bn.bn_bwd, (g, x, gamma, mu, sd),
                        nbytes(g, x, gamma, mu, sd, *got)),
            "plain_ms": time_ms(lambda: fused_bn.bn_bwd_plain(
                g, x, gamma, mu, sd)),
            "library_ms": time_ms(library),
            "bound_ms": b_ms, "bound_by": b_by, "passes": pass_ms(call)}


def bn_bwd_edges(gen) -> dict:
    """bn_bwd where its layout changes: D % 4 != 0, g and x off 16-byte
    alignment (both the scalar dx arm), 2,098,120 rows (more row ranges
    than grid.y takes), gamma with zeros (nan in dgamma where the plain
    version has it), and calls at two widths on one stream (the arrival
    counters back at 0: every call gives the bits it gives alone). Each
    holds on dyadic inputs bit for bit; fails otherwise."""
    out = {}

    def same(args):
        return all(torch.equal(a, b) for a, b in zip(
            fused_bn.bn_bwd(*args), fused_bn.bn_bwd_plain(*args)))

    out["d130"] = same(dyadic_bn_bwd(gen, 12544, 130))
    g, x, gamma, mu, sd = dyadic_bn_bwd(gen, 300, 24)
    gm, xm = (torch.cat([torch.zeros(1, device=DEVICE), a.reshape(-1)])[1:]
              .view(300, 24) for a in (g, x))
    out["misaligned"] = same((gm, xm, gamma, mu, sd))
    out["rows_2098120"] = all(same(dyadic_bn_bwd(gen, 65535 * 32 + 1000, d))
                              for d in (4, 3))
    g, x, gamma, mu, sd = dyadic_bn_bwd(gen, 1000, 64)
    gamma[::5] = 0.0
    dgamma, wdgamma = (f(g, x, gamma, mu, sd)[1] for f in (
        fused_bn.bn_bwd, fused_bn.bn_bwd_plain))
    out["gamma_zero_nan"] = torch.equal(torch.isnan(dgamma),
                                        torch.isnan(wdgamma)) and \
        bool(torch.isnan(dgamma[0, ::5]).all())
    wide, narrow = dyadic_bn_bwd(gen, 300, 2048), dyadic_bn_bwd(gen, 5000, 64)
    first = [fused_bn.bn_bwd(*a) for a in (wide, narrow)]
    again = [fused_bn.bn_bwd(*a) for a in (narrow, wide)][::-1]
    out["two_widths_one_stream"] = all(
        torch.equal(a, b) for f, s in zip(first, again) for a, b in zip(f, s))
    torch.cuda.synchronize()
    bad = [k for k, v in out.items() if not v]
    if bad:
        fail(f"bn_bwd edge cases failed: {bad}")
    return out


def bn_bwd_shapes(batch: int) -> list[tuple[int, int]]:
    """The distinct (rows, D) of bn_bwd in a training step, the block
    sites' first: every neuron-layer site's (T*M, K), and pssa.proj /
    smlp.b at (T*B*N, d)."""
    shapes = [(t * m, k) for _, t, m, _, k, _ in neuron_layer_sites(batch)]
    cfg = get_spikingformer_config(PRESET)
    first = (cfg.time_steps * batch * cfg.num_tokens, cfg.d_model)
    return [first] + sorted(set(shapes) - {first}, key=lambda s: -s[1])


def neuron_layer_sites(batch: int) -> list[tuple]:
    """``(case, T, M, C, K, packed)`` of every neuron-layer site of the
    preset: the four tokenizer stages (im2col'd, the first one dense), then
    the block sites."""
    cfg = get_spikingformer_config(PRESET)
    t, d, f = cfg.time_steps, cfg.d_model, cfg.d_ff
    m = batch * cfg.num_tokens
    sites, size = [], cfg.image_size
    for i, (c_in, c_out) in enumerate(cfg.tokenizer_stage_channels()):
        size //= 2
        sites.append((f"tokenizer.conv.{i}", t, batch * size * size,
                      9 * c_in, c_out, i > 0))
    return sites + [("pssa.qkv", t, m, d, d, True),
                    ("smlp.a", t, m, d, f, True)]


def neuron_layer_train_inputs(gen, t, m, c, k, packed):
    """``(x, w, gamma, beta)`` of one train-mode site: spikes at rate 0.2
    (packed) or uniform pixels, Gaussian weights scaled to bring the sums
    near the threshold."""
    if packed:
        x = spikes(gen, (t, m, c))
    else:
        x = torch.rand((t, m, c), generator=gen, device=DEVICE)
    w = torch.randn((c, k), generator=gen, device=DEVICE) * (
        2.0 if packed else 1.0) * c ** -0.5
    gamma = torch.rand((k,), generator=gen, device=DEVICE) * 0.4 + 0.8
    beta = torch.randn((k,), generator=gen, device=DEVICE) * 0.2 + 0.3
    return x, w, gamma, beta


def ternary_case(gen, x, w, gamma, beta):
    """The exact check of the packed arm: weights in {-1, 0, 1} on rows of
    at most 12 spikes (about 8), so every z is an integer in [-12, 12].
    Over T*M <= 2^18 rows every partial sum of z stays below 12 * 2^18 and
    every partial sum of z^2 (about 5 a row here) below 2^24: both are
    exact in fp32 in any order, and so are mu and var. Spikes, mu and var
    must then equal the plain version's bit for bit. Returns the names of
    what differs (empty when all agree)."""
    t, m, c = x.shape
    xt = at_most_12(spikes(gen, (t, m, c), rate=8 / c))
    wt = torch.randint(-1, 2, w.shape, generator=gen, device=DEVICE).float()
    got = neuron_layer.neuron_layer_train(xt, wt, gamma, beta, packed=True)
    want = neuron_layer.neuron_layer_train_plain(xt, wt, gamma, beta)
    torch.cuda.synchronize()
    return [n for n, a, b in zip(("spikes", "mu", "var"), got, want)
            if not torch.equal(a, b)]


def replay_mismatch(x, w, gamma, beta, packed, emitted=None) -> int:
    """C1's check: the spikes the train op's backward replays (z by the
    forward kernel's first pass on the packed input, BN with the forward's
    own statistics in its order, the SOMA kernel) against those the forward
    emitted; the number that differ, which must be 0. ``emitted`` is the
    forward's ``neuron_layer_train_fwd`` result where the caller has it."""
    s, mu, _, sqrt_d, xin = emitted or neuron_layer.neuron_layer_train_fwd(
        x, w, gamma, beta, packed=packed)
    _, y = ops.replay_train_pre_activation(x, xin, w, gamma, beta, mu, sqrt_d,
                                           packed)
    replayed = lif_soma.lif_soma_fwd(y)[0]
    torch.cuda.synchronize()
    return int((replayed != s).sum())


def check_neuron_layer_train(gen, case, t, m, c, k, packed):
    """Gaussian weights and batch statistics over T*M rows: spikes within
    1e-4 of the elements of the plain version's (a membrane within rounding
    of the threshold may fire differently under another order of
    summation), mu and var within 1e-5 of their scale. The packed arm also
    runs ``ternary_case``, which must hold bit for bit."""
    x, w, gamma, beta = neuron_layer_train_inputs(gen, t, m, c, k, packed)
    got = neuron_layer.neuron_layer_train(x, w, gamma, beta, packed=packed)
    want = neuron_layer.neuron_layer_train_plain(x, w, gamma, beta)
    torch.cuda.synchronize()
    n_bad = int((got[0] != want[0]).sum())
    errs = {"mu": rel_err(got[1], want[1]), "var": rel_err(got[2], want[2])}
    if n_bad > 1e-4 * want[0].numel() or max(errs.values()) > 1e-5:
        fail(f"neuron_layer_train {case}: {n_bad} of {want[0].numel()} "
             f"spikes differ, statistics {errs}")
    replay_bad = replay_mismatch(x, w, gamma, beta, packed)
    if replay_bad:
        fail(f"neuron_layer_train {case}: the backward's replay gives "
             f"{replay_bad} spikes other than the forward emitted (must be "
             f"bitwise)")
    exact = None
    if packed:
        differ = ternary_case(gen, x, w, gamma, beta)
        exact = not differ
        if differ:
            fail(f"neuron_layer_train {case}: ternary weights on rows of "
                 f"<= 12 spikes give other {differ} than the plain version "
                 f"(must be bitwise)")
    dense = {}
    if not packed:
        dense = {"err_vs_fp64": z_err_vs_fp64(x, w),
                 "passes": pass_ms(lambda: neuron_layer.neuron_layer_train(
                     x, w, gamma, beta))}
    ops_ = (float(x.sum()) * k if packed else 2.0 * t * m * c * k) \
        + 12.0 * t * m * k
    moved = nbytes(x, w, gamma, beta, *got)
    b_ms, b_by = bound(moved, ops_)
    out = {"case": case, "shape": [t, m, c, k],
           "arm": "packed" if packed else "dense",
           "spike_mismatch": n_bad, "compared": want[0].numel(),
           "spike_rate": float(want[0].mean()), "rel_err": errs,
           "max_abs_err": max(errs.values()),
           "tolerance": "spikes: <= 1e-4 of the elements differ; mu, var "
                        "within 1e-5 of their scale (sums over T*M rows in "
                        "another order); the backward's replay gives the "
                        "emitted spikes bit for bit"
                        + ("; bitwise on ternary weights, <= 12 spikes a row"
                           if packed else ""),
           "bitwise_ternary": exact, "replay_mismatch": replay_bad, **dense,
           "ms": time_ms(lambda: neuron_layer.neuron_layer_train(
               x, w, gamma, beta, packed=packed)),
           **cold_warm(functools.partial(neuron_layer.neuron_layer_train,
                                         packed=packed), (x, w, gamma, beta),
                       moved),
           "plain_ms": time_ms(lambda: neuron_layer.neuron_layer_train_plain(
               x, w, gamma, beta)),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           # the packed arm's tensor-core design: three dense bf16 passes
           "tc_bound_ms": max(moved / HBM_BYTES_PER_S,
                              6.0 * t * m * c * k / BF16_FLOPS) * 1e3
           if packed else None,
           "dense_fp32_bound_ms": 2.0 * t * m * c * k / FP32_FLOPS * 1e3}
    return out


def eval_kernel_cases(gen, batch: int) -> list[dict]:
    """The cases of ``neuron_layer_eval`` at the preset's shapes, the block
    sites first (they carry 32 of its 36 launches a forward)."""
    rows = []
    for site in neuron_layer_sites(batch):
        rows.append(check_neuron_layer(gen, *site))
        torch.cuda.empty_cache()
    return rows[-2:] + rows[:-2]


def train_kernel_cases(gen, batch: int) -> dict[str, list[dict]]:
    """The cases of ``bn_fwd``, ``bn_bwd`` and ``neuron_layer_train`` at the
    preset's shapes: ``bn_bwd`` at each distinct shape of a step, with its
    edge cases on the first; the block sites of the neuron layer first
    (they carry 32 of its 36 launches a step)."""
    cfg = get_spikingformer_config(PRESET)
    bn_f = check_bn_fwd(gen, cfg.time_steps * batch * cfg.num_tokens,
                        cfg.d_model)
    bn_b = []
    for m, d in bn_bwd_shapes(batch):
        bn_b.append(check_bn_bwd(gen, m, d))
        torch.cuda.empty_cache()
    bn_b[0]["edges"] = bn_bwd_edges(gen)
    rows = []
    for site in neuron_layer_sites(batch):
        rows.append(check_neuron_layer_train(gen, *site))
        torch.cuda.empty_cache()
    rows = rows[-2:] + rows[:-2]
    return {"bn_fwd": [bn_f], "bn_bwd": bn_b, "neuron_layer_train": rows}


def spike_matmul_cases(gen, batch: int) -> tuple[list[dict], list[dict]]:
    """The cases of ``spike_matmul_packed`` and of
    ``spike_matmul_packed_batched`` at the preset's shapes, each operand
    laid out as the model lays it out; the main path's sites also run the
    bitwise check on 21-bit integer weights."""
    cfg = get_spikingformer_config(PRESET)
    t, d, f, h = cfg.time_steps, cfg.d_model, cfg.d_ff, cfg.n_heads
    n, dh = cfg.num_tokens, cfg.d_model // cfg.n_heads
    m = batch * n
    mm, bmm = (spike_matmul.spike_matmul_packed,
               spike_matmul.spike_matmul_packed_batched)
    rows_2d = []
    for site, c in (("pssa.proj", d), ("smlp.b", f)):
        packed = spike_matmul.spike_pack(spikes(gen, (t * m, c)))
        w = torch.randn((c, d), generator=gen, device=DEVICE) * c ** -0.5
        exact = (spike_matmul.spike_pack(at_most_12(
            spikes(gen, (t * m, c), rate=8 / c))), int21(gen, (c, d)))
        rows_2d += tile_cases(site, packed, w, mm, exact=exact)

    # attn_qk: per-head views of (T*B, N, h*dh) spikes; K^T is a strided view
    def heads(a):
        return a.view(t * batch, n, h, dh).permute(0, 2, 1, 3)

    q, k = (spikes(gen, (t * batch, n, d)) for _ in range(2))
    exact = (spike_matmul.spike_pack(at_most_12(heads(spikes(
        gen, (t * batch, n, d), rate=8 / dh)))),
        heads(int21(gen, (t * batch, n, d))).transpose(-1, -2))
    rows_b = tile_cases("attn_qk", spike_matmul.spike_pack(heads(q)),
                        heads(k).transpose(-1, -2), bmm, exact=exact)
    # attn_av-style at N = 64: packed V^T (dh, M) x attn^T (M, N), both views
    n64 = 64
    v = spikes(gen, (t * batch, h, n64, dh))
    attn = torch.randint(0, dh, (t * batch, h, n64, n64), generator=gen,
                         device=DEVICE).float()
    rows_b.append(check_matmul(
        "attn_av(N=64)", spike_matmul.spike_pack(v.transpose(-1, -2)),
        attn.transpose(-1, -2), bmm))
    # one weight shared by all T batches: zero batch stride, never copied
    c3 = 9 * (d // 2)
    patches = spike_matmul.spike_pack(spikes(gen, (t, m, c3)))
    w3 = torch.randn((c3, d), generator=gen, device=DEVICE) * c3 ** -0.5
    w3e = w3.unsqueeze(0).expand(t, c3, d)
    if w3e.stride(0) != 0:
        fail("expanded weight does not have a zero batch stride")
    rows_b += tile_cases("tokenizer.conv.3(shared w)", patches, w3e, bmm,
                         shared_w=True)
    return rows_2d, rows_b


def tile_cases(site, packed, w, fn, **kw) -> list[dict]:
    """``check_matmul`` with the wrapper's tile rule, then with each tile
    forced (the tuner's candidates), each exact on 21-bit weights where
    ``exact`` is given. The first case carries ``tiles_bitwise_equal``:
    whether the tiles give the same bits on these Gaussian weights (both
    walk the contraction in the same order), reported, not held."""
    rows = [check_matmul(site, packed, w, fn, **kw)]
    outs = [fn(packed, w, tile=tile) for tile in spike_matmul.TILES]
    rows[0]["tiles_bitwise_equal"] = all(torch.equal(outs[0], o)
                                         for o in outs[1:])
    del outs
    for tile, info in spike_matmul.TILES.items():
        rows.append(check_matmul(f"{site}[{info.name}]", packed, w, fn,
                                 tile=tile, **kw))
    return rows


# ---------------------------------------------------------------------------
# The spike pack: the entry point every packed arm runs before its kernel
# ---------------------------------------------------------------------------

#: The ``kernels`` line's entry of the pack (``kernels.COUNTED``): an entry
#: point of the spike matmul's row (``KERNELS``), its own launch count.
PACK_ENTRY = "spike_pack"
PACK_SOURCE = "src/repro_torch/kernels/csrc/spike_pack.cu"
#: Where the reference packs (a ``jnp`` sum, inside the functions that
#: reach ``pallas_call``).
PACK_REFERENCE = "src/repro/kernels/spike_matmul.py:24"


def pack_per_pass(depth: int, stages: int) -> int:
    """``spike_pack`` launches of one forward, eval or train, under
    ``cuda-full``: one for every packed call, the neuron layers at every
    tokenizer stage but the dense first and at the four block sites (the
    backward's replay reads the packed input its forward kept), the spike
    matmuls at pssa.proj and smlp.b, and attn_qk's q."""
    return (stages - 1 + 4 * depth) + 2 * depth + depth


def heads_view(x: torch.Tensor, h: int) -> torch.Tensor:
    """``attn_qk``'s spike operand: ``_fold_tb(_split_heads(x, h))`` of a
    (T, B, N, D) tensor, the (T*B, h, N, D/h) view the model hands the
    pack (``core/spiking_layers.py``)."""
    t, b, n, d = x.shape
    return x.reshape(t, b, n, h, d // h).permute(0, 1, 3, 2, 4).reshape(
        t * b, h, n, d // h)


def pack_inputs(gen, batch: int, dtype) -> list[tuple[str, torch.Tensor]]:
    """The spikes of the seven kinds of packed call of the preset's forward
    at ``batch``, rate 0.2, each laid out as the model hands it to
    ``spike_pack``: the block sites' (T, M, 512) (pssa.qkv, smlp.a),
    pssa.proj's and smlp.b's (T*M, C) rows, attn_qk's q view, and the
    im2col patches (T, M, 9 C_in) of the three packed tokenizer stages."""
    cfg = get_spikingformer_config(PRESET)
    t, d, f, h, n = (cfg.time_steps, cfg.d_model, cfg.d_ff, cfg.n_heads,
                     cfg.num_tokens)
    m = batch * n
    out = [("pssa.qkv/smlp.a", spikes(gen, (t, m, d))),
           ("pssa.proj", spikes(gen, (t * m, d))),
           ("smlp.b", spikes(gen, (t * m, f))),
           ("attn_qk", heads_view(spikes(gen, (t, batch, n, d)), h))]
    out += [(case, spikes(gen, (tt, mm, c)))
            for case, tt, mm, c, _, packed in neuron_layer_sites(batch)
            if packed and case.startswith("tokenizer")]
    return [(case, x.to(dtype)) for case, x in out]


def pack_edge_inputs(gen, dtype) -> list[tuple[str, torch.Tensor]]:
    """Layouts off the main path: a packed row of an odd number of bytes
    (C = 520 gives 65), a C stride of 2, a row start off 16 bytes, a
    transposed operand (the last three on the scalar path)."""
    def s(*shape):
        return spikes(gen, shape).to(dtype)

    return [("ragged C=520", s(4, 3136, 520)),
            ("C stride 2", s(4, 3136, 1024)[..., ::2]),
            ("unaligned start", s(3136 * 512 + 1)[1:].view(3136, 512)),
            ("transposed", s(512, 3136).t())]


def pack_row(case: str, x: torch.Tensor, main: bool = True) -> dict:
    """One pack case: the kernel bit for bit against ``spike_pack_plain``
    (the fp32 matrix-vector pass the port packed with before, on the same
    operand) and the oracle, the path the wrapper names; then the
    wrapper's ms, its device ms with the L2 cold and warm, the plain
    pass's, both host costs (``host_us``) and the byte bound (the spikes
    read once in their dtype, one byte written per eight, at 3.35 TB/s).
    Off the main path (``main`` False) the checks and the kernel's device
    ms alone."""
    pack, plain = spike_matmul.spike_pack, spike_matmul.spike_pack_plain
    got, want, oracle = pack(x), plain(x), kref.spike_pack_ref(x)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(got, oracle)
            and got.is_contiguous()):
        fail(f"spike_pack {case} {x.dtype}: {int((got != want).sum())} "
             f"bytes differ from the plain pack, "
             f"{int((got != oracle).sum())} from the oracle")
    moved = nbytes(x, got)
    b_ms = moved / HBM_BYTES_PER_S * 1e3
    row = {"case": case, "dtype": str(x.dtype).removeprefix("torch."),
           "shape": list(x.shape), "stride": list(x.stride()),
           "path": {spike_matmul.PACK_VECTOR: "vector",
                    spike_matmul.PACK_SCALAR: "scalar"}[
                        spike_matmul.pack_path(x)],
           "bitwise_plain": True, "bitwise_oracle": True, "max_abs_err": 0.0,
           "tolerance": "bitwise against spike_pack_plain and "
                        "kernels/ref.py",
           **cold_warm(pack, (x,), moved), "bound_ms": b_ms,
           "bound_by": "bytes", "library_ms": None}
    if main:
        plain_dev = cold_warm(plain, (x,), moved)
        row.update(
            ms=time_ms(lambda: pack(x)), plain_ms=time_ms(lambda: plain(x)),
            plain_device_ms=plain_dev["device_ms"],
            plain_device_ms_l2_warm=plain_dev["device_ms_l2_warm"],
            host_us=host_us(lambda: pack(x)),
            plain_host_us=host_us(lambda: plain(x)))
    del got, want, oracle
    return row


def pack_consumers(gen, dtype) -> dict:
    """The packed calls at pssa.qkv's shapes (and attn_qk's) fed by the
    kernel's pack and by the plain pack on the same spikes: the eval
    kernel's spikes, the z pass's z and the spike matmuls' outputs must be
    the same bits."""
    cfg = get_spikingformer_config(PRESET)
    t, d, h, n = cfg.time_steps, cfg.d_model, cfg.n_heads, cfg.num_tokens
    m = BATCH * n
    x = spikes(gen, (t, m, d)).to(dtype)
    w = (torch.randn((d, d), generator=gen, device=DEVICE) * 2.0
         * d ** -0.5).to(dtype)
    bias = torch.randn((d,), generator=gen, device=DEVICE) * 0.1
    plain = spike_matmul.spike_pack_plain(x)
    with torch.cuda.device(DEVICE):
        eval_plain = neuron_layer._launch_neuron_layer_eval(
            plain, w, bias, t, m, d, d, True, 0.5, 1.0,
            torch.cuda.current_stream().cuda_stream,
            neuron_layer.eval_kernel(m, w))
    q = heads_view(spikes(gen, (t, BATCH, n, d)).to(dtype), h)
    kt = heads_view(torch.randn((t, BATCH, n, d), generator=gen,
                                device=DEVICE).to(dtype), h).transpose(-1, -2)
    x2 = x.reshape(t * m, d)
    pairs = {
        "eval_spikes": (neuron_layer.neuron_layer_eval(x, w, bias,
                                                       packed=True),
                        eval_plain),
        "z_pass": (neuron_layer.neuron_layer_train_z(x, w, packed=True),
                   neuron_layer.neuron_layer_train_z(x, w, packed=True,
                                                     xin=plain)),
        "spike_matmul": (spike_matmul.spike_matmul(x2, w),
                         spike_matmul.spike_matmul_packed(
                             plain.reshape(t * m, d // 8), w)),
        "attn_qk": (spike_matmul.spike_matmul_batched(q, kt),
                    spike_matmul.spike_matmul_packed_batched(
                        spike_matmul.spike_pack_plain(q), kt))}
    torch.cuda.synchronize()
    out = {name: {"equal": torch.equal(a, b), "digest": digest(a),
                  "plain_digest": digest(b)} for name, (a, b) in pairs.items()}
    if not all(v["equal"] for v in out.values()):
        fail(f"packed calls {str(dtype)}: the kernel's pack and the plain "
             f"pack give other outputs: {out}")
    return out


def pack_cases(gen, batch: int, dtype) -> list[dict]:
    """The pack's cases at one dtype: the seven main-path shapes, the edge
    layouts, and the consumers fed both ways (on the first row)."""
    rows = [pack_row(case, x) for case, x in pack_inputs(gen, batch, dtype)]
    rows += [pack_row(case, x, main=False)
             for case, x in pack_edge_inputs(gen, dtype)]
    rows[0]["consumers"] = pack_consumers(gen, dtype)
    torch.cuda.empty_cache()
    return rows


def pack_summary(cases: dict[str, list[dict]],
                 paths: dict[str, dict[str, int]]) -> dict:
    """The pack's entry of the ``kernels`` line: the numbers of its first
    case (fp32, the block sites' (T, M, 512)), its launches on the paths
    that count them, and every case's times beside its bound and the plain
    pass's."""
    rows = cases[PACK_ENTRY]
    first = rows[0]
    keep = ("case", "dtype", "shape", "path", "ms", "device_ms",
            "device_ms_l2_warm", "plain_ms", "plain_device_ms",
            "plain_device_ms_l2_warm", "host_us", "plain_host_us",
            "bound_ms", "bitwise_plain", "bitwise_oracle")
    return {
        "name": PACK_ENTRY, "route": "cuda", "source": PACK_SOURCE,
        "replaces": KERNELS["spike_matmul_packed"]["replaces"],
        "packs_as": PACK_REFERENCE, "entry_of": "spike_matmul_packed",
        "launches": sum(c[PACK_ENTRY] for c in paths.values()),
        "launches_by_path": {p: c[PACK_ENTRY] for p, c in paths.items()},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": None, "case": first["case"],
        "device_ms": first["device_ms"],
        "device_ms_l2_warm": first["device_ms_l2_warm"],
        "consumers": {r["dtype"]: r["consumers"] for r in rows
                      if "consumers" in r},
        "cases": [{k: r[k] for k in keep if k in r} for r in rows]}


def kernel_phase(seed: int, batch: int) -> dict[str, list[dict]]:
    cfg = get_spikingformer_config(PRESET)
    t, d = cfg.time_steps, cfg.d_model
    m = batch * cfg.num_tokens
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    cases: dict[str, list[dict]] = {name: [] for name in KERNELS}

    cases[PACK_ENTRY] = pack_cases(gen, batch, torch.float32)
    cases["lif_soma_fwd"].append(check_lif(gen, t, m, d))
    (cases["spike_matmul_packed"],
     cases["spike_matmul_packed_batched"]) = spike_matmul_cases(gen, batch)
    cases["neuron_layer_eval"] = eval_kernel_cases(gen, batch)

    # the training kernels
    cases["lif_soma_bwd"].extend(check_lif_bwd(gen, t, m, d))
    cases.update(train_kernel_cases(gen, batch))
    for arch in PHASE_NAMES:                         # the spiking LMs'
        for name, rows in lm_lif_cases(gen, arch).items():
            cases[name].extend(rows)
    for arch in TRAIN_PHASES:
        for name, rows in train_lif_cases(gen, arch).items():
            cases[name].extend(rows)
    return cases


# ---------------------------------------------------------------------------
# Phase 4: the model
# ---------------------------------------------------------------------------

def _zip_bn(params, state, fn):
    """Call ``fn(bn_params, bn_state)`` for every BN of the two trees."""
    if isinstance(state, dict):
        if "mean" in state:
            fn(params, state)
        else:
            for k in state:
                _zip_bn(params[k], state[k], fn)
    elif isinstance(state, list):
        for p, st in zip(params, state):
            _zip_bn(p, st, fn)


def _map_weights(tree, fn):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "w":
                tree[k] = fn(v)
            else:
                _map_weights(v, fn)
    elif isinstance(tree, list):
        for v in tree:
            _map_weights(v, fn)


def _exact_var(sqrt_d: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 ``var`` with ``var + eps == sqrt_d ** 2`` exactly, so that
    ``sqrt(var + eps)`` gives back the power of two ``sqrt_d``."""
    target = sqrt_d * sqrt_d
    var = target - eps
    for steps in (1, -1, 2, -2, 3, -3):
        miss = (var + eps) != target
        if not bool(miss.any()):
            break
        cand = target - eps
        toward = torch.full_like(cand, float("inf") if steps > 0
                                 else float("-inf"))
        for _ in range(abs(steps)):
            cand = torch.nextafter(cand, toward)
        var = torch.where(miss & ((cand + eps) == target), cand, var)
    if bool(((var + eps) != target).any()) or \
            bool((torch.sqrt(var + eps) != sqrt_d).any()):
        fail("could not build BN statistics with an exact square root")
    return var


def make_model(seed: int, depth: int, batch: int, weights: str):
    """A ``SpikingFormer`` at the preset's widths under the ``eager``
    policy, everything from ``seed``.

    BN gamma/beta are perturbed and the running statistics are set from the
    batch statistics of one calibration batch (one train-mode pass of the
    eager policy), so that every BN is non-trivial and the network keeps
    spiking through its depth.

    ``weights="gaussian"``: the package's own initialisation.
    ``weights="dyadic"``: weights, gamma, beta, BN means and pixels are
    small multiples of powers of two and every BN's ``sqrt(var + eps)`` is
    rounded to a power of two. Then every sum and every BN, folded or not, is exact in
    fp32 whatever the order of the additions, so two policies that compute
    the same function must give the same logits bit for bit.
    """
    cfg = dataclasses.replace(get_spikingformer_config(PRESET + "@eager"),
                              num_layers=depth)
    gen = torch.Generator().manual_seed(seed)
    params, state = init_spikingformer(gen, cfg, DEVICE)
    exact = weights == "dyadic"

    def rand_like(t, fn):
        return fn(t.shape).to(t)

    if exact:
        _map_weights(params, lambda w: rand_like(w, lambda sh: torch.randint(
            -16, 16, sh, generator=gen).float() / 64))

    def perturb(bn, _):
        if exact:
            bn["gamma"] = rand_like(bn["gamma"], lambda sh: torch.randint(
                3, 6, sh, generator=gen).float() / 4)
            bn["beta"] = rand_like(bn["beta"], lambda sh: torch.randint(
                -4, 5, sh, generator=gen).float() / 16)
        else:
            bn["gamma"] = rand_like(bn["gamma"], lambda sh: 0.8 + 0.4 *
                                    torch.rand(sh, generator=gen))
            bn["beta"] = rand_like(bn["beta"], lambda sh: 0.2 *
                                   torch.randn(sh, generator=gen))

    _zip_bn(params, state, perturb)

    def make_images():
        shape = (batch, cfg.image_size, cfg.image_size, cfg.in_channels)
        if exact:
            return (torch.randint(0, 16, shape, generator=gen).float()
                    / 16).to(DEVICE)
        return torch.rand(shape, generator=gen).to(DEVICE)

    with torch.no_grad():
        _, new_state = spikingformer_apply(params, state, make_images(), cfg,
                                           train=True)

    def unblend(new, old):   # new = 0.9 * old + 0.1 * batch statistic
        if isinstance(new, dict):
            return {k: unblend(new[k], old[k]) for k in new}
        if isinstance(new, list):
            return [unblend(a, b) for a, b in zip(new, old)]
        return (new - 0.9 * old) / 0.1

    state = unblend(new_state, state)

    def round_stats(bn_p, bn_s):
        # sqrt(var + eps) -> the nearest power of two; gamma (a multiple of
        # 1/16) takes up the change of scale, so that the rounded network
        # stays close to the calibrated one and keeps its spike rates.
        true = torch.sqrt(bn_s["var"].clamp_min(0) + 1e-5)
        sqrt_d = torch.exp2(torch.round(torch.log2(true)).clamp(-2, 4))
        bn_p["gamma"] = (torch.round(bn_p["gamma"] * sqrt_d / true * 16)
                         .clamp(1, 32) / 16)
        bn_s["var"] = _exact_var(sqrt_d)
        bn_s["mean"] = torch.round(bn_s["mean"] * 64) / 64

    if exact:
        _zip_bn(params, state, round_stats)
    return SpikingFormer(cfg, params, state, device=DEVICE), make_images


def spike_mismatch(a: torch.Tensor, b: torch.Tensor, lif_cfg) -> float:
    """Fraction of differing spikes after the LIF the next block applies to
    a block's output (the tokenizer's output is spikes already)."""
    sa, sb = (_lif_scan_eager(x, lif_cfg, "pssa.lif") for x in (a, b))
    return float((sa != sb).float().mean())


def run_model(seed: int, depth: int, requests: int, batch: int, weights: str):
    """Serve ``requests`` batches under ``cuda-full`` and under ``eager``
    with one set of weights and compare. Returns the launch counts of the
    ``cuda-full`` run."""
    eager, make_images = make_model(seed, depth, batch, weights)
    cfg = eager.cfg
    full = eager.with_policy(named_policy("cuda-full"))
    plan = {r.site: r.effective for r in full.cfg.execution_plan()}
    images = [make_images() for _ in range(requests)]

    def serve(model, taps_out):
        logits, times = [], []
        for img in images:
            taps: list = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits.append(model(img, taps=taps))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            taps_out.append(taps)
        return torch.cat(logits), times

    full(images[0])                      # warm-up, not counted or timed
    eager(images[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()                # the main path starts here
    taps_full: list = []
    lf, ms_full = serve(full, taps_full)
    counts = launch_counts()             # ... and ends here
    peak_full = torch.cuda.max_memory_allocated()
    taps_eager: list = []
    le, ms_eager = serve(eager, taps_eager)

    per_forward = {"lif_soma_fwd": 3 * depth,
                   "neuron_layer_eval": 4 + 4 * depth,
                   "spike_matmul_packed": 2 * depth,
                   "spike_matmul_packed_batched": depth,
                   # eval: no backward, BN folded into the weights
                   "lif_soma_bwd": 0, "bn_fwd": 0, "bn_bwd": 0,
                   "neuron_layer_train": 0,
                   PACK_ENTRY: pack_per_pass(depth, cfg.tokenizer_stages)}
    want = {k: v * requests for k, v in per_forward.items()}
    if counts != want:
        fail(f"launch counts {counts} != {want} for {requests} forwards")
    if lf.shape != (requests * batch, cfg.num_classes) or \
            not bool(torch.isfinite(lf).all()):
        fail(f"logits of shape {tuple(lf.shape)} or not finite")
    logit_err = float((lf - le).abs().max())
    agree = int((lf.argmax(-1) == le.argmax(-1)).sum())

    lif_cfg = cfg.lif
    free, forced, rates = [], [], []
    block_cfg = full.cfg.block
    params, state = full.params, full.state
    for tf, te in zip(taps_full, taps_eager):
        row = [float((tf[0] != te[0]).float().mean())]
        row += [spike_mismatch(a, b, lif_cfg) for a, b in zip(tf[1:], te[1:])]
        free.append(row)
        rates.append([float(te[0].mean()),
                      float(_lif_scan_eager(te[-1], lif_cfg, "").mean())])
        # each block alone, fed the eager policy's input to that block: what
        # one block's kernels flip, without what earlier flips cascade into
        row = []
        with torch.no_grad():
            for i in range(depth):
                out, _ = block_apply(_index_tree(params["blocks"], i),
                                     _index_tree(state["blocks"], i), te[i],
                                     block_cfg, train=False)
                row.append(spike_mismatch(out, te[i + 1], lif_cfg))
        forced.append(row)
    worst_forced = max(max(r) for r in forced)
    worst_tok = max(r[0] for r in free)
    if weights == "dyadic":
        tolerance = ("every sum is exact in fp32: logits, and the spikes "
                     "after the tokenizer and after every block, equal the "
                     "eager policy's bit for bit")
        ok = logit_err == 0.0 and max(max(r) for r in free) == 0.0
    else:
        tolerance = ("the tokenizer's spikes, and every block's on the eager "
                     "policy's input to it, differ from the eager policy's "
                     "(fp32, TF32 off) in <= 1e-3 of the elements; the "
                     "free-running rows and logits are reported, not held: "
                     "one flipped spike spreads through attention")
        ok = worst_forced <= 1e-3 and worst_tok <= 1e-3
    emit("model", weights=weights, preset=f"{PRESET}@cuda-full", depth=depth,
         dtype="float32", requests=requests, batch=batch, plan=plan,
         logits_shape=list(lf.shape), logits_std=float(le.std()),
         max_abs_logit_err=logit_err,
         argmax_agree=f"{agree}/{requests * batch}",
         spike_rate_tokenizer_and_last_block=rates,
         spike_mismatch_free_running=free,
         spike_mismatch_per_block_same_input=forced,
         ms_per_request_cuda_full=ms_full, ms_per_request_eager=ms_eager,
         peak_memory_bytes_cuda_full=peak_full,
         launches=counts, launches_per_forward=per_forward,
         tolerance=tolerance)
    if not ok:
        fail(f"model ({weights} weights): logits differ by {logit_err}, "
             f"argmax agrees on {agree}, worst per-block mismatch on the "
             f"same input {worst_forced}, tokenizer {worst_tok}, "
             f"free-running {max(max(r) for r in free)}")
    return counts


def model_phase(seed: int, depth: int, requests: int, batch: int):
    """The exact weights show that the two policies compute one function,
    end to end; the Gaussian weights show each block's kernels against the
    eager policy at ordinary values, and give the times."""
    run_model(seed, depth, requests, batch, "dyadic")
    return run_model(seed, depth, requests, batch, "gaussian")


# ---------------------------------------------------------------------------
# Phase 5: training
# ---------------------------------------------------------------------------

#: Launches of each kernel in one training step of the full policy, from the
#: code: per block, 3 LIF scans (pssa.lif x2, smlp.lif) whose backward runs
#: the GRAD kernel; 4 neuron-layer sites (q, k, v, smlp.a) + 4 tokenizer
#: stages, whose backward replays z through the kernel's first pass (a
#: launch of ``neuron_layer_train``, whose pass it is), then SOMA, GRAD and
#: the BN backward; 2 pipeline sites (pssa.proj, smlp.b) with the spike
#: matmul and the BN pair; attn_qk on the batched spike matmul (attn_av
#: demotes: 196 % 8); the pack of every packed call (:func:`pack_per_pass`).
def per_train_step(depth: int, stages: int) -> dict[str, int]:
    sites = 4 * depth + stages
    return {"lif_soma_fwd": 3 * depth + sites, "lif_soma_bwd": 3 * depth + sites,
            "spike_matmul_packed": 2 * depth,
            "spike_matmul_packed_batched": depth,
            "bn_fwd": 2 * depth, "bn_bwd": 2 * depth + sites,
            "neuron_layer_train": 2 * sites, "neuron_layer_eval": 0,
            PACK_ENTRY: pack_per_pass(depth, stages)}


def step_replay_check(cfg, params, state, images) -> dict:
    """C1 on the training step's own activations: one train-mode forward of
    the ``cuda-full`` model with every neuron-layer kernel call captured
    (inputs and what the autograd op saves), then at each of those sites
    the spikes the backward's replay gives against those the forward
    emitted. Every one must agree bit for bit."""
    calls, real = [], neuron_layer.neuron_layer_train_fwd

    def capture(x, w, gamma, beta, **kw):
        out = real(x, w, gamma, beta, **kw)
        calls.append((x, w, gamma, beta, kw["packed"], out))
        return out

    neuron_layer.neuron_layer_train_fwd = capture
    try:
        with torch.no_grad():
            spikingformer_apply(params, state, images, cfg, train=True)
    finally:
        neuron_layer.neuron_layer_train_fwd = real
    bad = [replay_mismatch(x, w, g, b, packed, out)
           for x, w, g, b, packed, out in calls]
    return {"sites": len(calls), "packed_sites": sum(c[4] for c in calls),
            "spikes_compared": sum(c[5][0].numel() for c in calls),
            "mismatch": sum(bad)}


def train_phase(seed: int, batch: int) -> dict[str, int]:
    """One warm-up step, then TRAIN_STEPS steps of ``make_train_step`` at
    the preset, full depth, under ``cuda-full`` and under ``eager``, from
    the same initial parameters, BN state and AdamW state, on the same
    ``SyntheticVision`` batches. Every step must be finite and the
    parameters and BN running statistics must change. Returns the launch
    counts of the ``cuda-full`` steps."""
    cfg = get_spikingformer_config(PRESET + "@eager")
    depth = cfg.num_layers
    params, state = init_spikingformer(torch.Generator().manual_seed(seed),
                                       cfg, DEVICE)
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=100,
                              weight_decay=0.01)
    data = SyntheticVision(VisionDataConfig(
        image_size=cfg.image_size, num_classes=cfg.num_classes,
        global_batch=batch, channels=cfg.in_channels, seed=seed))
    batches = [{k: torch.from_numpy(v).to(DEVICE)
                for k, v in data.batch(i).items()}
               for i in range(TRAIN_STEPS + 1)]
    result, counts = {}, None
    for name in ("cuda-full", "eager"):
        step = make_train_step(cfg.with_policy(named_policy(name)), opt_cfg)
        opt = init_opt_state(params)
        step(params, state, opt, batches[0]["images"], batches[0]["labels"])
        torch.cuda.synchronize()                     # warm-up, not counted
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        p, st = params, state
        rows, times = [], []
        if name == "cuda-full":
            reset_launch_counts()                    # the main path starts
        for b in batches[1:]:
            t0 = time.perf_counter()
            p, st, opt, m = step(p, st, opt, b["images"], b["labels"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            rows.append({k: float(m[k]) for k in
                         ("loss", "grad_norm", "nonfinite", "accuracy")})
        if name == "cuda-full":
            counts = launch_counts()     # ... and ends here
        moved = {
            "params": not all(torch.equal(a, b) for a, b in
                              zip(tree_leaves(p), tree_leaves(params))),
            "bn_running_stats": not all(torch.equal(a, b) for a, b in
                                        zip(tree_leaves(st), tree_leaves(state)))}
        result[name] = {"ms_per_step": times, "steps": rows, "moved": moved,
                        "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        bad = [r for r in rows if r["nonfinite"] != 0.0 or
               not all(map(math.isfinite, (r["loss"], r["grad_norm"])))]
        if bad or not all(moved.values()):
            fail(f"training under {name}: non-finite steps {bad} or nothing "
                 f"moved {moved}")
        del p, st, opt, step
        torch.cuda.empty_cache()
    per_step = per_train_step(depth, cfg.tokenizer_stages)
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    replay = step_replay_check(cfg.with_policy(named_policy("cuda-full")),
                               params, state, batches[0]["images"])
    emit("train", preset=f"{PRESET}@cuda-full", depth=depth, batch=batch,
         steps=TRAIN_STEPS, dtype="float32", data="SyntheticVision",
         optimizer=dataclasses.asdict(opt_cfg), **result,
         launches=counts, launches_per_step=per_step, replay=replay,
         note="the eager run starts from the same state on the same batches;"
              " its losses are reported, not held against cuda-full's "
              "(free-running spikes on random weights part after a flip)")
    if counts != want:
        fail(f"training launch counts {counts} != {want} for {TRAIN_STEPS} "
             f"steps")
    sites = 4 * depth + cfg.tokenizer_stages
    if replay["mismatch"] or replay["sites"] != sites:
        fail(f"the backward's replay differs from the emitted spikes: "
             f"{replay}")
    return counts


#: Block-level limits. Spikes: the eval phase's per-block limit. Gradients:
#: a random cotangent weighs every term a gradient sums with an independent
#: sign, so when a fraction f of those terms changes (flipped spikes and
#: what they move) the gradient moves by about sqrt(f) of its norm. Each
#: seed's gradients are held at GRAD_FACTOR * sqrt(f) of the spike mismatch
#: f measured on that seed, so the limit tightens as fewer spikes flip; where
#: none flips, at GRAD_FLOOR, ten times the fp32 noise of weight gradients
#: summed over 12,544 rows in another order. The autograd glue
#: around the kernels is the same code on the CPU, where the tests hold it to
#: the reference at 1e-5; here the check sees what the kernels' rounding does
#: to the gradients at the preset's shapes.
SPIKE_LIMIT = 1e-3
GRAD_FACTOR, GRAD_FLOOR = 2.0, 1e-4
BLOCK_SEEDS = 2
#: The last BN's beta: its gradient is the sum of the cotangent, which no
#: spike reaches, so it is held at fp32 summation noise.
CONTROL_LEAF, CONTROL_LIMIT = "smlp.b.bn.beta", 1e-5


def block_grad_case(seed: int, batch: int) -> dict:
    """One block of the preset in train mode on the *same* input with the
    *same* upstream cotangent, under ``cuda-full`` and ``eager``: spike
    mismatch after the next block's LIF, and the relative L2 error of the
    gradient of every parameter leaf and of the input. BN statistics over
    12,544 rows summed in another order move membranes by ~1e-7 of their
    scale, which flips the spikes that sit that close to the threshold."""
    cfg = get_spikingformer_config(PRESET + "@eager")
    gen = torch.Generator().manual_seed(seed + 7)
    params, state = init_spikingformer(gen, cfg, DEVICE)
    bp, bs = (_index_tree(t["blocks"], 0) for t in (params, state))
    shape = (cfg.time_steps, batch, cfg.num_tokens, cfg.d_model)
    x = (torch.randn(shape, generator=gen) * 1.0 + 0.4).to(DEVICE)
    g = torch.randn(shape, generator=gen).to(DEVICE)
    out = {}
    for name in ("cuda-full", "eager"):
        bcfg = cfg.with_policy(named_policy(name)).block
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(bp)]
        xin = x.clone().requires_grad_(True)
        y, _ = block_apply(tree_unflatten(bp, leaves), bs, xin, bcfg,
                           train=True)
        grads = torch.autograd.grad((y * g).sum(), leaves + [xin])
        out[name] = (y.detach(), grads)
    (yf, gf), (ye, ge) = out["cuda-full"], out["eager"]
    mismatch = spike_mismatch(yf, ye, cfg.lif)
    rel = {n: float((a - b).norm() / b.norm().clamp_min(1e-30))
           for n, a, b in zip(tree_paths(bp) + ["input"], gf, ge)}
    control = rel.pop(CONTROL_LEAF)
    worst = max(rel.values())
    grad_limit = max(GRAD_FACTOR * math.sqrt(mismatch), GRAD_FLOOR)
    return {"seed": seed, "block": 0, "shape": list(shape),
            "spike_mismatch": mismatch, "grad_rel_l2": rel,
            "worst_grad_rel_l2": worst,
            "worst_over_sqrt_mismatch": worst / math.sqrt(mismatch)
            if mismatch else None,
            "control_leaf": {CONTROL_LEAF: control},
            "max_abs_out_err": float((yf - ye).abs().max()),
            "limits": {"spike_mismatch": SPIKE_LIMIT,
                       "grad_rel_l2": grad_limit,
                       "control_leaf": CONTROL_LIMIT},
            "ok": mismatch <= SPIKE_LIMIT and worst <= grad_limit
            and control <= CONTROL_LIMIT}


def block_grad_check(seed: int, batch: int) -> None:
    """``block_grad_case`` on BLOCK_SEEDS seeds, each held at its limits."""
    cases = [block_grad_case(seed + i, batch) for i in range(BLOCK_SEEDS)]
    emit("block_grad", preset=PRESET, cases=cases,
         tolerance=f"spike mismatch <= {SPIKE_LIMIT}; every gradient leaf's "
                   f"relative L2 error <= max({GRAD_FACTOR} * sqrt(spike "
                   f"mismatch), {GRAD_FLOOR}); {CONTROL_LEAF} <= "
                   f"{CONTROL_LIMIT}")
    bad = [c for c in cases if not c["ok"]]
    if bad:
        fail("block gradient check: " + "; ".join(
            f"seed {c['seed']}: spike mismatch {c['spike_mismatch']}, worst "
            f"gradient relative L2 error {c['worst_grad_rel_l2']} (limit "
            f"{c['limits']['grad_rel_l2']}), {CONTROL_LEAF} "
            f"{c['control_leaf'][CONTROL_LEAF]}" for c in bad))


# ---------------------------------------------------------------------------
# Phase 6 (and 8): the spiking LMs' serving paths (qwen3-0.6b + LIF, published
# widths and depth; deepseek-v2-236b + LIF, published widths, 2 of 60 layers)
# ---------------------------------------------------------------------------

LM_ARCH = "qwen3-0.6b"
LM_SLOTS, LM_MAX_SEQ = 8, 256          # the engine's decode batch and cache
LM_REQUESTS = 16
LM_FWD_SEQ = 256                       # the forward's (1, S) token batch
LM_PROMPT, LM_NEW = (8, 64), (16, 32)  # request lengths, both ends included
#: The training step: the reference driver's batch and sequence defaults,
#: one warm-up step and LM_TRAIN_STEPS timed steps through ``train()``.
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 8, 128, 3
#: Gradient leaves that are not bit-equal between the policies: relative L2
#: (GRAD may round in another order than autograd through the eager loop).
LM_GRAD_LIMIT = 1e-5


#: The MoE/MLA phase's model: ``deepseek-v2-236b`` at its published widths
#: (MLA, 160 routed experts top-6 at capacity factor 1.25, 2 shared), the
#: depth cut to 2 of its 60 layers (15.9 GB a layer in fp32).
MOE_ARCH, MOE_LAYERS = "deepseek-v2-236b", 2
#: The recurrent families' models, at their published widths and depths:
#: ``rwkv6-7b`` (32 layers, d 4096, 31.2 GB in fp32) and ``zamba2-2.7b``
#: (54 Mamba2 layers, d 2560, and the shared attention block after every
#: 6, 9.4 GB).
RWKV_ARCH, HYBRID_ARCH = "rwkv6-7b", "zamba2-2.7b"
#: Each LM phase's name, the prefix of its lines and paths.
PHASE_NAMES = {LM_ARCH: "lm", MOE_ARCH: "moe_mla", RWKV_ARCH: "rwkv",
               HYBRID_ARCH: "hybrid"}
#: The vlm family's one registry model, ``pixtral-12b`` + LIF (40 layers, d
#: 5120, 32 / 8 heads of 160, d_ff 14336, vocabulary 131072; its ViT
#: frontend is a stub, so image patches arrive embedded): served at its
#: published bf16 and depth through ``VLM_SLOTS`` slots, trained in fp32 at
#: the deepest depth whose world-1 dry-run estimate is within
#: ``VLM_FIT_BYTES``. ``VLM_PATCH_RATE`` of a batch's positions carry a
#: patch, so that the merge runs (the driver's batches carry none).
VLM_ARCH, VLM_SLOTS, VLM_FIT_BYTES, VLM_PATCH_RATE = \
    "pixtral-12b", 16, 64e9, 0.25
#: At the reference's init a (d, h, dh) projection is drawn at heads^-1/2
#: (ROADMAP C7), and ``pixtral-12b`` has no q/k norm: its attention logits
#: have a std of about sqrt(5120 / 32) * sqrt(5120 / 8) = 320 (whisper's
#: about 64). Its training is held from the driver's weights with every
#: wq and wk times ``VLM_QK_SCALE`` (logits about 5, whisper's regime at its
#: ``QK_SCALE``), and measured at the init.
VLM_QK_SCALE = 0.125


def lm_config(policy: str, arch: str = LM_ARCH,
              dtype: torch.dtype = torch.float32):
    """``arch`` at its published widths, in ``dtype`` (fp32 unless the
    bf16 phase asks for the published bf16), with the LIF neuron on every
    block's FFN / channel-mix / Mamba2 branch under ``policy``: at its
    published depth, but ``deepseek-v2-236b`` at ``MOE_LAYERS``."""
    cfg = get_config(arch).replace(
        dtype=dtype, lif=LIFConfig(policy=named_policy(policy)))
    return cfg.replace(num_layers=MOE_LAYERS) if arch == MOE_ARCH else cfg


def phase_name(arch: str) -> str:
    """The prefix of an LM phase's lines and paths (``PHASE_NAMES``)."""
    return PHASE_NAMES[arch]


LM_FWD_BATCHES = (1, LM_SLOTS)         # the forward's token batches


def lm_lif_cases(gen, arch: str = LM_ARCH) -> dict[str, list[dict]]:
    """``lif_soma_fwd`` at a spiking LM's shapes, in the layouts the model
    hands the kernel: decode (1, slots, d) from the carried state (one
    launch a layer) and the forward's (S, B, d) at each of
    ``LM_FWD_BATCHES`` as the (S, B, d) view of the (B, S, d) branch
    output; S, U and mask (and the decode's final state) bit-equal to the
    plain version (``check_lif`` fails otherwise). ``path`` names the run
    whose launches ``lm_launches`` adds to the case once the LM phases have
    counted them (the training step's cases: ``train_lif_cases``)."""
    d = get_config(arch).d_model
    pre = phase_name(arch)
    rows = {"lif_soma_fwd": [], "lif_soma_bwd": []}
    shapes = [(1, LM_SLOTS, f"{pre}_serve"),
              *((LM_FWD_SEQ, b, f"{pre}_forward_b{b}")
                for b in LM_FWD_BATCHES)]
    for t, m, path in shapes:
        decode = path.endswith("_serve")
        row = check_lif(gen, t, m, d, case=f"lm.ffn.lif "
                        f"{'decode' if decode else 'forward'}" + (
                            "" if arch == LM_ARCH else f" ({arch})"),
                        layout="dense" if decode else "lm", carry=decode)
        row.update(bitwise=True, path=path)
        rows["lif_soma_fwd"].append(row)
    return rows


def train_lif_cases(gen, arch: str = LM_ARCH) -> dict[str, list[dict]]:
    """``lif_soma_fwd`` and ``lif_soma_bwd`` at a spiking LM's training
    step, (128, 8, d) as the (S, B, d) view of the (B, S, d) branch output
    and its cotangent, bit-equal to the plain versions; ``path`` is the
    LM's training path (``TRAIN_PHASES``)."""
    d, path = get_config(arch).d_model, TRAIN_PHASES[arch]
    case = "lm.ffn.lif train" + ("" if arch == LM_ARCH else f" ({arch})")
    fwd = check_lif(gen, LM_TRAIN_SEQ, LM_TRAIN_BATCH, d, case=case,
                    layout="lm")
    bwd = check_lif_bwd(gen, LM_TRAIN_SEQ, LM_TRAIN_BATCH, d, case=case,
                        carry=False, layout="lm")
    for row in (fwd, *bwd):
        row.update(bitwise=True, path=path)
    return {"lif_soma_fwd": [fwd], "lif_soma_bwd": bwd}


def lm_launches(cases: dict[str, list[dict]],
                counts: dict[str, dict[str, int]], steps: dict[str, int]
                ) -> None:
    """Adds to each LM case of ``lif_soma_fwd`` and ``lif_soma_bwd`` the
    launches counted on its path in this run: per decode step or training
    step (the run's count over its ``steps``), or per forward."""
    for name, rows in cases.items():
        for row in rows:
            n = counts.get(row.get("path"), {}).get(name)
            if n is None:
                continue
            if row["path"].endswith("_serve"):
                row["launches_per_decode_step"] = n / steps[row["path"]]
            elif row["path"].endswith("_train"):
                row["launches_per_step"] = n / steps[row["path"]]
            else:
                row["launches_per_forward"] = n


def lm_expected(n: int) -> dict[str, int]:
    """``n`` launches of ``lif_soma_fwd``, none of any other kernel: the
    LM's products are dense ``torch.matmul``, and serving has no backward."""
    counts = dict.fromkeys(COUNTED, 0)
    counts["lif_soma_fwd"] = n
    return counts


def lm_walk(params, toks, cfg, probe=None):
    """``lm_forward`` taken apart layer by layer, the same operations in
    the same order (attention or MLA, SwiGLU or the MoE; RWKV's time and
    channel mix; the Mamba2 mixers and, after each group, the shared
    block), to keep each block's branch spikes (B, S, d). ``probe(p, h)``,
    if given, sees each Mamba2 layer's parameters and normalised input.
    Returns (hidden, spikes)."""
    per = _hybrid_group_shape(cfg)[1] if cfg.family == "hybrid" else 0
    with torch.inference_mode():
        x = embed(params["embed"], toks, cfg.dtype)
        spikes = []
        for i in range(cfg.num_layers):
            p = layer(params["blocks"], i)
            if cfg.family == "rwkv":
                x = x + rwkv_mod.rwkv_time_mix(
                    p["time"], rmsnorm(p["ln1"], x, cfg.norm_eps), cfg.rwkv)
                f = rwkv_mod.rwkv_channel_mix(
                    p["chan"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.rwkv)
            elif cfg.family == "hybrid":
                h = rmsnorm(p["ln"], x, cfg.norm_eps)
                if probe is not None:
                    probe(p["ssm"], h)
                f = ssm_mod.ssm_mixer(p["ssm"], h, cfg.ssm)
            else:
                h = rmsnorm(p["ln1"], x, cfg.norm_eps)
                x = x + (mla_attention(p["attn"], h, cfg.mla) if cfg.mla
                         is not None else attention(p["attn"], h, cfg.attn))
                h = rmsnorm(p["ln2"], x, cfg.norm_eps)
                f = moe_apply(p["ffn"], h, cfg.moe)[0] if cfg.moe \
                    is not None else swiglu(p["ffn"], h)
            f = _seq_lif(f, cfg)
            spikes.append(f)
            x = x + f
            if per and (i + 1) % per == 0:
                x = _dense_block(params["shared"], x, _shared_cfg(cfg),
                                 use_flash=False)[0]
        return rmsnorm(params["ln_f"], x, cfg.norm_eps), spikes


def ssd_overflows(params, toks, cfg) -> list[int]:
    """Per Mamba2 layer of a forward on ``toks``, the masked (upper
    triangle) SSD entries whose ``exp(cum_t - cum_i)`` overflows to inf
    (ROADMAP C6: the forward stays finite, a gradient would not), counted
    on the mixer's own ``cum`` from the layer's input in ``lm_walk``."""
    counts = []
    scfg = cfg.ssm

    def probe(p, h):
        b, s, _ = h.shape
        dt = ssm_mod._split_proj(p, h, scfg)[2]
        ck = scfg.chunk if s % scfg.chunk == 0 else s
        cum = torch.cumsum(ssm_mod._decay_log(p, dt)[1].reshape(
            b, s // ck, ck, -1), dim=2)
        li = cum[:, :, :, None, :] - cum[:, :, None, :, :]
        upper = torch.ones((ck, ck), dtype=torch.bool,
                           device=h.device).triu(1)[:, :, None]
        counts.append(int((torch.isinf(torch.exp(li)) & upper).sum()))
    lm_walk(params, toks, cfg, probe)
    return counts


@contextlib.contextmanager
def counting_drops(out: list):
    """While open, every MoE layer call appends to ``out`` the number of
    its (token, choice) pairs past their expert's capacity (the pairs the
    layer drops), a device scalar: ``moe._route`` is wrapped, its results
    unchanged."""
    route = moe_mod._route

    def counted(router_w, x_flat, cfg):
        gates, experts, aux = route(router_w, x_flat, cfg)
        pos = moe_mod._expert_positions(experts.reshape(-1), cfg.num_experts)
        out.append((pos >= cfg.capacity(x_flat.shape[0])).sum())
        return gates, experts, aux
    moe_mod._route = counted
    try:
        yield
    finally:
        moe_mod._route = route


def per_layer(drops: list, layers: int) -> list[list[int]]:
    """``counting_drops``' scalars of whole forwards or decode steps, as
    one list per call: a count per layer."""
    flat = [int(d) for d in drops]
    return [flat[i:i + layers] for i in range(0, len(flat), layers)]


def lm_forward_phase(params, seed: int, arch: str = LM_ARCH,
                     smi: str | None = None) -> dict[str, dict[str, int]]:
    """``lm_forward`` on a (B, 256) token batch for each B of
    ``LM_FWD_BATCHES`` under ``cuda-full`` and ``eager``, the same weights:
    hidden states and logits must be equal bit for bit (only the LIF
    differs, and its kernel equals its plain version), and a second
    ``cuda-full`` forward must repeat the first bit for bit. At B = 1 every
    layer's branch spikes too, from ``lm_walk``, whose hidden states must
    equal the forward's. With the MoE, the (token, choice) pairs that each
    layer drops are counted in one more forward. Returns the launch counts
    of each ``cuda-full`` forward, by path."""
    cfg_full = lm_config("cuda-full", arch)
    layers = cfg_full.num_layers
    pre = phase_name(arch)
    paths = {}
    for batch in LM_FWD_BATCHES:
        toks = torch.from_numpy(SyntheticLM(DataConfig(
            vocab_size=cfg_full.vocab_size, seq_len=LM_FWD_SEQ,
            global_batch=batch, seed=seed)).batch(0)["tokens"]).to(DEVICE)
        out = {}
        for policy in ("cuda-full", "eager"):
            cfg = lm_config(policy, arch)

            def fwd():
                with torch.inference_mode():
                    h, _ = lm_forward(params, {"tokens": toks}, cfg)
                    return h, unembed(params["embed"], h)
            fwd()                            # warm-up, not counted
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()            # the path starts here
            h, logits = fwd()
            torch.cuda.synchronize()
            counts = launch_counts()         # ... and ends here
            peak = torch.cuda.max_memory_allocated()
            again = fwd()
            out[policy] = {"h": h, "logits": logits, "counts": counts,
                           "ms": time_ms(fwd), "peak": peak,
                           "repeats": torch.equal(again[0], h)
                           and torch.equal(again[1], logits)}
            del again
            if batch == 1:
                wh, out[policy]["spikes"] = lm_walk(params, toks, cfg)
                if not torch.equal(wh, h):
                    fail(f"{pre} forward: the layer walk's hidden states "
                         f"differ from lm_forward's under {policy}")
        full, eager = out["cuda-full"], out["eager"]
        same = {"hidden": torch.equal(full["h"], eager["h"]),
                "logits": torch.equal(full["logits"], eager["logits"]),
                "cuda_full_repeat": full["repeats"],
                "eager_repeat": eager["repeats"]}
        extra = {}
        if batch == 1:
            same["spikes"] = all(torch.equal(a, b) for a, b in
                                 zip(full["spikes"], eager["spikes"]))
            extra["spike_rate_per_layer"] = [float(t.mean())
                                             for t in eager["spikes"]]
        if cfg_full.moe is not None:
            drops: list = []
            with counting_drops(drops), torch.inference_mode():
                lm_forward(params, {"tokens": toks}, cfg_full)
            n = toks.numel()
            extra.update(moe_tokens=n, capacity=cfg_full.moe.capacity(n),
                         pairs_per_layer=n * cfg_full.moe.top_k,
                         dropped_pairs_per_layer=per_layer(drops, layers)[0])
        if cfg_full.ssm is not None and batch == LM_SLOTS:
            ovf = ssd_overflows(params, toks, cfg_full)
            ck = cfg_full.ssm.chunk
            extra["ssd_masked_exp_overflows"] = {
                "total": sum(ovf), "per_layer": ovf,
                "masked_entries_per_layer": batch * LM_FWD_SEQ // ck
                * cfg_full.ssm.n_heads * ck * (ck - 1) // 2,
                "chunk": ck, "note": "ROADMAP C6, measured, not held: "
                "exp overflows in the masked upper triangle, the forward "
                "stays finite, a gradient would not"}
        if smi is not None:
            extra["card"] = smi
        emit(f"{pre}_forward", arch=f"{cfg_full.name}@cuda-full",
             layers=layers, d_model=cfg_full.d_model,
             vocab=cfg_full.vocab_size, dtype="float32",
             tokens=list(toks.shape), bit_equal_to_eager=same,
             max_abs_logit_err=float((full["logits"] - eager["logits"]).abs()
                                     .max()),
             logits_std=float(eager["logits"].std()), **extra,
             ms_cuda_full=full["ms"], ms_eager=eager["ms"],
             peak_memory_bytes_cuda_full=full["peak"],
             peak_memory_bytes_eager=eager["peak"],
             launches=full["counts"], launches_eager=eager["counts"],
             tolerance="bitwise: hidden states and logits (at B = 1 every "
                       "layer's branch spikes too) equal to the eager "
                       "policy's, and each policy's second forward equal "
                       "to its first")
        if not all(same.values()) or not bool(torch.isfinite(full["logits"])
                                              .all()):
            fail(f"{pre} forward {list(toks.shape)}: cuda-full against "
                 f"eager {same}")
        if full["counts"] != lm_expected(layers) or \
                eager["counts"] != lm_expected(0):
            fail(f"{pre} forward launch counts {full['counts']} (eager "
                 f"{eager['counts']}), want {layers} lif_soma_fwd")
        paths[f"{pre}_forward_b{batch}"] = full["counts"]
        del out, full, eager
        torch.cuda.empty_cache()
    return paths


def lm_requests(vocab: int, seed: int) -> list[tuple[list[int], int]]:
    """(prompt, max_new_tokens) of each request: prompts from
    ``SyntheticLM``, lengths and budgets drawn from ``seed``."""
    tokens = SyntheticLM(DataConfig(vocab_size=vocab, seq_len=LM_PROMPT[1],
                                    global_batch=LM_REQUESTS,
                                    seed=seed)).batch(0)["tokens"]
    rng = np.random.default_rng(seed)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    new = rng.integers(LM_NEW[0], LM_NEW[1] + 1, LM_REQUESTS)
    return [(tokens[i, :lens[i]].tolist(), int(new[i]))
            for i in range(LM_REQUESTS)]


def lm_serve(params, policy: str, reqs, only=None, record: bool = True,
             arch: str = LM_ARCH, drops: list | None = None,
             dtype: torch.dtype = torch.float32, slots: int = LM_SLOTS
             ) -> dict:
    """Run the requests (those of ``only``, if given) to completion
    through one ``ServingEngine`` under ``policy``, a step at a time, each
    step synchronised and timed. With ``record``, keeps a host copy of
    every step's logits and branch spikes (the cache's new S, (L, slots,
    d)) by wrapping the engine's fused step, so that the peak device memory
    is the engine's own; the copy is then in the step's time, so the times
    a user would see come from a run without it. Given ``drops``, the run
    counts each MoE layer's dropped pairs into it (``counting_drops``).
    ``dtype``: the model's (``lm_config``) and the cache's; ``slots``
    the engine's."""
    engine = ServingEngine(params, lm_config(policy, arch, dtype),
                           slots=slots, max_seq=LM_MAX_SEQ,
                           cache_dtype=dtype)
    steps: list = []
    if record:
        fused = engine._step

        def recorded(*args):
            logits, cache = fused(*args)
            steps.append((logits.cpu(), branch_spikes(cache).cpu()))
            return logits, cache
        engine._step = recorded
    for uid, (prompt, new) in enumerate(reqs):
        if only is None or uid in only:
            if not engine.submit(Request(uid=uid, prompt=prompt,
                                         max_new_tokens=new)):
                fail(f"lm serve: request {uid} rejected")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()                    # the path starts here
    times = []
    t_run = time.perf_counter()
    with counting_drops(drops) if drops is not None else \
            contextlib.nullcontext():
        while engine.sched.has_work():
            t0 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t_run
    counts = launch_counts()                 # ... and ends here
    if record:
        del engine._step        # the wrapper and the engine hold each other
    done = {r.uid: r for r in engine.finished}
    return {"done": done, "steps": steps, "ms": times, "wall_s": wall,
            "counts": counts, "peak": torch.cuda.max_memory_allocated(),
            "step_count": engine.step_count,
            "generated": engine.generated_tokens,
            "other": len(engine.rejected + engine.expired + engine.evicted
                         + engine.faulted)}


def branch_spikes(cache) -> torch.Tensor:
    """Every layer's branch spikes of a decode step, (L, slots, d): the
    cache's new LIF S (the hybrid's from its (groups, per, slots, d))."""
    s = cache["mamba"]["lif"]["s"] if "mamba" in cache else cache["lif"]["s"]
    return s.reshape(-1, *s.shape[-2:])


def slot_isolation(params, reqs, full, arch: str) -> dict:
    """Request 0 served again alone in the same 8-slot engine shape
    against its run among the others (``full``): tokens and every step's
    logits (held exactly but with the MoE: no other family couples its
    slots). With the MoE every request is served alone once more: at
    decode the 8 slots share each expert's capacity (4 slots an expert for
    8 tokens, ``MoEConfig.capacity``), so a neighbour, an idle slot
    included, can push a token past it, and the count of requests whose
    tokens differ from their solo run is measured, not held."""
    solo = lm_serve(params, "cuda-full", reqs, only={0}, arch=arch)
    r0 = full["done"][0]
    n0 = len(r0.prompt) + len(r0.output) - 1
    iso = {"tokens_equal": solo["done"][0].output == r0.output,
           "admit_step": [r0.admit_step, solo["done"][0].admit_step],
           "steps": n0,
           "logits_equal": all(torch.equal(full["steps"][t][0][0],
                                           solo["steps"][t][0][0])
                               for t in range(n0)),
           "max_abs_logit_err": max(float((full["steps"][t][0][0] -
                                           solo["steps"][t][0][0]).abs().max())
                                    for t in range(n0))}
    if get_config(arch).moe is not None:
        differ = [uid for uid in range(1, len(reqs)) if lm_serve(
            params, "cuda-full", reqs, only={uid}, record=False,
            arch=arch)["done"][uid].output != full["done"][uid].output]
        differ = ([] if iso["tokens_equal"] else [0]) + differ
        iso.update(requests_differing_from_solo=len(differ),
                   differing_uids=differ, requests=len(reqs),
                   note="measured, not held: the slots share each expert's "
                        "capacity at decode")
    return iso


#: Each LM's tokens by request uid from its unrecorded ``cuda-full`` serving
#: run (``lm_serve_phase``): the chaos phase's clean run.
SERVED: dict[str, dict[int, list[int]]] = {}


def lm_serve_phase(params, seed: int, arch: str = LM_ARCH,
                   smi: str | None = None) -> tuple[dict[str, int], int]:
    """16 requests through 8 slots under ``cuda-full`` and ``eager``: every
    request finishes, the token streams are equal and every step's logits
    bit-equal. Each policy serves twice: once recorded, for these checks,
    and once as a user runs the engine, for the times, the peak memory and
    the launch counts (its tokens must equal the recorded run's). Then slot
    isolation (``slot_isolation``): exact, but measured with the MoE. Then
    decode against the forward, measured: request 0's prompt and output
    teacher-forced through ``lm_walk``. With the MoE, the pairs
    each layer drops in each decode step of the recorded ``cuda-full`` run
    are counted. Returns the launch counts of the unrecorded ``cuda-full``
    run and its number of steps."""
    cfg = lm_config("cuda-full", arch)
    layers = cfg.num_layers
    pre = phase_name(arch)
    reqs = lm_requests(cfg.vocab_size, seed)
    policies = ("cuda-full", "eager")
    drops: list | None = [] if cfg.moe is not None else None
    runs = {p: lm_serve(params, p, reqs, arch=arch,
                        drops=drops if p == "cuda-full" else None)
            for p in policies}
    timed = {p: lm_serve(params, p, reqs, record=False, arch=arch)
             for p in policies}
    full, eager = runs["cuda-full"], runs["eager"]
    repeatable = all(
        timed[p]["step_count"] == runs[p]["step_count"] and
        timed[p]["done"].keys() == runs[p]["done"].keys() and
        all(timed[p]["done"][u].output == runs[p]["done"][u].output
            for u in runs[p]["done"]) for p in policies)
    finished = {p: f"{len(r['done'])}/{LM_REQUESTS}" for p, r in runs.items()}
    tokens_equal = all(full["done"][u].output == eager["done"][u].output
                       for u in full["done"]) and \
        full["done"].keys() == eager["done"].keys()
    logits_equal = full["step_count"] == eager["step_count"] and all(
        torch.equal(a[0], b[0]) for a, b in zip(full["steps"], eager["steps"]))
    spikes_equal = all(torch.equal(a[1], b[1])
                       for a, b in zip(full["steps"], eager["steps"]))
    iso = slot_isolation(params, reqs, full, arch)

    # decode against the forward (measured, not held: spikes sit behind
    # reductions that the (1, S) forward and the (slots, 1) decode order
    # differently; with the MoE the forward's capacity differs from
    # decode's, and MLA's absorbed decode orders its sums otherwise)
    r0 = full["done"][0]
    n0 = iso["steps"]
    seq = torch.tensor([r0.prompt + r0.output[:-1]], device=DEVICE)
    h, fwd_spikes = lm_walk(params, seq, cfg)
    with torch.inference_mode():
        fwd_logits = unembed(params["embed"], h)[0].cpu()
    eng_logits = torch.stack([full["steps"][t][0][0] for t in range(n0)])
    eng_spikes = torch.stack([full["steps"][t][1][:, 0] for t in range(n0)])
    vs_forward = {
        "tokens": n0,
        "max_abs_logit_err": float((fwd_logits - eng_logits).abs().max()),
        "logits_std": float(fwd_logits.std()),
        "argmax_agree": f"{int((fwd_logits.argmax(-1) == eng_logits.argmax(-1)).sum())}/{n0}",
        "spike_mismatch_per_layer": [
            float((fwd_spikes[i][0].cpu() != eng_spikes[:, i]).float()
                  .mean())
            for i in range(layers)],
        "note": "measured, not held: the tolerance policy for spikes "
                "behind reductions"}
    extra = {}
    if drops is not None:
        steps = per_layer(drops, layers)
        extra["decode_drops"] = {
            "moe_tokens_per_step": LM_SLOTS,
            "capacity": cfg.moe.capacity(LM_SLOTS),
            "pairs_per_layer_per_step": LM_SLOTS * cfg.moe.top_k,
            "steps": len(steps),
            "dropped_pairs_per_layer_mean": [
                sum(s[i] for s in steps) / len(steps) for i in range(layers)],
            "dropped_pairs_per_layer_max": [max(s[i] for s in steps)
                                            for i in range(layers)],
            "steps_with_a_drop": sum(any(s) for s in steps),
            "note": "recorded cuda-full run; idle slots route too"}
    if smi is not None:
        extra["card"] = smi

    def stats(r):
        ms = sorted(r["ms"])
        return {"ms_per_step_median": ms[len(ms) // 2], "ms_per_step_min":
                ms[0], "ms_per_step_max": ms[-1], "steps": r["step_count"],
                "generated_tokens": r["generated"],
                "tokens_per_s": r["generated"] / r["wall_s"],
                "wall_s": r["wall_s"], "peak_memory_bytes": r["peak"]}
    served = timed["cuda-full"]
    SERVED[arch] = {u: list(r.output) for u, r in served["done"].items()}
    emit(f"{pre}_serve", arch=f"{cfg.name}@cuda-full", layers=layers,
         dtype="float32", slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
         requests=LM_REQUESTS, prompt_lengths=LM_PROMPT,
         new_tokens=LM_NEW, finished=finished,
         tokens_equal=tokens_equal, logits_bit_equal_every_step=logits_equal,
         spikes_bit_equal_every_step=spikes_equal,
         unrecorded_run_repeats_recorded=repeatable,
         slot_isolation=iso, decode_vs_forward=vs_forward, **extra,
         times="from the unrecorded runs (no host copy per step)",
         cuda_full=stats(served), eager=stats(timed["eager"]),
         launches=served["counts"], launches_eager=timed["eager"]["counts"],
         launches_per_decode_step=served["counts"]["lif_soma_fwd"]
         / served["step_count"])
    everyone = all(len(r["done"]) == LM_REQUESTS and not r["other"]
                   for r in (*runs.values(), *timed.values()))
    if not (everyone and tokens_equal and logits_equal and spikes_equal
            and repeatable):
        fail(f"{pre} serve: finished {finished}, tokens equal "
             f"{tokens_equal}, logits equal {logits_equal}, spikes equal "
             f"{spikes_equal}, unrecorded run repeats the recorded one "
             f"{repeatable}")
    if cfg.moe is None and not (iso["tokens_equal"] and iso["logits_equal"]
                                and iso["admit_step"] == [0, 0]):
        fail(f"{pre} serve: slot isolation {iso}")
    for name, r in (("recorded", full), ("unrecorded", served)):
        if r["counts"] != lm_expected(layers * r["step_count"]):
            fail(f"{pre} serve launch counts {r['counts']} for "
                 f"{r['step_count']} steps ({name}), want {layers} "
                 "lif_soma_fwd a step")
    for r in (eager, timed["eager"]):
        if r["counts"] != lm_expected(0):
            fail(f"{pre} serve launch counts under eager {r['counts']}")
    return served["counts"], served["step_count"]


def lm_phase(seed: int, arch: str = LM_ARCH, smi: str | None = None
             ) -> tuple[dict[str, dict[str, int]], int]:
    """A spiking LM at its published widths (``lm_config``) from ``seed``,
    its weights drawn on the card: the forwards, then serving. Returns each
    path's launch counts and the serving run's number of steps."""
    cfg = lm_config("eager", arch)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = split_tree(init_lm(gen, cfg, DEVICE))[0]
    if smi is not None:
        emit(f"{phase_name(arch)}_weights", arch=cfg.name,
             layers=cfg.num_layers, published_layers=get_config(arch)
             .num_layers, parameters=sum(a.numel() for a in
                                         tree_leaves(params)),
             bytes=nbytes(*tree_leaves(params)), card=smi)
    counts = lm_forward_phase(params, seed, arch, smi)
    torch.cuda.empty_cache()
    counts[f"{phase_name(arch)}_serve"], steps = lm_serve_phase(
        params, seed, arch, smi)
    return counts, steps


# ---------------------------------------------------------------------------
# Phase 7 (and 8): the spiking LMs' training paths (qwen3-0.6b, mixtral-8x7b,
# rwkv6-7b, zamba2-2.7b + LIF, published widths)
# ---------------------------------------------------------------------------

#: The spiking LMs trained, each with the name of its training path: at
#: published widths, fp32, each layer recomputed in the backward.
TRAIN_PHASES = {LM_ARCH: "lm_train", "mixtral-8x7b": "moe_train",
                RWKV_ARCH: "rwkv_train", HYBRID_ARCH: "hybrid_train",
                VLM_ARCH: "vlm_train"}
#: Depths cut for training, where AdamW's state would not fit the card:
#: ``mixtral-8x7b`` 2 of 32 layers (2.96 B parameters, 11.8 GB in fp32;
#: weights, gradients, m and v 47 GB), ``rwkv6-7b`` the deepest that
#: leaves 8 GB free beside the driver's state, a spare copy of the weights
#: and the activations (``rwkv_train``'s ``free_bytes``). ``pixtral-12b``'s
#: depth is the dry run's choice in this run: the ``vlm`` phase sets it
#: from ``vlm_depth_child`` before it trains.
TRAIN_LAYERS = {"mixtral-8x7b": 2, RWKV_ARCH: 13}
#: Timed steps of the families beside qwen3-0.6b, after one warm-up, under
#: ``cuda-full`` only.
FAMILY_TRAIN_STEPS = 2
#: The hybrid trains at an SSD chunk of 16, the largest power of two at
#: which its step-0 gradient is finite on the training batch: at the
#: published 128 the reference's own gradient is not finite at init
#: (ROADMAP C6), and its non-finite guard skips every step, as the phase
#: shows first; at 64 and 32 the masked ``exp`` still overflows in some
#: layers (the phase counts the overflowing entries at each chunk).
HYBRID_TRAIN_CHUNK = 16
#: The chunks at which the hybrid phase counts the overflowing masked SSD
#: entries of the training batch (measured, not held).
SSD_PROBE_CHUNKS = (128, 64, 32, 16)
#: Memory the rwkv training step must leave free on the card.
FREE_BYTES_MIN = 8e9


def lm_train_config(policy: str, arch: str = LM_ARCH,
                    chunk: int | None = None,
                    dtype: torch.dtype = torch.float32):
    """``lm_config(policy, arch, dtype)`` (the audio family never reads its
    LIF) at its training depth (``TRAIN_LAYERS``); ``chunk`` sets the
    hybrid's SSD chunk."""
    cfg = lm_config(policy, arch, dtype)
    if arch in TRAIN_LAYERS:
        cfg = cfg.replace(num_layers=TRAIN_LAYERS[arch])
    if chunk is not None:
        cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=chunk))
    return cfg


def lm_train_expected(steps: int, arch: str = LM_ARCH,
                      policy: str = "cuda-full") -> dict[str, int]:
    """Per step, ``lif_soma_fwd`` once a layer in the forward and once more
    when ``torch.utils.checkpoint`` recomputes the layer (``remat``; the
    hybrid recomputes each group, its Mamba2 layers once each), and
    ``lif_soma_bwd`` once a layer; no other kernel (the LMs' products are
    dense ``torch.matmul``); none under ``eager``."""
    layers = lm_train_config(policy, arch).num_layers \
        if policy == "cuda-full" else 0
    counts = dict.fromkeys(COUNTED, 0)
    counts["lif_soma_fwd"] = 2 * layers * steps
    counts["lif_soma_bwd"] = layers * steps
    return counts


def lm_train_batch(cfg, seed: int) -> dict[str, torch.Tensor]:
    """The driver's first batch: ``SyntheticLM``'s batch 0 on the card;
    for the vlm stub with image patches (``vlm_patches``)."""
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=LM_TRAIN_SEQ,
                   global_batch=LM_TRAIN_BATCH, seed=seed)).batch(0).items()}
    if cfg.vlm_stub:
        batch.update(vlm_patches(cfg, batch["tokens"].shape, seed))
    return batch


def vlm_patches(cfg, shape, seed: int) -> dict[str, torch.Tensor]:
    """Image patches for a (B, S) token batch of the vlm stub, drawn from
    ``seed`` on the card: ``patch_embeds`` N(0, 1) in the model's dtype and
    a ``patch_mask`` true at about ``VLM_PATCH_RATE`` of the positions (the
    driver's batches carry zero patches under an all-false mask, which
    never run the merge)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 7)
    return {"patch_embeds": torch.randn((*shape, cfg.d_model), generator=gen,
                                        device=DEVICE).to(cfg.dtype),
            "patch_mask": torch.rand(shape, generator=gen, device=DEVICE)
            < VLM_PATCH_RATE}


def grad_diff(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Two gradient leaves: bit-equal, relative L2 over the elements
    finite in both, and the non-finite elements (count, same places)."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    nonfinite = int((~fa).sum())
    if nonfinite or not bool(fb.all()):
        a, b = (torch.where(fa & fb, x, torch.zeros_like(x)) for x in (a, b))
    a, b = a.float(), b.float()
    return {"bit_equal": torch.equal(a, b) and torch.equal(fa, fb),
            "rel_l2": float((a - b).norm() / b.norm().clamp_min(1e-30)),
            "scaled_max": float((a - b).abs().max()
                                / b.abs().max().clamp_min(1.0)),
            "nonfinite": nonfinite, "nonfinite_same": torch.equal(fa, fb)}


def lm_grad_check(params, seed: int, arch: str = LM_ARCH,
                  chunk: int | None = None,
                  dtype: torch.dtype = torch.float32) -> dict:
    """Step 0's loss and gradient, through the train step's own gradient
    function (``value_and_grad`` of ``lm_loss``), under ``cuda-full``
    and ``eager`` from the same weights on the driver's first batch: the
    loss bit-equal (the SOMA kernel equals the eager scan bit for bit, the
    products are the same calls), each gradient leaf bit-equal or within
    ``LM_GRAD_LIMIT`` relative L2 (over its finite elements), with its
    non-finite elements counted and placed. With the MoE, a second
    ``cuda-full`` gradient too: its relative L2 to the first, per leaf
    (the backward's index additions are atomic on the card), measured.
    ``dtype``: the model's (the bf16 phase's gradients are held by its
    caller, ``lm_bf16_train``)."""
    cfg = lm_train_config("cuda-full", arch, chunk, dtype)
    batch = lm_train_batch(cfg, seed)
    (loss_c, metrics_c), grads_c = value_and_grad(lm_loss, params, batch,
                                                   cfg)
    rerun = None
    if cfg.moe is not None:
        grads_r = value_and_grad(lm_loss, params, batch, cfg)[1]
        rerun = {name: grad_diff(a, b) for name, a, b in zip(
            tree_paths(grads_c), tree_leaves(grads_r), tree_leaves(grads_c))}
        del grads_r
    (loss_e, _), grads_e = value_and_grad(
        lm_loss, params, batch, lm_train_config("eager", arch, chunk, dtype))
    torch.cuda.synchronize()
    per_leaf = {name: grad_diff(a, b) for name, a, b in zip(
        tree_paths(grads_c), tree_leaves(grads_c), tree_leaves(grads_e))}
    del grads_c, grads_e
    rows = per_leaf.values()
    out = {"loss_cuda_full": float(loss_c), "loss_eager": float(loss_e),
           "ce_loss_cuda_full": float(metrics_c["loss"]),
           "loss_bit_equal": torch.equal(loss_c, loss_e),
           "leaves": len(per_leaf),
           "bit_equal_leaves": sum(r["bit_equal"] for r in rows),
           "max_rel_l2": max(r["rel_l2"] for r in rows),
           "max_scaled_err": max(r["scaled_max"] for r in rows),
           "nonfinite_elements": sum(r["nonfinite"] for r in rows),
           "nonfinite_leaves": [n for n, r in per_leaf.items()
                                if r["nonfinite"]],
           "nonfinite_same_places": all(r["nonfinite_same"] for r in rows),
           "per_leaf": per_leaf,
           "tolerance": f"loss bitwise; each gradient leaf bitwise or "
                        f"relative L2 <= {LM_GRAD_LIMIT} over its finite "
                        f"elements; non-finite elements at the same places"}
    if rerun is not None:
        out["cuda_full_rerun"] = {
            "bit_equal_leaves": sum(r["bit_equal"] for r in rerun.values()),
            "max_rel_l2": max(r["rel_l2"] for r in rerun.values()),
            "rel_l2_per_leaf": {n: r["rel_l2"] for n, r in rerun.items()},
            "held": False}
    return out


def lm_train_run(cfg, seed: int, steps: int = LM_TRAIN_STEPS,
                 ckpt_dir: str | None = None, mesh=None,
                 compress_grads: bool = False) -> dict:
    """``repro_torch.launch.train.train`` of ``cfg``: 1 + ``steps`` steps
    from ``seed``'s weights (or those of the checkpoint in ``ckpt_dir``)
    on ``SyntheticLM`` (the driver's log lines go to stderr). Every step's metrics, the timed steps' wall times (host
    clock between the driver's calls of ``on_step``, each made once the
    step's loss is on the host, which waits for the whole step), the peak
    memory, the memory left free at the peak, and the launch counts of the
    whole run."""
    rows, stamps = [], []

    def on_step(step, m):
        stamps.append(time.perf_counter())
        rows.append({k: float(m[k]) for k in
                     ("loss", "grad_norm", "nonfinite", "lr", "err_norm")
                     if k in m})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()                    # the path starts here
    with contextlib.redirect_stdout(sys.stderr):
        params, history = train(
            cfg, steps=1 + steps, global_batch=LM_TRAIN_BATCH,
            seq_len=LM_TRAIN_SEQ, seed=seed, device=DEVICE, on_step=on_step,
            ckpt_dir=ckpt_dir, mesh=mesh, compress_grads=compress_grads)
    torch.cuda.synchronize()
    counts = launch_counts()                 # ... and ends here
    ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    median = sorted(ms)[len(ms) // 2]
    peak = torch.cuda.max_memory_allocated()
    return {"params": params, "history": history, "steps": rows,
            "counts": counts, "ms_per_step": ms, "ms_per_step_median": median,
            "tokens_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ / median * 1e3,
            "peak_memory_bytes": peak,
            "free_bytes": torch.cuda.get_device_properties(0).total_memory
            - peak}


def moved_leaves(run: dict, params) -> int:
    """The parameter leaves a run's final state holds with other bits than
    ``params``, its initial weights (the others, by name, go to the run's
    ``unmoved``; ``params`` may be a host copy); drops the run's state."""
    final = run.pop("params")
    run["unmoved"] = [n for n, a, b in zip(tree_paths(params),
                                           tree_leaves(final),
                                           tree_leaves(params))
                      if torch.equal(a.to(b.device).view(torch.int32),
                                     b.view(torch.int32))]
    return len(tree_leaves(params)) - len(run["unmoved"])


def check_train_run(pre: str, run: dict, leaves: int, steps: int,
                    want: dict[str, int], skipped: bool = False) -> None:
    """Every step finite (or, with ``skipped``, every step skipped by the
    non-finite guard), every parameter leaf moved (or none), the launches
    ``want``."""
    bad = [r for r in run["steps"] if not all(map(math.isfinite, (
        r["loss"], r["lr"]))) or r["nonfinite"] != float(skipped)
        or not (skipped or math.isfinite(r["grad_norm"]))]
    if bad:
        fail(f"{pre}: steps {bad} (want every step "
             f"{'skipped' if skipped else 'finite'})")
    if run["moved_leaves"] != (0 if skipped else leaves):
        fail(f"{pre}: {run['moved_leaves']} of {leaves} parameter leaves "
             f"moved (unmoved: {run['unmoved']})")
    if run["counts"] != want:
        fail(f"{pre} launch counts {run['counts']} for {steps} steps, want "
             f"{want}")


def check_grads(pre: str, grads: dict, nonfinite: bool = False) -> None:
    """Step 0's loss bit-equal between the policies, each gradient leaf
    within ``LM_GRAD_LIMIT``; the non-finite elements at the same places,
    and (``nonfinite``) some, or (else) none."""
    if not grads["loss_bit_equal"]:
        fail(f"{pre}: step-0 loss differs between cuda-full and eager "
             f"({grads['loss_cuda_full']!r} vs {grads['loss_eager']!r})")
    if grads["max_rel_l2"] > LM_GRAD_LIMIT:
        fail(f"{pre}: a gradient leaf differs by {grads['max_rel_l2']} "
             f"relative L2 > {LM_GRAD_LIMIT}")
    if not grads["nonfinite_same_places"] or \
            bool(grads["nonfinite_elements"]) != nonfinite:
        fail(f"{pre}: {grads['nonfinite_elements']} non-finite gradient "
             f"elements in {grads['nonfinite_leaves']} (same places under "
             f"both policies: {grads['nonfinite_same_places']}; want "
             f"{'some' if nonfinite else 'none'})")


def lm_train_phase(seed: int, arch: str = LM_ARCH,
                   smi: str | None = None) -> dict[str, dict[str, int]]:
    """A spiking LM's training path at published widths (the depth of
    ``lm_train_config``): step 0's gradient under both policies
    (``lm_grad_check``), then training steps through the driver's
    ``train()`` from the same ``seed`` weights: ``qwen3-0.6b`` 1 +
    LM_TRAIN_STEPS under ``cuda-full`` and under ``eager``, the other
    families 1 + FAMILY_TRAIN_STEPS under ``cuda-full``. Checks: the step-0
    loss bit-equal, the gradient leaves as ``lm_grad_check`` holds them, no
    step non-finite, every parameter leaf moved, the launches per step.
    The hybrid runs first at its published chunk of 128 (ROADMAP C6): the
    gradients non-finite at the same elements under both policies, every
    step skipped by the guard and every leaf bit-unchanged; then at
    ``HYBRID_TRAIN_CHUNK``. Returns the launch counts of each ``cuda-full``
    run, by path."""
    pre = TRAIN_PHASES[arch]
    cfg = lm_train_config("cuda-full", arch)
    steps = LM_TRAIN_STEPS if arch == LM_ARCH else FAMILY_TRAIN_STEPS
    # the initial weights: the driver draws the same from ``seed``
    params = build_state(cfg, seed=seed, device=DEVICE)[0]
    leaves = len(tree_leaves(params))
    toks = lm_train_batch(cfg, seed)["tokens"]
    paths, line = {}, {}
    chunks = [None] if cfg.ssm is None else [cfg.ssm.chunk,
                                             HYBRID_TRAIN_CHUNK]
    for chunk in chunks:
        # C6: the hybrid at its published chunk, every step skipped
        c6 = chunk is not None and chunk == cfg.ssm.chunk
        tag = "" if chunk is None else f"chunk{chunk}"
        grads = lm_grad_check(params, seed, arch, chunk)
        torch.cuda.empty_cache()
        check_grads(f"{pre} {tag}", grads, nonfinite=c6)
        runs = {}
        for policy in ("cuda-full", "eager") if arch == LM_ARCH else \
                ("cuda-full",):
            run = lm_train_run(lm_train_config(policy, arch, chunk), seed,
                               steps)
            run["moved_leaves"] = moved_leaves(run, params)
            torch.cuda.empty_cache()
            check_train_run(f"{pre} {tag} {policy}", run, leaves, 1 + steps,
                            lm_train_expected(1 + steps, arch, policy),
                            skipped=c6)
            run["step0_loss_equals_grad_check"] = \
                run["history"][0] == grads["ce_loss_cuda_full"]
            runs[policy] = {k: v for k, v in run.items() if k != "history"}
        if arch == LM_ARCH and runs["cuda-full"]["steps"][0]["loss"] != \
                runs["eager"]["steps"][0]["loss"]:
            fail(f"{pre}: step-0 loss differs between the policies' runs")
        line[tag or "run"] = {"step0": grads, **{
            p.replace("-", "_"): r for p, r in runs.items()}}
        paths[f"{pre}_{tag}" if c6 else pre] = runs["cuda-full"]["counts"]
    emit(pre, arch=f"{arch}@cuda-full", layers=cfg.num_layers,
         published_layers=get_config(arch).num_layers, d_model=cfg.d_model,
         vocab=cfg.vocab_size, dtype="float32", remat=cfg.remat,
         parameters=sum(a.numel() for a in tree_leaves(params)),
         bytes=nbytes(*tree_leaves(params)), batch=LM_TRAIN_BATCH,
         seq=LM_TRAIN_SEQ, tokens_per_step=LM_TRAIN_BATCH * LM_TRAIN_SEQ,
         steps=f"1 warm-up + {steps} timed", data="SyntheticLM",
         optimizer="the driver's: lr 3e-4, warm-up max(steps // 20, 5), "
                   "weight decay 0.1, clip 1.0; state updated in place",
         parameter_leaves=leaves,
         launches_per_step=lm_train_expected(1, arch),
         times="host clock from one step's loss on the host to the next's, "
               "after the warm-up step",
         **({"ssd_chunks": {"published": cfg.ssm.chunk,
                            "trained": HYBRID_TRAIN_CHUNK},
             "ssd_masked_exp_overflows": {
                 c: ssd_overflows(params, toks, lm_train_config(
                     "cuda-full", arch, c)) for c in SSD_PROBE_CHUNKS}}
            if cfg.ssm is not None else {}),
         **(line if len(line) > 1 else line["run"]),
         **({"card": smi} if smi else {}))
    if arch == RWKV_ARCH and \
            line["run"]["cuda_full"]["free_bytes"] < FREE_BYTES_MIN:
        fail(f"{pre}: {line['run']['cuda_full']['free_bytes']} bytes free "
             f"at the peak, want >= {FREE_BYTES_MIN:.0f}")
    return paths


# ---------------------------------------------------------------------------
# Phase 8a: bf16. Each kernel's bf16 arm at the paths' shapes against its
# bf16 oracle, then the Spikingformer and the spiking LM at bf16
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
#: The bf16 wgmma kernel's entry in the ``kernels`` line (its launches:
#: the bf16 paths' spike matmuls that ran plan kernel 3, ``KernelTally``).
WGMMA_ENTRY = "spike_wgmma"
WGMMA_SOURCE = "src/repro_torch/kernels/csrc/spike_wgmma.cuh"
#: The bf16 heads kernel's entry (its launches: the bf16 paths' per-head
#: ``attn_qk`` products that ran plan kernel ``spike_matmul.HEADS``).
HEADS_ENTRY = "spike_heads"
HEADS_SOURCE = "src/repro_torch/kernels/csrc/spike_heads.cuh"
#: The same for the bf16 z pass of the train-mode neuron layer on the
#: wgmma mainloop (its launches: the bf16 training path's first passes on
#: plan kernel ``neuron_layer.Z_WGMMA``, forward and replay).
Z_WGMMA_ENTRY = "neuron_layer_z_wgmma"
Z_WGMMA_SOURCE = "src/repro_torch/kernels/csrc/neuron_layer.cu"
#: The same for the bf16 eval-mode neuron layer on the wgmma mainloop (its
#: launches: the bf16 serving path's packed eval calls, which
#: ``neuron_layer.eval_kernel`` sends to plan kernel ``EVAL_WGMMA``).
EVAL_WGMMA_ENTRY = "neuron_layer_eval_wgmma"
EVAL_WGMMA_SOURCE = "src/repro_torch/kernels/csrc/neuron_layer.cu"
#: The LM's step-0 gradient leaves at bf16 that are not bit-equal between
#: the policies: the kernel's eq. 12 rounds each operation in the order of
#: the recursion, autograd through the eager scan in its own order; held
#: at the reference's bf16 tolerance (tests/test_kernels.py), scale-aware.
LM_BF16_GRAD_LIMIT = 2e-2


def exact16(gen, shape, scale=64, span=4):
    """``analysis.contracts``' exact operands, k / scale with |k| <= span,
    in bf16: every fp32 sum of such weights under {0,1} inputs over the
    preset's contractions is exact too (|sum| <= 2,048 * 4 / 64)."""
    return contracts._exact(gen, shape, DEVICE, scale, span).to(BF16)


def bf16_row(case, shape, call, operands, moved, flops, *, plain,
             tc=False, library=None, lif=None, **checks) -> dict:
    """A bf16 kernel case: its checks, then the wrapper's ms, its device
    ms with the L2 cold and warm (``cold_warm``), the plain version's and
    the library call's ms, and the bound at bf16: the bytes the call moves
    (2-byte operands) over the memory rate, or its operations over fp32's
    rate (elementwise) or one bf16 tensor-core pass (``tc``: 2MCK over
    989 TFLOP/s). ``lif``: the LIF kernel whose serial chain bounds it
    too (``lif_bound``)."""
    row = {"case": case, "dtype": "bfloat16", "shape": shape, **checks,
           "ms": time_ms(lambda: call(*operands)),
           **cold_warm(call, operands, moved),
           "plain_ms": time_ms(lambda: plain(*operands)),
           "library_ms": time_ms(library) if library else None}
    if lif is not None:
        row.update(lif_bound(lif, shape[0], moved, flops))
    else:
        b_ms = moved / HBM_BYTES_PER_S * 1e3
        o_ms = flops / (BF16_FLOPS if tc else FP32_FLOPS) * 1e3
        row.update(bound_ms=max(b_ms, o_ms),
                   bound_by="bytes" if b_ms >= o_ms else "operations")
    return row


def all_equal(got, want) -> bool:
    return all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(got, want))


def bf16_lif_cases(gen, batch: int, shapes=None) -> dict[str, list[dict]]:
    """``lif_soma_fwd`` / ``_bwd`` at bf16: S, U, mask (and the carried
    state) and dx bit-equal to the plain version and to the oracle, at the
    Spikingformer's (4, 196 * B, 512), the LM's decode (1, 8, 1024) from a
    carried state and training view (128, 8, 1024), and a ring call whose
    columns a thread copies alone (D % 32 != 0: the bf16 ring's plain
    loads); the backward also with the carry's cotangent. ``shapes`` (case,
    T, M, D, layout, carry, backward) replaces those cases: a case with
    ``backward`` runs the backward too (a carried one never does)."""
    cfg = get_spikingformer_config(PRESET)
    t, d, m = cfg.time_steps, cfg.d_model, batch * cfg.num_tokens
    lm_d = get_config(LM_ARCH).d_model
    fwd, bwd = [], []
    shapes = shapes or [
        ("pssa.lif/smlp.lif", t, m, d, "dense", False, True),
        ("lm.ffn.lif decode", 1, LM_SLOTS, lm_d, "dense", True, False),
        ("lm.ffn.lif train", LM_TRAIN_SEQ, LM_TRAIN_BATCH, lm_d, "lm",
         False, True),
        ("ring, a column a thread", 70, 8, 200, "dense", False, True)]
    for case, tt, mm, dd, layout, carry, backward in shapes:
        x = lif_input(gen, tt, mm, dd, layout).to(BF16)
        state = ((torch.randn((mm, dd), generator=gen, device=DEVICE) * 0.7
                  + 0.5).to(BF16), spikes(gen, (mm, dd), 0.4).to(BF16)) \
            if carry else ()
        got = lif_soma.lif_soma_fwd(x, *state)
        plain = lif_soma.lif_soma_fwd_plain(x, *state)
        oracle = plain if carry else kref.lif_soma_fwd_ref(x)
        torch.cuda.synchronize()
        if not (all_equal(got, plain) and all_equal(got[:3], oracle[:3])
                and got[0].dtype == BF16 and got[0].stride() == x.stride()):
            fail(f"bf16 lif_soma_fwd ({case}) differs from its plain version "
                 f"or its oracle")
        fwd.append(bf16_row(
            case, [tt, mm, dd], lif_soma.lif_soma_fwd, (x, *state),
            nbytes(x, *state, *got), 6.0 * x.numel(),
            plain=lif_soma.lif_soma_fwd_plain, lif="lif_soma_fwd",
            layout=layout, carry=carry,
            arm=lif_soma.choose_arm(tt, mm * dd, x.is_contiguous(), carry),
            bitwise_plain=True, bitwise_oracle=True, max_abs_err=0.0,
            tolerance="bitwise on S, U and mask (and u_last, s_last) against "
                      "the plain version and kernels/ref.py"))
        if carry or not backward:
            continue
        s, u, mask = plain
        g = torch.empty_like(u).copy_(torch.randn((tt, mm, dd), generator=gen,
                                                  device=DEVICE))
        gu = torch.randn((mm, dd), generator=gen, device=DEVICE).to(BF16)
        for name, gl in ((case, None), (f"{case}, carry (gu_last)", gu)):
            ins = (g, u, s, mask, gl)
            got_b = lif_soma.lif_soma_bwd(*ins)
            want = lif_soma.lif_soma_bwd_plain(*ins)
            ora = kref.lif_soma_bwd_ref(g, u, s, mask) if gl is None else \
                kref.lif_soma_bwd_carry_ref(g, u, s, mask, gl)
            torch.cuda.synchronize()
            if not (torch.equal(got_b, want) and torch.equal(got_b, ora)
                    and got_b.dtype == BF16):
                fail(f"bf16 lif_soma_bwd ({name}) differs from its plain "
                     f"version or its oracle")
            bwd.append(bf16_row(
                name, [tt, mm, dd], lif_soma.lif_soma_bwd, ins,
                nbytes(*(a for a in ins if a is not None), got_b),
                7.0 * x.numel(), plain=lif_soma.lif_soma_bwd_plain,
                lif="lif_soma_bwd", layout=layout,
                arm=lif_soma.choose_arm(tt, mm * dd, g.is_contiguous()),
                bitwise_plain=True, bitwise_oracle=True, max_abs_err=0.0,
                tolerance="bitwise against the plain version and "
                          "kernels/ref.py"))
    return {"lif_soma_fwd": fwd, "lif_soma_bwd": bwd}


def host_us(call, reps: int = 21) -> float:
    """Host microseconds of one ``call()``, the median of ``reps``: the
    stream held by a sleeping kernel, so that the clock sees the enqueue
    alone (a wrapper's checks, its rule, the plan, the tensor maps and the
    launch)."""
    call()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return sorted(times)[reps // 2] * 1e6


def plan_kernels(fn, *args, **kw) -> list[int]:
    """The plan kernel codes of ``fn(*args, **kw)`` (one per launch), read
    from the library's plan exports: nothing launched, no count moved. The
    spike pack's launch, which a packed call makes first (its record
    carries the pack's path code), is left out."""
    with build.plan_launches() as calls:
        fn(*args, **kw)
    return [launch.kernel for call in calls if call.entry != "e2a_spike_pack"
            for launch in call.launches]


class KernelTally:
    """Inside the block, the kernel each launch of a wrapper family runs,
    counted by plan kernel code through the rule its wrappers call once a
    launch and whose code they pass to the C entry point, which launches
    that kernel or refuses the call: by default
    ``spike_matmul.resolve_tile`` (1 Large, 2 Small, 3 the bf16 wgmma
    kernel, 4 the bf16 heads kernel); ``KernelTally(neuron_layer,
    "z_kernel")`` the neuron layer's first pass (forward, split sums and
    replay: 3 dense, 4 ``mma.sync``, 9
    the bf16 wgmma kernel); ``KernelTally(neuron_layer, "eval_kernel")``
    the packed eval calls' tile codes (0 the ``mma.sync`` tile the entry
    point picks, 3 the bf16 wgmma kernel). ``counts`` maps a code to its
    launches."""

    def __init__(self, module=spike_matmul, rule: str = "resolve_tile"):
        self.module, self.rule = module, rule
        self.counts: dict[int, int] = {}

    def __enter__(self):
        real = self._real = getattr(self.module, self.rule)

        def spy(*args, **kw):
            code = real(*args, **kw)
            self.counts[code] = self.counts.get(code, 0) + 1
            return code
        setattr(self.module, self.rule, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.rule, self._real)
        return False


def digest(t: torch.Tensor) -> str:
    """The first 16 hex digits of the SHA-256 of ``t``'s bytes: two runs'
    outputs compared without keeping them."""
    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu()
                          .numpy().tobytes()).hexdigest()[:16]


def bf16_matmul_row(case, packed, w, fn, shared_w: bool = False) -> dict:
    """The spike matmul at bf16 on ``exact16`` weights: every fp32 sum is
    exact, so the kernel's one rounding to bf16 gives the oracle's bits
    (``kernels/ref.py``: unpacked spikes times the weight in fp32, rounded
    to the weight's dtype). The same operands with Gaussian weights: within
    one bf16 rounding of the oracle (the fp32 sums in another order may
    round across a bf16 boundary), measured as ``bitwise_gaussian``.
    ``kernel``: the plan kernel the wrapper's rule launched (3: the wgmma
    kernel, ``csrc/spike_wgmma.cuh``; 4: the heads kernel,
    ``csrc/spike_heads.cuh``); where it is 3, the one-plane mainloop
    forced (tile 1) is checked and timed on the same operands beside it
    (``tile1_*``), where it is 4 the Small tile forced (tile 2, the rule's
    choice before the heads kernel; ``tile2_*``). The library yardstick is
    ``torch.matmul`` on the unpacked bf16 spikes and ``w`` as it lies;
    beside the heads kernel also ``torch.bmm`` on a contiguous copy of
    ``w`` (the copy not timed), and ``library_*`` is the faster of the two
    (``library_call``), device cold."""
    dense = spike_matmul.spike_unpack(packed, torch.float32)
    got = fn(packed, w)
    want = torch.matmul(dense, w.float()).to(BF16)
    torch.cuda.synchronize()
    if got.dtype != BF16 or not torch.equal(got, want):
        fail(f"bf16 spike matmul {case}: differs from its oracle on exact "
             f"weights (must be bitwise)")
    wg = (torch.randn(w.shape, generator=torch.Generator(
        device=DEVICE).manual_seed(3), device=DEVICE)
        * w.shape[-2] ** -0.5).to(BF16)
    wg = wg.as_strided(w.shape, w.stride()) if shared_w or \
        not w.is_contiguous() else wg
    got_g = fn(packed, wg)
    want_g = torch.matmul(dense, wg.float()).to(BF16)
    err = (got_g.float() - want_g.float()).abs()
    if not bool((err <= 1e-4 + contracts.BF16_RTOL
                 * want_g.float().abs()).all()):
        fail(f"bf16 spike matmul {case}: Gaussian weights beyond one bf16 "
             f"rounding of the oracle ({float(err.max())})")
    kernels = plan_kernels(fn, packed, w)
    wgmma = getattr(spike_matmul, "WGMMA", 3)   # 3 in a checkout without it
    c, k = w.shape[-2:]
    w_bytes = nbytes(w) // (w.shape[0] if shared_w else 1)
    moved = nbytes(packed, got) + w_bytes
    dense16 = dense.to(BF16)
    lib = cold_warm(torch.matmul, (dense16, w), moved)
    library = functools.partial(torch.matmul, dense16, w)
    extra = {"library_device_ms": lib["device_ms"],
             "library_device_ms_l2_warm": lib["device_ms_l2_warm"],
             "host_us": host_us(lambda: fn(packed, w))}
    heads = getattr(spike_matmul, "HEADS", 4)   # 4 in a checkout without it
    if kernels == [heads]:
        g = math.prod(w.shape[:-2])
        d3 = dense16.reshape(g, *dense16.shape[-2:])
        w3 = w.contiguous().reshape(g, c, k)
        lib_c = cold_warm(torch.bmm, (d3, w3), moved)
        extra.update(library_view_device_ms=lib["device_ms"],
                     library_contiguous_device_ms=lib_c["device_ms"],
                     library_call="torch.matmul on the view")
        if lib_c["device_ms"] < lib["device_ms"]:
            library = functools.partial(torch.bmm, d3, w3)
            extra.update(library_device_ms=lib_c["device_ms"],
                         library_device_ms_l2_warm=lib_c[
                             "device_ms_l2_warm"],
                         library_call="torch.bmm on a contiguous k^T")
        small = functools.partial(fn, tile=2)
        if not torch.equal(small(packed, w), want):
            fail(f"bf16 spike matmul {case}: tile 2 differs from the oracle "
                 f"on exact weights")
        times = cold_warm(small, (packed, w), moved)
        extra.update({
            "tile2_ms": time_ms(lambda: small(packed, w)),
            "tile2_device_ms": times["device_ms"],
            "tile2_device_ms_l2_warm": times["device_ms_l2_warm"],
            "tile2_host_us": host_us(lambda: small(packed, w)),
            "tile2_bitwise": True,
            "tile2_bitwise_gaussian": torch.equal(small(packed, wg), got_g)})
    if kernels == [wgmma]:
        old = functools.partial(fn, tile=1)
        if not torch.equal(old(packed, w), want):
            fail(f"bf16 spike matmul {case}: tile 1 differs from the oracle "
                 f"on exact weights")
        times = cold_warm(old, (packed, w), moved)
        extra.update({
            "tile1_ms": time_ms(lambda: old(packed, w)),
            "tile1_device_ms": times["device_ms"],
            "tile1_device_ms_l2_warm": times["device_ms_l2_warm"],
            "tile1_host_us": host_us(lambda: old(packed, w)),
            "tile1_bitwise_gaussian": torch.equal(old(packed, wg), want_g)})
    return bf16_row(
        case, {"packed": list(packed.shape), "w": list(w.shape),
               "w_stride": list(w.stride())}, fn,
        (packed, w), moved, 2.0 * got.numel() * c, tc=True,
        plain=spike_matmul.spike_matmul_packed_plain, library=library,
        kernel=kernels[0], **extra, digest_gaussian=digest(got_g),
        bitwise_oracle=True, bitwise_gaussian=torch.equal(got_g, want_g),
        max_abs_err=float(err.max()),
        tolerance="bitwise on exact weights (k/64, |k| <= 4); Gaussian "
                  "weights within one bf16 rounding (2^-7 relative)")


def bf16_matmul_cases(gen, batch: int,
                      require_wgmma: bool = True) -> dict[str, list[dict]]:
    """The spike matmul's main-path sites at bf16: pssa.proj and smlp.b,
    attn_qk on per-head views with K^T strided, and the tokenizer's shared
    weight (zero batch stride); then a ragged product (M, K and C no
    multiple of a tile: 12,581 x 520 x 520) and a K^T view at M > 512, both
    on the wgmma kernel. Every row names the plan kernel it ran; with
    ``require_wgmma`` each must be the rule's (3 for all but attn_qk's
    per-head products, which take the heads kernel, ``spike_matmul.
    HEADS``, or in a checkout without it the Small tile).
    ``benchmarks/torch/bench_spike_matmul.py --bf16`` runs the cases
    without it for a checkout that has no wgmma kernel."""
    cfg = get_spikingformer_config(PRESET)
    t, d, f, h = cfg.time_steps, cfg.d_model, cfg.d_ff, cfg.n_heads
    n, dh = cfg.num_tokens, cfg.d_model // cfg.n_heads
    m = batch * n
    mm, bmm = (spike_matmul.spike_matmul_packed,
               spike_matmul.spike_matmul_packed_batched)
    rows_2d = [bf16_matmul_row(site, spike_matmul.spike_pack(
        spikes(gen, (t * m, c))), exact16(gen, (c, d)), mm)
        for site, c in (("pssa.proj", d), ("smlp.b", f))]

    def heads(a):
        return a.view(t * batch, n, h, dh).permute(0, 2, 1, 3)

    q = spikes(gen, (t * batch, n, d))
    k16 = spikes(gen, (t * batch, n, d)).to(BF16)
    rows_b = [bf16_matmul_row("attn_qk", spike_matmul.spike_pack(heads(q)),
                              heads(k16).transpose(-1, -2), bmm)]
    c3 = 9 * (d // 2)
    w3 = exact16(gen, (c3, d)).unsqueeze(0).expand(t, c3, d)
    rows_b.append(bf16_matmul_row(
        "tokenizer.conv.3(shared w)",
        spike_matmul.spike_pack(spikes(gen, (t, m, c3))), w3, bmm,
        shared_w=True))
    mr = t * m + 37
    rows_2d.append(bf16_matmul_row(
        "ragged M/K/C (12581 x 520 x 520)",
        spike_matmul.spike_pack(spikes(gen, (mr, 520))),
        exact16(gen, (520, 520)), mm))
    rows_2d.append(bf16_matmul_row(
        "K^T view (M = T*B*N)", spike_matmul.spike_pack(spikes(gen,
                                                               (t * m, d))),
        exact16(gen, (d, d)).t(), mm))
    want = {"attn_qk": getattr(spike_matmul, "HEADS", 2)}
    for row in rows_2d + rows_b if require_wgmma else ():
        if row["kernel"] != want.get(row["case"], spike_matmul.WGMMA):
            fail(f"bf16 spike matmul {row['case']}: the rule launched plan "
                 f"kernel {row['kernel']}, not "
                 f"{want.get(row['case'], spike_matmul.WGMMA)}")
    return {"spike_matmul_packed": rows_2d,
            "spike_matmul_packed_batched": rows_b}


def bf16_bn_cases(gen, batch: int) -> dict[str, list[dict]]:
    """BN at bf16: the forward at the blocks' (12,544, 512) and (12,544,
    2,048) on exact inputs (k/16: every sum exact) bit-equal to the oracle
    and on Gaussian ones within one bf16 rounding of y; the backward at the
    five distinct shapes of a step (``bn_bwd_shapes``): on dyadic inputs
    (every column sum exact) dx, dgamma and dbeta equal to the plain
    version's bit for bit (``bitwise_dyadic``, held), on Gaussian ones dx
    within one bf16 rounding and dgamma and dbeta within 1e-5 of their
    scale (its sums of mi are not exact). ``kernels``: the plan kernels of
    its two passes. ``library_ms``: ``F.batch_norm`` and ATen's batch-norm
    backward on the same bf16 operands, the backward's also device cold
    and warm (``library_device_ms``) beside the kernel's
    (``at_or_below_library``: the kernel's device time, cold, at most
    ATen's)."""
    cfg = get_spikingformer_config(PRESET)
    m = cfg.time_steps * batch * cfg.num_tokens
    fwd, bwd = [], []
    for d in (cfg.d_model, cfg.d_ff):
        gamma = torch.rand((d,), generator=gen, device=DEVICE) + 0.5
        beta = torch.randn((d,), generator=gen, device=DEVICE) * 0.3
        x = exact16(gen, (m, d), 16, 48)
        got = fused_bn.bn_fwd(x, gamma, beta)
        want = kref.bn_fwd_ref(x, gamma, beta)
        xg = (torch.randn((m, d), generator=gen, device=DEVICE) * 2.0
              + 0.5).to(BF16)
        got_g = fused_bn.bn_fwd(xg, gamma, beta)
        want_g = kref.bn_fwd_ref(xg, gamma, beta)
        torch.cuda.synchronize()
        err = (got_g[0].float() - want_g[0].float()).abs()
        stats = max(rel_err(got_g[1], want_g[1]), rel_err(got_g[2], want_g[2]))
        if not all_equal(got, want) or not bool(
                (err <= 1e-5 + contracts.BF16_RTOL
                 * want_g[0].float().abs()).all()) or stats > 1e-6:
            fail(f"bf16 bn_fwd {m}x{d}: exact inputs bitwise "
                 f"{all_equal(got, want)}, Gaussian y error "
                 f"{float(err.max())}, statistics {stats}")
        fwd.append(bf16_row(
            "pssa.proj/smlp.b", [m, d], fused_bn.bn_fwd, (xg, gamma, beta),
            nbytes(xg, gamma, beta, *got_g), 8.0 * xg.numel(),
            plain=fused_bn.bn_fwd_plain,
            library=lambda: F.batch_norm(xg, None, None, gamma, beta,
                                         training=True, eps=1e-5),
            bitwise_oracle_exact=True, max_abs_err=float(err.max()),
            stats_rel_err=stats,
            tolerance="bitwise on exact inputs; y within one bf16 rounding "
                      "and mu, sqrt_d within 1e-6 of their scale on "
                      "Gaussian inputs"))
        del x, xg, got, got_g, want, want_g
    for rows, d in bn_bwd_shapes(batch):
        exact = [a.to(BF16) if i < 2 else a
                 for i, a in enumerate(dyadic_bn_bwd(gen, rows, d))]
        dyadic = all_equal(fused_bn.bn_bwd(*exact),
                           fused_bn.bn_bwd_plain(*exact))
        del exact
        gamma = torch.rand((d,), generator=gen, device=DEVICE) + 0.5
        x = (torch.randn((rows, d), generator=gen, device=DEVICE) * 2.0
             + 0.5).to(BF16)
        g = torch.randn((rows, d), generator=gen, device=DEVICE).to(BF16)
        _, mu, sd = kref.bn_fwd_ref(x, gamma, gamma)
        got = fused_bn.bn_bwd(g, x, gamma, mu, sd)
        want = kref.bn_bwd_ref(g, x, gamma, mu, sd)
        torch.cuda.synchronize()
        err = (got[0].float() - want[0].float()).abs()
        stats = max(rel_err(got[1], want[1]), rel_err(got[2], want[2]))
        if got[0].dtype != BF16 or stats > 1e-5 or not dyadic or not bool(
                (err <= 1e-5 + contracts.BF16_RTOL
                 * want[0].float().abs()).all()):
            fail(f"bf16 bn_bwd {rows}x{d}: dx error {float(err.max())}, "
                 f"dgamma/dbeta {stats}, bitwise on dyadic inputs {dyadic}")
        inv = (1.0 / sd).reshape(-1)
        ops_ = (g, x, gamma, mu, sd)
        moved = nbytes(*ops_, *got)

        def aten(g, x, gamma, mu, inv):
            return torch.ops.aten.native_batch_norm_backward(
                g, x, gamma, None, None, mu.reshape(-1), inv, True, 1e-5,
                [True, True, True])

        lib = cold_warm(aten, (g, x, gamma, mu, inv), moved)
        row = bf16_row(
            f"{rows}x{d}", [rows, d], fused_bn.bn_bwd, ops_, moved,
            12.0 * x.numel(), plain=fused_bn.bn_bwd_plain,
            library=lambda: aten(g, x, gamma, mu, inv),
            kernels=plan_kernels(fused_bn.bn_bwd, *ops_),
            library_device_ms=lib["device_ms"],
            library_device_ms_l2_warm=lib["device_ms_l2_warm"],
            bitwise_dyadic=dyadic, bitwise_oracle=torch.equal(got[0], want[0]),
            max_abs_err=float(err.max()), stats_rel_err=stats,
            tolerance="bitwise on dyadic inputs; dx within one bf16 rounding "
                      "(2^-7 relative, 1e-5 absolute), dgamma and dbeta "
                      "within 1e-5 of their scale")
        row["at_or_below_library"] = row["device_ms"] is not None and \
            lib["device_ms"] is not None and \
            row["device_ms"] <= lib["device_ms"]
        bwd.append(row)
        del g, x, got, want
        torch.cuda.empty_cache()
    return {"bn_fwd": fwd, "bn_bwd": bwd}


def nl_verdict(name: str, got, args, **lif) -> dict:
    """A neuron layer's spikes held against the oracle's membrane with the
    band of ``analysis.contracts.spike_verdict`` (the product's tolerance,
    and in train mode the statistics', carried to the threshold)."""
    y, tol = contracts._nl_current(name, args)
    return contracts.spike_verdict(got, y, tol, **lif)


def fp32_product_calls(a: torch.Tensor, b: torch.Tensor) -> dict:
    """The library calls that form the fp32 product of the bf16 matrices
    ``a`` and ``b`` on the tensor cores in one call, by name, each as
    ``(call, operands)``: bf16 operands with an fp32 result (``torch.mm``'s
    ``out_dtype``, where this torch has it) and TF32 on operands widened
    beforehand, allowed for that call alone (a bf16 holds 8 significant
    bits and TF32 11, so each product is exact and the sum is fp32's, as
    with TF32 off, which the setup keeps for the fp32 yardsticks)."""
    def tf32(a, b):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return torch.mm(a, b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def bf16_in(a, b):
        return torch.mm(a, b, out_dtype=torch.float32)
    calls = {"torch.mm fp32 operands, TF32": (tf32, (a.float(), b.float()))}
    try:
        bf16_in(a, b)
        calls["torch.mm bf16 operands, fp32 out"] = (bf16_in, (a, b))
    except (TypeError, RuntimeError, NotImplementedError):
        pass
    return calls


def z_pass_row(x, w, packed, gen, timed: bool = True) -> dict:
    """The train arm's first pass alone (``neuron_layer_train_z``, the
    kernel and bits of the forward's z) on the site's operands: its plan
    kernel (``z_kernel``), its bound (one bf16 tensor-core pass, 2 T*M*C*K
    over 989 TFLOP/s, or its bytes: the packed rows, the weight and z),
    and on Gaussian weights the largest distance of z from the fp32
    product (the same exact products summed in another order). With
    ``timed``, its times beside the plain version's and the library's:
    ``library_ms`` the faster of the tensor-core calls that form the same
    fp32 z from the unpacked spikes (``fp32_product_calls``, each in
    ``library_calls_ms``, the one taken in ``library_call``), that call's
    device ms cold and warm beside the kernel's."""
    t, m, c = x.shape
    k = w.shape[1]
    # the packed arm's input packed once, outside the timed call, as the
    # forward hands it to the replay
    xin = spike_matmul.spike_pack(x) if packed else x

    def call(xin, w):
        if packed:   # x gives the shape; the kernel reads xin
            return neuron_layer.neuron_layer_train_z(x, w, packed=True,
                                                     xin=xin)
        return neuron_layer.neuron_layer_train_z(xin, w)
    wg = (torch.randn((c, k), generator=gen, device=DEVICE) * 2.0
          * c ** -0.5).to(w.dtype)
    z = call(xin, wg)
    dense = x.float()
    z32 = torch.matmul(dense, wg.float())
    torch.cuda.synchronize()
    moved = nbytes(xin, w) + t * m * k * 4
    b_ms = moved / HBM_BYTES_PER_S * 1e3
    o_ms = 2.0 * t * m * c * k / BF16_FLOPS * 1e3
    row = {"z_kernel": plan_kernels(call, xin, w)[0],
           "bound_ms": max(b_ms, o_ms),
           "bound_by": "bytes" if b_ms >= o_ms else "operations",
           "max_abs_err": float((z - z32).abs().max())}
    del z, z32, dense
    if not timed:
        return row
    calls = fp32_product_calls(x.reshape(t * m, c), w)
    lib = {name: time_ms(lambda: fn(*ops)) for name, (fn, ops) in
           calls.items()}
    best = min(lib, key=lib.get)
    fn, ops = calls[best]
    lib_cw = cold_warm(fn, ops, nbytes(*ops) + t * m * k * 4)
    row.update(ms=time_ms(lambda: call(xin, w)),
               **cold_warm(call, (xin, w), moved),
               plain_ms=time_ms(
                   lambda: neuron_layer.neuron_layer_train_z_plain(x, w)),
               library_ms=lib[best], library_call=best,
               library_calls_ms=lib,
               library_device_ms=lib_cw["device_ms"],
               library_device_ms_l2_warm=lib_cw["device_ms_l2_warm"])
    del calls, ops
    return row


def bf16_neuron_layer_cases(gen, batch: int) -> dict[str, list[dict]]:
    """Both neuron layers at bf16 at the block sites (pssa.qkv, smlp.a)
    and the four tokenizer stages (the first dense, C = 27), on exact
    weights and inputs: spikes the oracle's outside the band
    (``nl_verdict``; with exact operands every z is exact and none may
    differ), the train statistics within 1e-5 of their scale, z of the
    first pass bit-equal to the fp32 product, and the backward's replay
    the emitted spikes. Each train row carries its first pass alone
    (``z_pass``, ``z_pass_row``, timed at the block sites); at the packed
    sites that pass must run on the wgmma kernel (plan kernel
    ``Z_WGMMA``). The eval rows at the packed sites must run on the wgmma
    eval kernel (plan kernel ``EVAL_WGMMA``) and give the plain version's
    spikes bit for bit (``bitwise_plain``); at the block sites they carry
    the kernel alone, the one-plane arm and the unfused yardstick on the
    same operands (``eval_wgmma_extra``)."""
    sites = neuron_layer_sites(batch)
    sites = sites[-2:] + sites[:4]
    train, ev = [], []
    for case, t, m, c, k, packed in sites:
        x = spikes(gen, (t, m, c)).to(BF16) if packed \
            else exact16(gen, (t, m, c), 16, 16)
        w = exact16(gen, (c, k))
        gamma = (torch.rand((k,), generator=gen, device=DEVICE) * 0.4
                 + 0.8).to(BF16)
        beta = (torch.randn((k,), generator=gen, device=DEVICE) * 0.2
                + 0.3).to(BF16)
        bias = torch.randn((k,), generator=gen, device=DEVICE) * 0.1 + 0.5
        args = (x, w, gamma, beta)
        got = neuron_layer.neuron_layer_train(*args, packed=packed)
        want = kref.neuron_layer_train_ref(*args)
        verdict = nl_verdict("neuron_layer_train", got[0], args)
        verdict["differing"] = int((got[0] != want[0]).sum())
        stats = max(rel_err(got[1], want[1]), rel_err(got[2], want[2]))
        z = neuron_layer.neuron_layer_train_z(x, w, packed=packed)
        z_equal = torch.equal(z, torch.einsum("tmc,ck->tmk", x.float(),
                                              w.float()))
        replay = replay_mismatch(x, w, gamma, beta, packed)
        if got[0].dtype != BF16 or verdict["wrong"] or stats > 1e-5 or \
                not z_equal or replay:
            fail(f"bf16 neuron_layer_train {case}: spikes {verdict}, "
                 f"statistics {stats}, z bitwise {z_equal}, replay {replay}")
        flops = 2.0 * t * m * c * k
        z_pass = z_pass_row(x, w, packed, gen,
                            timed=case in ("pssa.qkv", "smlp.a"))
        want_z = neuron_layer.Z_WGMMA if packed else neuron_layer.Z_DENSE
        if z_pass["z_kernel"] != want_z:
            fail(f"bf16 neuron_layer_train {case}: the z pass ran plan "
                 f"kernel {z_pass['z_kernel']}, not {want_z}")
        train.append(bf16_row(
            case, [t, m, c, k], functools.partial(
                neuron_layer.neuron_layer_train, packed=packed), args,
            nbytes(*args, *got), flops, tc=packed,
            plain=neuron_layer.neuron_layer_train_plain,
            arm="packed" if packed else "dense", spikes=verdict,
            stats_rel_err=stats, max_abs_err=stats, z_bitwise=z_equal,
            replay_mismatch=replay, z_pass=z_pass,
            tolerance="spikes the oracle's outside the band; mu, var within "
                      "1e-5 of their scale; z bitwise; replay bitwise"))
        eargs = (x, w, bias)
        call_e = functools.partial(neuron_layer.neuron_layer_eval,
                                   packed=packed)
        got_e = call_e(*eargs)
        want_e = kref.neuron_layer_eval_ref(*eargs)
        bitwise_e = torch.equal(got_e,
                                neuron_layer.neuron_layer_eval_plain(*eargs))
        v_e = nl_verdict("neuron_layer_eval", got_e, eargs)
        v_e["differing"] = int((got_e != want_e).sum())
        kernel_e = plan_kernels(call_e, *eargs)
        want_k = [neuron_layer.EVAL_WGMMA] if packed else [0]   # dense
        if got_e.dtype != BF16 or v_e["wrong"] or not bitwise_e or \
                kernel_e != want_k:
            fail(f"bf16 neuron_layer_eval {case}: spikes {v_e}, bitwise "
                 f"against the plain version {bitwise_e}, plan kernels "
                 f"{kernel_e}, not {want_k}")
        extra = eval_wgmma_extra(x, w, bias) \
            if case in ("pssa.qkv", "smlp.a") else {}
        ev.append(bf16_row(
            case, [t, m, c, k], call_e, eargs,
            nbytes(*eargs, got_e), flops, tc=packed,
            plain=neuron_layer.neuron_layer_eval_plain,
            arm="packed" if packed else "dense", kernel=kernel_e,
            spikes=v_e, bitwise_plain=bitwise_e, **extra,
            max_abs_err=float((got_e.float() - want_e.float()).abs().max()),
            tolerance="bitwise against the plain version (exact operands); "
                      "spikes the oracle's outside the band"))
        torch.cuda.empty_cache()
    return {"neuron_layer_train": train, "neuron_layer_eval": ev}


def eval_wgmma_extra(x, w, bias) -> dict:
    """Beside a bf16 eval case on the wgmma kernel, on the same operands:
    the device ms (L2 cold and warm) of the kernel alone on the packed
    input, of the one-plane ``mma.sync`` arm forced on it (tile 0, the
    entry point's own tile), and of the unfused path's yardstick
    (``unfused_yardstick``)."""
    t, m, c = x.shape
    k = w.shape[1]
    xin = spike_matmul.spike_pack(x)
    moved = nbytes(xin, w, bias) + t * m * k * 2

    def kernel(tile):
        return lambda xin, w, bias: neuron_layer._launch_neuron_layer_eval(
            xin, w, bias, t, m, c, k, True, 0.5, 1.0, tile=tile)
    return {"kernel_alone": cold_warm(
                kernel(neuron_layer.EVAL_TILE_WGMMA), (xin, w, bias), moved),
            "one_plane": cold_warm(kernel(0), (xin, w, bias), moved),
            **unfused_yardstick(x, w, bias)}


def unfused_yardstick(x, w, bias) -> dict:
    """The bf16 eval neuron layer's unfused path on its operands, which no
    single library call replaces, device ms with the L2 cold and warm:
    cuBLAS's bf16 GEMM with an fp32 result on the unpacked spikes
    (``torch.mm(out_dtype=torch.float32)``; nothing where this torch lacks
    it) and the bf16 LIF (``lif_soma_fwd``, the arm its rule picks) on the
    (T, M, K) current, and ``yardstick_device_ms``, their cold sum."""
    t, m, c = x.shape
    k = w.shape[1]
    name = "torch.mm bf16 operands, fp32 out"
    calls = fp32_product_calls(x.reshape(t * m, c), w)
    if name not in calls:
        return {}
    fn, ops = calls[name]
    mm = {"call": name, **cold_warm(fn, ops, nbytes(*ops) + t * m * k * 4)}
    cur = (fn(*ops) + bias).to(BF16).reshape(t, m, k)
    lif = {"arm": lif_soma.choose_arm(t, m * k, True),
           **cold_warm(lif_soma.lif_soma_fwd, (cur,), 4 * cur.numel() * 2)}
    return {"yardstick_mm": mm, "yardstick_lif": lif,
            "yardstick_device_ms": mm["device_ms"] + lif["device_ms"]}


def bf16_kernel_phase(seed: int, batch: int) -> dict[str, list[dict]]:
    """Every kernel's bf16 arm at the main paths' shapes (batch 16 of
    ``spikingformer-8-512``, the LM's (128, 8, 1024) and decode), held
    against its bf16 oracle (``kernels/ref.py``) and timed as the fp32
    cases are."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 32)
    cases = {PACK_ENTRY: pack_cases(gen, batch, BF16)}
    for part in (bf16_lif_cases, bf16_matmul_cases, bf16_bn_cases,
                 bf16_neuron_layer_cases):
        cases.update(part(gen, batch))
        torch.cuda.empty_cache()
    return cases


def bn_fwd_verdict(args, kw, out) -> tuple[bool, float, bool]:
    """``bn_fwd``'s statistics against the oracle's within BN_TOL of the
    magnitudes they sum (two fp32 sums of the same column in other orders
    part by that much, however much they cancel): mu within BN_TOL of
    mean |x|, var within BN_TOL of mean x^2; and y, from the kernel's own
    statistics, the oracle's elementwise formula rounded to y's dtype, bit
    for bit. Returns ``(ok, worst error over its band, bitwise)``."""
    x, gamma, beta = args[:3]
    want = kref.bn_fwd_ref(x, gamma, beta, kw.get("eps", 1e-5))
    xf = x.float()
    s1 = xf.abs().mean(0, keepdim=True).clamp_min(1e-30)
    s2 = (xf * xf).mean(0, keepdim=True).clamp_min(1e-30)
    err = max(float(((out[1] - want[1]).abs() / s1).max()),
              float(((out[2].square() - want[2].square()).abs() / s2).max()))
    y = (gamma.float().reshape(1, -1) * (xf - out[1]) / out[2]
         + beta.float().reshape(1, -1)).to(x.dtype)
    return (err <= contracts.BN_TOL and torch.equal(out[0], y), err,
            all_equal(out, want))


def bn_bwd_verdict(args, out) -> tuple[bool, float, bool]:
    """``bn_bwd`` against the oracle on the call's operands, each output
    within BN_TOL of the magnitudes its sums add (eq. 20-22's in another
    order) and dx also within one rounding to its dtype: dbeta of sum |g|,
    dgamma of sum |mi * n| / |gamma|, dx of |n| * sum |mi * n| / (M *
    sqrt_d^2) + sum |mi| / M. Returns ``(ok, worst error over its band,
    bitwise)``."""
    g, x, gamma, mu, sd = args[:5]
    want = kref.bn_bwd_ref(g, x, gamma, mu, sd)
    gf, gm = g.float(), gamma.float().reshape(1, -1)
    n = x.float() - mu
    mi = gm * gf / sd
    a_mn = (mi * n).abs().sum(0, keepdim=True)
    a_m = mi.abs().sum(0, keepdim=True)
    rows = g.shape[0]
    rtol = contracts.BF16_RTOL if out[0].dtype == BF16 else 1e-5
    bands = (rtol * want[0].float().abs() + contracts.BN_TOL * (
                 n.abs() * a_mn / (rows * sd * sd) + a_m / rows),
             contracts.BN_TOL * a_mn / gm.abs(),
             contracts.BN_TOL * gf.abs().sum(0, keepdim=True))
    err = max(float(((a.float() - b.float()).abs()
                     / band.clamp_min(1e-30)).max())
              for a, b, band in zip(out, want, bands))
    return err <= 1.0, err, all_equal(out, want)


class SiteWalk:
    """Inside the block, every kernel wrapper call of the model is judged
    against its oracle on the call's own operands (``kernels/ref.py``):
    the LIF kernels bit for bit (with a carried state, the plain version),
    the spike matmul within one rounding to its dtype of the fp32 product,
    BN as ``bn_fwd_verdict`` and ``bn_bwd_verdict`` hold it, a neuron
    layer's spikes the oracle's outside the band (``nl_verdict``). ``rows``
    per kernel: calls, the dtypes seen, calls bit-equal to the oracle, the
    largest error (BN: over its band, at most 1) and the judged spikes;
    ``bad``, the calls that failed. The wrappers keep their launch
    counts."""

    TARGETS = ((lif_soma, "lif_soma_fwd"), (lif_soma, "lif_soma_bwd"),
               (spike_matmul, "spike_matmul_packed"),
               (spike_matmul, "spike_matmul_packed_batched"),
               (conv_spike, "spike_matmul_packed_batched"),
               (fused_bn, "bn_fwd"), (fused_bn, "bn_bwd"),
               (neuron_layer, "neuron_layer_eval"),
               (neuron_layer, "neuron_layer_train_fwd"))

    def __init__(self):
        self.rows = {}
        self.bad = []
        self._saved = []

    def _row(self, name):
        return self.rows.setdefault(name, {
            "calls": 0, "dtypes": [], "bitwise": 0, "max_err": 0.0,
            "spikes": 0, "in_band": 0, "wrong": 0})

    def judge(self, name, args, kw, out):
        row = self._row(name)
        row["calls"] += 1
        dt = str((args[1] if name.startswith("spike_matmul") else
                  args[0]).dtype)
        if dt not in row["dtypes"]:
            row["dtypes"].append(dt)
        ok, err, bitwise = True, 0.0, False
        lif_kw = {k: kw[k] for k in ("alpha", "th_fire") if k in kw}
        if name == "lif_soma_fwd":
            want = lif_soma.lif_soma_fwd_plain(*args, **kw) \
                if len(args) > 1 and args[1] is not None else \
                kref.lif_soma_fwd_ref(args[0], **kw)
            bitwise = ok = all(torch.equal(a, b) for a, b in zip(out, want))
        elif name == "lif_soma_bwd":
            gl = args[4] if len(args) > 4 else None
            want = kref.lif_soma_bwd_ref(*args[:4], **kw) if gl is None else \
                kref.lif_soma_bwd_carry_ref(*args[:4], gl, **kw)
            bitwise = ok = torch.equal(out, want)
        elif name.startswith("spike_matmul"):
            want = torch.matmul(spike_matmul.spike_unpack(
                args[0], torch.float32), args[1].float()).to(out.dtype)
            e = (out.float() - want.float()).abs()
            rtol = contracts.BF16_RTOL if out.dtype == BF16 else 1e-5
            ok = bool((e <= 1e-4 + rtol * want.float().abs()).all())
            err, bitwise = float(e.max()), torch.equal(out, want)
        elif name == "bn_fwd":
            ok, err, bitwise = bn_fwd_verdict(args, kw, out)
        elif name == "bn_bwd":
            ok, err, bitwise = bn_bwd_verdict(args, out)
        else:
            kind = "neuron_layer_eval" if name == "neuron_layer_eval" \
                else "neuron_layer_train"
            s = out if kind == "neuron_layer_eval" else out[0]
            v = nl_verdict(kind, s, args[:3 if kind == "neuron_layer_eval"
                                         else 4], **lif_kw)
            row["spikes"] += v["total"]
            row["in_band"] += v["in_band"]
            row["wrong"] += v["wrong"]
            ok = v["wrong"] == 0
        row["bitwise"] += bool(bitwise)
        row["max_err"] = max(row["max_err"], err)
        if not ok:
            self.bad.append({"kernel": name, "dtype": dt,
                             "shape": list(args[0].shape), "err": err})

    def __enter__(self):
        for mod, attr in self.TARGETS:
            real = getattr(mod, attr)
            name = "spike_matmul_packed_batched" if attr.startswith(
                "spike_matmul_packed_batched") else attr

            def spy(*args, _real=real, _name=name, **kw):
                out = _real(*args, **kw)
                if not args[0].is_meta:
                    with torch.no_grad():
                        self.judge(_name, args, {
                            k: v for k, v in kw.items() if k in (
                                "alpha", "th_fire", "th_lo", "th_hi",
                                "grad_scale", "eps")}, out)
                return out
            if hasattr(real, "launches"):
                spy.launches = real.launches
            self._saved.append((mod, attr, real, spy))
            setattr(mod, attr, spy)
        return self

    def __exit__(self, *exc):
        for mod, attr, real, spy in reversed(self._saved):
            setattr(mod, attr, real)
            if hasattr(spy, "launches"):
                real.launches = spy.launches
        return False


def bf16_vision_phase(seed: int, batch: int, smi: str) -> dict[str, dict]:
    """``spikingformer-8-512`` at bf16 under ``cuda-full``: the model
    phase's calibrated Gaussian weights cast to bf16 (BN's running
    statistics stay fp32, as in both packages), bf16 images, REQUESTS
    forwards of ``batch`` images (the launches per forward the fp32 path's,
    the logits finite; argmax against ``eager`` at bf16 measured), then one
    ``spikingformer_grad_step`` and 2 ``make_train_step`` steps from the
    preset's own bf16 initialisation on ``SyntheticVision`` (the launches
    per step the fp32 path's, every loss finite). One forward and the
    gradient step run inside a ``SiteWalk``: every kernel call at its own
    operands against its oracle. The end loss is not held against eager:
    the reference's own ``jnp`` and ``pallas-full`` part at bf16, eager
    BN rounding each operation where the kernels keep fp32."""
    eager32, make_images = make_model(
        seed, get_spikingformer_config(PRESET).num_layers, batch, "gaussian")
    cfg = dataclasses.replace(eager32.cfg, dtype=BF16)
    params = tree_map(lambda a: a.to(BF16), eager32.params)
    full = SpikingFormer(cfg.with_policy(named_policy("cuda-full")), params,
                         eager32.state, device=DEVICE)
    eager = SpikingFormer(cfg, params, eager32.state, device=DEVICE)
    del eager32
    images = [make_images().to(BF16) for _ in range(REQUESTS)]
    full(images[0])                          # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()                    # the bf16 serving path
    logits, ms = [], []
    with KernelTally() as tally_serve, \
            KernelTally(neuron_layer, "eval_kernel") as tally_eval:
        for img in images:
            t0 = time.perf_counter()
            logits.append(full(img))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    serve_counts = launch_counts()
    peak_serve = torch.cuda.max_memory_allocated()
    lf = torch.cat(logits).float()
    le = torch.cat([eager(img) for img in images]).float()
    depth = cfg.num_layers
    per_forward = {"lif_soma_fwd": 3 * depth,
                   "neuron_layer_eval": 4 + 4 * depth,
                   "spike_matmul_packed": 2 * depth,
                   "spike_matmul_packed_batched": depth, "lif_soma_bwd": 0,
                   "bn_fwd": 0, "bn_bwd": 0, "neuron_layer_train": 0,
                   PACK_ENTRY: pack_per_pass(depth, cfg.tokenizer_stages)}
    with SiteWalk() as walk_serve:
        full(images[0])

    tcfg = dataclasses.replace(
        get_spikingformer_config(PRESET + "@cuda-full"), dtype=BF16)
    p0, s0 = init_spikingformer(torch.Generator().manual_seed(seed), tcfg,
                                DEVICE)
    data = SyntheticVision(VisionDataConfig(
        image_size=tcfg.image_size, num_classes=tcfg.num_classes,
        global_batch=batch, channels=tcfg.in_channels, seed=seed))
    batches = [{"images": torch.from_numpy(v["images"]).to(DEVICE, BF16),
                "labels": torch.from_numpy(v["labels"]).to(DEVICE)}
               for v in (data.batch(i) for i in range(3))]
    per_step = per_train_step(tcfg.num_layers, tcfg.tokenizer_stages)
    reset_launch_counts()
    with SiteWalk() as walk_train:
        grads, _, metrics = spikingformer_grad_step(
            p0, s0, batches[0]["images"], batches[0]["labels"], tcfg)
    grad_counts = launch_counts()
    grad_dtypes = sorted({str(a.dtype) for a in tree_leaves(grads)})
    grad_finite = all(bool(torch.isfinite(a).all())
                      for a in tree_leaves(grads))
    del grads
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=100,
                              weight_decay=0.01)
    step = make_train_step(tcfg, opt_cfg)
    opt = init_opt_state(p0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()                    # the bf16 training path
    p, st, rows, times = p0, s0, [float(metrics["loss"])], []
    with KernelTally() as tally_train, \
            KernelTally(neuron_layer, "z_kernel") as tally_z:
        for b in batches[1:]:
            t0 = time.perf_counter()
            p, st, opt, m = step(p, st, opt, b["images"], b["labels"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            rows.append(float(m["loss"]))
    train_counts = launch_counts()
    peak_train = torch.cuda.max_memory_allocated()
    moved = not all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                      tree_leaves(p0)))
    want_serve = {k: v * REQUESTS for k, v in per_forward.items()}
    want_train = {k: v * 2 for k, v in per_step.items()}
    emit("bf16_vision", preset=f"{PRESET}@cuda-full", dtype="bfloat16",
         depth=depth, batch=batch, requests=REQUESTS, card=smi,
         serve={"ms_per_request": ms, "peak_memory_bytes": peak_serve,
                "logits_finite": bool(torch.isfinite(lf).all()),
                "argmax_agree_with_eager_bf16":
                    f"{int((lf.argmax(-1) == le.argmax(-1)).sum())}/"
                    f"{lf.shape[0]}",
                "max_abs_logit_diff_vs_eager_bf16": float(
                    (lf - le).abs().max()),
                "launches": serve_counts, "launches_per_forward":
                    per_forward, "launches_by_plan_kernel":
                    tally_serve.counts, "eval_launches_by_tile_code":
                    tally_eval.counts, "site_walk": walk_serve.rows},
         train={"losses": rows, "ms_per_step": times,
                "peak_memory_bytes": peak_train, "params_moved": moved,
                "grad_dtypes": grad_dtypes, "grad_step_launches": grad_counts,
                "launches": train_counts, "launches_per_step": per_step,
                "launches_by_plan_kernel": tally_train.counts,
                "z_pass_launches_by_plan_kernel": tally_z.counts,
                "site_walk": walk_train.rows},
         note="the eager comparison is measured, not held: eager BN rounds "
              "each bf16 operation where the kernels keep fp32")
    problems = walk_serve.bad + walk_train.bad
    if serve_counts != want_serve or grad_counts != per_step or \
            train_counts != want_train:
        fail(f"bf16 vision launch counts: serve {serve_counts}, grad step "
             f"{grad_counts}, train {train_counts}")
    if not (bool(torch.isfinite(lf).all()) and grad_finite and moved and
            all(map(math.isfinite, rows))) or problems:
        fail(f"bf16 vision: logits finite {bool(torch.isfinite(lf).all())}, "
             f"gradients finite {grad_finite}, losses {rows}, moved {moved}, "
             f"site walk failures {problems[:5]}")
    # every 2-D spike matmul of the bf16 paths (pssa.proj, smlp.b: M =
    # T*B*N) on the wgmma kernel, the per-head attn_qk (8 a forward and a
    # step) on the heads kernel
    for name, counts, tally in (("serve", serve_counts, tally_serve),
                                ("train", train_counts, tally_train)):
        want = {code: n for code, n in (
            (spike_matmul.WGMMA, counts["spike_matmul_packed"]),
            (spike_matmul.HEADS, counts["spike_matmul_packed_batched"]))
            if n}
        if tally.counts != want:
            fail(f"bf16 vision {name}: spike matmul launches by plan kernel "
                 f"{tally.counts}, not {want}")
    # every packed eval call of the bf16 serving path on the wgmma eval
    # kernel: all but the dense first tokenizer stage's, one a forward
    want_e = {neuron_layer.EVAL_TILE_WGMMA:
              serve_counts["neuron_layer_eval"] - REQUESTS}
    if tally_eval.counts != want_e:
        fail(f"bf16 vision serve: packed eval calls by tile code "
             f"{tally_eval.counts}, not {want_e}")
    # every first pass of the bf16 training path (forward and replay) on
    # the wgmma z kernel but the dense first tokenizer stage's
    dense = 2 * (len(batches) - 1)
    want_z = {neuron_layer.Z_WGMMA: train_counts["neuron_layer_train"]
              - dense, neuron_layer.Z_DENSE: dense}
    if tally_z.counts != want_z:
        fail(f"bf16 vision train: z passes by plan kernel {tally_z.counts}, "
             f"not {want_z}")
    return {"bf16_serve": {**serve_counts, WGMMA_ENTRY:
                           tally_serve.counts[spike_matmul.WGMMA],
                           HEADS_ENTRY:
                           tally_serve.counts[spike_matmul.HEADS],
                           Z_WGMMA_ENTRY: 0, EVAL_WGMMA_ENTRY:
                           tally_eval.counts[neuron_layer.EVAL_TILE_WGMMA]},
            "bf16_train": {**train_counts, WGMMA_ENTRY:
                           tally_train.counts[spike_matmul.WGMMA],
                           HEADS_ENTRY:
                           tally_train.counts[spike_matmul.HEADS],
                           Z_WGMMA_ENTRY: tally_z.counts[
                               neuron_layer.Z_WGMMA], EVAL_WGMMA_ENTRY: 0}}


def bf16_serve(params, arch: str, seed: int, slots: int = LM_SLOTS
               ) -> tuple[dict, dict[str, int], int]:
    """A spiking LM at bf16 (``params`` drawn under ``lm_config(...,
    BF16)``) serving the 16 requests through ``ServingEngine(slots=slots)``
    with a bf16 cache under ``cuda-full`` and ``eager``: tokens and every
    step's logits and branch spikes bit-equal (the LIF, the LM's one
    kernel, equals the eager scan bit for bit at bf16 too), every request
    finished, one ``lif_soma_fwd`` launch a layer a step; an unrecorded
    ``cuda-full`` run gives the times and must repeat the tokens. Returns
    the line's ``serve`` entry, the launches and the steps of that run."""
    layers = lm_config("cuda-full", arch, BF16).num_layers
    vocab = get_config(arch).vocab_size
    reqs = lm_requests(vocab, seed)
    runs = {p: lm_serve(params, p, reqs, arch=arch, dtype=BF16, slots=slots)
            for p in ("cuda-full", "eager")}
    timed = lm_serve(params, "cuda-full", reqs, record=False, arch=arch,
                     dtype=BF16, slots=slots)
    full, eager = runs["cuda-full"], runs["eager"]
    tokens_equal = full["done"].keys() == eager["done"].keys() and all(
        full["done"][u].output == eager["done"][u].output
        for u in full["done"])
    logits_equal = full["step_count"] == eager["step_count"] and all(
        torch.equal(a[0], b[0]) for a, b in zip(full["steps"],
                                                eager["steps"]))
    spikes_equal = all(torch.equal(a[1], b[1])
                       for a, b in zip(full["steps"], eager["steps"]))
    everyone = all(len(r["done"]) == LM_REQUESTS and not r["other"]
                   for r in (full, eager, timed))
    repeat = all(timed["done"][u].output == full["done"][u].output
                 for u in full["done"])
    del runs, full, eager
    torch.cuda.empty_cache()
    counts = timed["counts"]
    ms = sorted(timed["ms"])
    serve = {"finished": f"{len(timed['done'])}/{LM_REQUESTS}",
             "slots": slots, "max_seq": LM_MAX_SEQ,
             "tokens_equal": tokens_equal,
             "logits_bit_equal_every_step": logits_equal,
             "spikes_bit_equal_every_step": spikes_equal,
             "unrecorded_run_repeats_recorded": repeat,
             "steps": timed["step_count"],
             "ms_per_step_median": ms[len(ms) // 2],
             "tokens_per_s": timed["generated"] / timed["wall_s"],
             "peak_memory_bytes": timed["peak"], "launches": counts}
    if not (everyone and tokens_equal and logits_equal and spikes_equal
            and repeat) or counts != lm_expected(
                layers * timed["step_count"]):
        fail(f"{arch} bf16 serve: finished {everyone}, tokens "
             f"{tokens_equal}, logits {logits_equal}, spikes "
             f"{spikes_equal}, repeat {repeat}, launches {counts}")
    return serve, counts, timed["step_count"]


def lm_bf16_phase(seed: int, smi: str) -> dict[str, dict[str, int]]:
    """``qwen3-0.6b`` + LIF at its published dtype, bf16 (the registry's
    config with only ``lif=`` added), published widths and depth, weights
    from ``seed`` on the card. Serving: ``bf16_serve``. Training: step 0's
    forward and loss bit-equal between the policies and every gradient
    leaf bit-equal or within ``LM_BF16_GRAD_LIMIT`` of its scale; then 1 +
    LM_TRAIN_STEPS steps through the driver under ``cuda-full``, every
    step finite, every leaf moved but a leaf of ones (a norm's scale at
    its init moves by a bf16 unit only under larger steps than the
    warm-up's; the unmoved leaves are named), the LIF launches a step the
    fp32 path's."""
    layers = lm_config("cuda-full", LM_ARCH, BF16).num_layers
    params = split_tree(init_lm(torch.Generator(device=DEVICE).manual_seed(
        seed), lm_config("eager", LM_ARCH, BF16), DEVICE))[0]
    serve, serve_counts, _ = bf16_serve(params, LM_ARCH, seed)

    tcfg = lm_train_config("cuda-full", LM_ARCH, dtype=BF16)
    tparams = build_state(tcfg, seed=seed, device=DEVICE)[0]
    leaves = len(tree_leaves(tparams))
    toks = lm_train_batch(tcfg, seed)["tokens"]
    with torch.no_grad():
        h_c = lm_forward(tparams, {"tokens": toks}, tcfg)[0]
        h_e = lm_forward(tparams, {"tokens": toks}, lm_train_config(
            "eager", LM_ARCH, dtype=BF16))[0]
    forward_equal = torch.equal(h_c, h_e)
    del h_c, h_e
    grads = lm_grad_check(tparams, seed, LM_ARCH, dtype=BF16)
    torch.cuda.empty_cache()
    run = lm_train_run(tcfg, seed)
    run["moved_leaves"] = moved_leaves(run, tparams)
    run.pop("history")
    emit("lm_bf16", arch=f"{LM_ARCH}@cuda-full", dtype="bfloat16",
         cache_dtype="bfloat16", layers=layers, card=smi,
         parameters=sum(a.numel() for a in tree_leaves(params)),
         bytes=nbytes(*tree_leaves(params)),
         serve=serve,
         train={"step0_forward_bit_equal": forward_equal,
                "step0": {k: v for k, v in grads.items()
                          if k not in ("per_leaf", "tolerance")},
                "grad_tolerance": f"bitwise or within {LM_BF16_GRAD_LIMIT} "
                                  f"of the leaf's scale, max(1, max|eager|)",
                "cuda_full": run, "launches_per_step": lm_train_expected(1)})
    if not (forward_equal and grads["loss_bit_equal"]) or \
            grads["max_scaled_err"] > LM_BF16_GRAD_LIMIT or \
            grads["nonfinite_elements"]:
        fail(f"lm bf16 step 0: forward bitwise {forward_equal}, loss "
             f"bitwise {grads['loss_bit_equal']}, worst leaf "
             f"{grads['max_scaled_err']}, non-finite "
             f"{grads['nonfinite_elements']}")
    # bf16 weights take the AdamW step themselves: a leaf of ones (a norm's
    # scale at its init; bf16 holds 1 - 2^-8 and 1 + 2^-7 beside 1) does not
    # move while the step stays below half of that, as over the warm-up's
    # first learning rates; every other leaf must move
    unmoved = [n for n, a in zip(tree_paths(tparams), tree_leaves(tparams))
               if n in run["unmoved"] and not bool((a == 1).all())]
    check_train_run("lm bf16 train", {**run, "moved_leaves": leaves},
                    leaves, 1 + LM_TRAIN_STEPS,
                    lm_train_expected(1 + LM_TRAIN_STEPS))
    if unmoved:
        fail(f"lm bf16 train: leaves {unmoved} did not move")
    return {"lm_bf16_serve": serve_counts, "lm_bf16_train": run["counts"]}


# ---------------------------------------------------------------------------
# Phase 8b: the encoder-decoder (whisper-large-v3, published size)
# ---------------------------------------------------------------------------

WHISPER_ARCH = "whisper-large-v3"
#: Serving: 8 requests' frames (1,500 x 1,280 each, N(0, 1) from the seed),
#: a 4-token prompt fed through the decode step, then 60 greedy steps, in
#: a self-attention cache of 128 positions.
WHISPER_REQUESTS, WHISPER_PROMPT, WHISPER_NEW = 8, 4, 60
WHISPER_MAX_SEQ = 128
#: Decode against the teacher-forced forward: the reference's own
#: tolerance (``tests/test_archs_smoke.py:119-123``), rtol = atol.
WHISPER_TOL = 2e-2
#: The query and key projections' scale of the held whisper runs (the
#: parity tests' ``QK_SCALE``): attention logits of std about 4, not 64.
QK_SCALE = 0.25


def whisper_serve(params, cfg, seed: int) -> dict:
    """``init_encdec_cache`` (the encoder pass, timed) and the decode steps
    of ``WHISPER_REQUESTS`` requests, each step timed to its end; then the
    logits of every step against ``decode_train`` + ``unembed`` over the
    fed sequence."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    b = WHISPER_REQUESTS
    frames = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device=DEVICE)
    prompt = torch.randint(0, cfg.vocab_size, (b, WHISPER_PROMPT),
                           generator=gen, device=DEVICE)
    fed, logits, ms = [], [], []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_launch_counts()                # the path starts here
        t0 = time.perf_counter()
        cache = init_encdec_cache(params, frames, cfg, b, WHISPER_MAX_SEQ,
                                  dtype=torch.float32)
        torch.cuda.synchronize()
        encode_ms = (time.perf_counter() - t0) * 1e3
        tok = None
        for t in range(WHISPER_PROMPT + WHISPER_NEW):
            cur = prompt[:, t] if t < WHISPER_PROMPT else tok
            t0 = time.perf_counter()
            lg, cache = encdec_decode_step(
                params, cache, cur[:, None],
                torch.full((b,), t, dtype=torch.int32, device=DEVICE), cfg)
            tok = lg.argmax(-1)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            fed.append(cur)
            logits.append(lg)
        counts = launch_counts()             # ... and ends here
        peak = torch.cuda.max_memory_allocated()
        del cache
        got = torch.stack(logits, 1)
        seq = torch.stack(fed, 1)
        want = unembed(params["embed"], decode_train(
            params, seq, encode(params, frames, cfg), cfg))
    diff = (got - want).abs()
    greedy = sorted(ms[WHISPER_PROMPT:])
    return {"requests": b, "frames": list(frames.shape),
            "prompt_tokens": WHISPER_PROMPT, "greedy_steps": WHISPER_NEW,
            "max_seq": WHISPER_MAX_SEQ, "cache_dtype": "float32",
            "encode_ms": encode_ms,
            "decode_step_ms_median": greedy[len(greedy) // 2],
            "decode_step_ms": ms,
            "generated_tokens_per_s": b * WHISPER_NEW
            / sum(ms[WHISPER_PROMPT:]) * 1e3,
            "peak_memory_bytes": peak, "counts": counts,
            "decode_vs_forward": {
                "max_abs": float(diff.max()),
                "within": bool((diff <= WHISPER_TOL + WHISPER_TOL
                                * want.abs()).all()),
                "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                      .float().mean()),
                "logits_std": float(want.std()),
                "tolerance": f"rtol = atol = {WHISPER_TOL}"},
            "finite": bool(torch.isfinite(got).all())}


def qk_scale_(params, scale: float) -> None:
    """Every attention's query and key projections of an encoder-decoder
    tree times ``scale``, in place (a power of two: exact either way)."""
    for blocks, attn in (("enc_blocks", "attn"), ("dec_blocks", "self"),
                         ("dec_blocks", "cross")):
        for k in ("wq", "wk"):
            params[blocks][attn][k].mul_(scale)


def whisper_phase(seed: int, smi: str) -> dict[str, dict[str, int]]:
    """``whisper-large-v3`` at its published size (32 + 32 layers, d 1280,
    20 heads, d_ff 5120, vocab 51,866, 1,500 frames), fp32, weights from
    ``seed`` on the card, serving (``whisper_serve``) and 1 +
    FAMILY_TRAIN_STEPS training steps of 8 x 128 tokens over 8 x 1,500
    zero frames through the driver's ``train()``, twice each.

    At the reference's init (``init_encdec``; the driver's own draw) the
    query and key projections are drawn at fan-in heads^-1/2, so the
    attention logits have a std of about 64 at this width (ROADMAP C7):
    decode against the teacher-forced forward and the first step's
    gradient norm (which overflows fp32, so AdamW's clip zeroes the
    update) are measured there, not held; the loss, the guard's flag and
    the launches are. Then with those projections scaled by
    ``QK_SCALE`` (the parity tests' regime), the held run: decode within
    ``WHISPER_TOL`` of the forward, the training steps from these weights
    (written as the checkpoint the driver resumes from, as a fine-tune
    starts) finite with every parameter leaf moved. No kernel launches on
    any path: the family never reads ``cfg.lif`` (the reference's path
    reaches no Pallas kernel either). Returns each path's launch
    counts."""
    cfg = lm_train_config("cuda-full", WHISPER_ARCH)
    params, opt_state, specs = build_state(cfg, seed=seed, device=DEVICE)
    del opt_state
    leaves = len(tree_leaves(params))
    none = dict.fromkeys(COUNTED, 0)
    torch.cuda.empty_cache()
    serve_init = whisper_serve(params, cfg, seed)
    torch.cuda.empty_cache()
    run_init = lm_train_run(cfg, seed, FAMILY_TRAIN_STEPS)
    run_init["moved_leaves"] = moved_leaves(run_init, params)
    qk_scale_(params, QK_SCALE)
    torch.cuda.empty_cache()
    serve = whisper_serve(params, cfg, seed)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 0, params, specs)
        run = lm_train_run(cfg, seed, FAMILY_TRAIN_STEPS, ckpt_dir=d)
    run["moved_leaves"] = moved_leaves(run, params)
    emit("whisper", arch=f"{WHISPER_ARCH}@cuda-full",
         encoder_layers=cfg.encoder_layers, decoder_layers=cfg.num_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, d_ff=cfg.d_ff,
         vocab=cfg.vocab_size, frames=cfg.encoder_seq, dtype="float32",
         remat=cfg.remat, cut="nothing",
         parameters=sum(a.numel() for a in tree_leaves(params)),
         bytes=nbytes(*tree_leaves(params)), parameter_leaves=leaves,
         weights=f"init_encdec from the seed; the held runs with every "
                 f"attention's wq and wk times {QK_SCALE}",
         serve=serve, serve_at_init={
             k: serve_init[k] for k in ("decode_vs_forward", "finite",
                                        "counts")} | {"held": False},
         train={k: v for k, v in run.items() if k != "history"} | {
             "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
             "frames_per_step": LM_TRAIN_BATCH * cfg.encoder_seq,
             "schedule": f"1 warm-up + {FAMILY_TRAIN_STEPS} timed",
             "start": "the scaled weights, restored from a checkpoint",
             "data": "SyntheticLM tokens, zero frames (the reference "
                     "driver's)"},
         train_at_init={k: v for k, v in run_init.items()
                        if k != "history"} | {
             "held": "loss finite, nonfinite 0, no launches"},
         card=smi)
    if not (serve["decode_vs_forward"]["within"] and serve["finite"]):
        fail(f"whisper: decode differs from the teacher-forced forward by "
             f"{serve['decode_vs_forward']['max_abs']} (tolerance "
             f"{WHISPER_TOL}) or is not finite")
    if serve["counts"] != none or serve_init["counts"] != none:
        fail(f"whisper serving launched kernels: {serve['counts']}, "
             f"{serve_init['counts']}")
    check_train_run("whisper train", run, leaves, 1 + FAMILY_TRAIN_STEPS,
                    none)
    if run_init["counts"] != none or any(
            r["nonfinite"] or not math.isfinite(r["loss"])
            for r in run_init["steps"]):
        fail(f"whisper train at init: {run_init['steps']}, launches "
             f"{run_init['counts']}")
    return {"whisper_serve_at_init": serve_init["counts"],
            "whisper_train_at_init": run_init["counts"],
            "whisper_serve": serve["counts"], "whisper_train": run["counts"]}


# ---------------------------------------------------------------------------
# Phase 9c: the chaos harness (the reference's recovery drill at the preset,
# the circuit breaker's demotion, the serving quarantine)
# ---------------------------------------------------------------------------

#: The reference's acceptance schedule (``tests/test_chaos.py``): a NaN
#: gradient at step 3, a kernel fault at the first ``pssa.qkv`` dispatch,
#: SIGTERM at step 5 and the step-6 checkpoint corrupted on write, so the
#: restart after the preemption falls back to step 4.
CHAOS_SCHEDULE = FaultSchedule(seed=9, faults=(
    FaultSpec("chaos.grad", 3, "nan"),
    FaultSpec("chaos.kernel.pssa.qkv", 0, "raise"),
    FaultSpec("chaos.step", 5, "sigterm"),
    FaultSpec("chaos.ckpt", 6, "corrupt", mode="write"),
))
CHAOS_STEPS, CHAOS_CKPT_EVERY = 8, 2
CHAOS_TIMEOUT_S = 400
#: The recovery, as the drill's log must show it (the reference's lines).
CHAOS_LOG = ("demoted to 'eager'", "non-finite loss/grads",
             "[preempt] checkpoint saved",
             "falling back to the previous retained step", "clean recovery")
#: The serving fault: request 0 (slot 0 from step 0) at its third sampled
#: token.
CHAOS_SLOT, CHAOS_TOKEN = 0, 2


def chaos_drill(tmp: str, tag: str) -> dict:
    """The reference's recovery drill through ``python -m
    repro_torch.chaos.runner`` in a process of its own (its SIGTERM and its
    process-wide trip stay out of this one): ``PRESET`` under
    ``cuda-full``, batch ``BATCH``, ``CHAOS_STEPS`` steps, a checkpoint
    every ``CHAOS_CKPT_EVERY``, seed 9, ``CHAOS_SCHEDULE``. Held to the
    reference's assertions; returns the report, the command's seconds and
    the runner's timing line."""
    from repro_torch.train import checkpoint as ckpt
    sched, report = os.path.join(tmp, "schedule.json"), \
        os.path.join(tmp, f"{tag}.json")
    CHAOS_SCHEDULE.to_file(sched)
    ckpt_dir = os.path.join(tmp, tag)
    t0 = time.perf_counter()
    out = run_child([sys.executable, "-m", "repro_torch.chaos.runner",
                     "--arch", PRESET, "--policy", "cuda-full",
                     "--batch", str(BATCH), "--steps", str(CHAOS_STEPS),
                     "--ckpt-every", str(CHAOS_CKPT_EVERY), "--seed", "9",
                     "--schedule", sched, "--ckpt-dir", ckpt_dir,
                     "--report-out", report], f"the drill ({tag})",
                    phase="chaos", timeout=CHAOS_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    log = out.stdout + out.stderr
    with open(report) as f:
        rep = json.load(f)
    timing = json.loads(log.split("[chaos-runner] timing: ")[1]
                        .splitlines()[0])
    retained = {s: ckpt.verify_checkpoint(ckpt_dir, s)
                for s in ckpt.retained_steps(ckpt_dir)}
    fired = {e.split("@")[0] for e in rep["events"]}
    missing = [line for line in CHAOS_LOG if line not in log]
    if not (rep["completed"] and rep["final_step"] == CHAOS_STEPS
            and rep["final_ckpt_ok"] and rep["restarts"] == 1
            and rep["breaker_sites"] == ["pssa.qkv"]
            and fired == {"chaos.grad", "chaos.kernel.pssa.qkv",
                          "chaos.step", "chaos.ckpt"}
            and not missing and retained
            and not any(retained.values())):
        fail(f"chaos drill {tag}: report {rep}, log lines missing "
             f"{missing}, retained checkpoints {retained}: "
             f"{log[-3000:]}")
    ms = [m for _, m in timing["step_ms"]]
    return {"report": rep, "seconds": seconds,
            "step_ms": timing["step_ms"],
            "step_ms_median": sorted(ms)[len(ms) // 2],
            "peak_memory_bytes": timing["peak_memory_bytes"],
            "retained": sorted(retained)}


def grad_step_run(cfg, params, state, batch, schedule=None) -> dict:
    """One BPTT step (``spikingformer_grad_step``, the training step's
    gradient function) of ``cfg`` on ``batch``, under ``schedule`` when
    given: loss, gradients, new BN state, the launches counted from 0 just
    before it, and the injector's events."""
    reset_launch_counts()                    # the path starts here
    with (chaos(schedule) if schedule is not None
          else contextlib.nullcontext()) as inj:
        grads, new_state, metrics = spikingformer_grad_step(
            params, state, batch["images"], batch["labels"], cfg)
        torch.cuda.synchronize()
    return {"loss": metrics["loss"], "grads": grads, "state": new_state,
            "counts": launch_counts(),       # ... and ends here
            "events": list(inj.events) if inj is not None else []}


def chaos_demotion(seed: int) -> dict:
    """A ``chaos.kernel.pssa.qkv`` fault at index 0 in one training step of
    ``PRESET`` at batch ``BATCH`` under ``cuda-full``, in this process,
    against the step from the same weights with the policy override
    ``pssa.qkv: eager`` and against the clean step: loss, every gradient
    leaf and the BN state bit-equal to the override's (both take the eager
    pipeline at that site and the kernels everywhere else); the launches
    per kernel those the plan gives. The trip shows in ``breaker_trips``,
    ``describe_execution`` and ``audit_breaker``, and is cleared before the
    next phase."""
    from repro_torch.analysis.audit import audit_breaker
    cfg = get_spikingformer_config(PRESET + "@cuda-full")
    pinned = cfg.with_policy(cfg.policy.with_sites({"pssa.qkv": "eager"}))
    depth = cfg.num_layers
    params, state = init_spikingformer(torch.Generator().manual_seed(seed),
                                       cfg, DEVICE)
    data = SyntheticVision(VisionDataConfig(
        image_size=cfg.image_size, num_classes=cfg.num_classes,
        global_batch=BATCH, channels=cfg.in_channels, seed=seed))
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in data.batch(0).items()}
    if breaker_trips():
        fail(f"chaos: a site is tripped before the phase: {breaker_trips()}")
    clean = grad_step_run(cfg, params, state, batch)
    faulted = grad_step_run(cfg, params, state, batch, FaultSchedule(
        seed=seed, faults=(FaultSpec("chaos.kernel.pssa.qkv", 0, "raise"),)))
    trips = breaker_trips()
    described = "pssa.qkv,linear_bn,fused_epilogue,eager,ChaosKernelFault" \
        in cfg.describe_execution()
    audit = [(f.check, f.level, f.where) for f in audit_breaker()]
    reset_breaker()
    pinned_run = grad_step_run(pinned, params, state, batch)
    after_reset = breaker_trips()
    # pssa.qkv is the q, k and v neuron layers of each block: each demoted
    # call drops a neuron_layer_train launch, its replay in the backward
    # and the backward's bn_bwd (the eager BN's backward is autograd's
    # plain ops); the pipeline's SOMA forward and GRAD take the place of
    # the replay's lif_soma_fwd and lif_soma_bwd one for one; the eager
    # pipeline packs nothing (the fault fires in dispatch, before the pack)
    want = dict(clean["counts"])
    want["neuron_layer_train"] -= 2 * 3 * depth
    want["bn_bwd"] -= 3 * depth
    want[PACK_ENTRY] -= 3 * depth
    bits = {
        "loss": torch.equal(faulted["loss"], pinned_run["loss"]),
        "grads": all(torch.equal(a, b) for a, b in zip(
            tree_leaves(faulted["grads"]), tree_leaves(pinned_run["grads"]))),
        "bn_state": all(torch.equal(a, b) for a, b in zip(
            tree_leaves(faulted["state"]), tree_leaves(pinned_run["state"])))}
    result = {
        "bit_equal_to_pinned": bits, "events": faulted["events"],
        "trips": sorted(trips), "describe_execution": described,
        "audit_breaker": audit, "trips_after_reset": sorted(after_reset),
        "launches_clean": clean["counts"],
        "launches_faulted": faulted["counts"],
        "launches_pinned": pinned_run["counts"],
        "launches_want": want,
        "clean_launches_per_train_step": clean["counts"] == per_train_step(
            depth, cfg.tokenizer_stages),
        "loss_clean": float(clean["loss"]),
        "loss_faulted": float(faulted["loss"])}
    if not (all(bits.values()) and set(trips) == {"pssa.qkv"}
            and faulted["events"] == ["chaos.kernel.pssa.qkv@0:raise"]
            and described and audit == [("audit.breaker", "warning",
                                         "pssa.qkv")]
            and after_reset == {} and faulted["counts"] == want
            and pinned_run["counts"] == want
            and result["clean_launches_per_train_step"]):
        fail(f"chaos demotion: {result}")
    return result


def chaos_serve(seed: int) -> dict:
    """``LM_ARCH`` + LIF under ``cuda-full`` serving the ``lm`` phase's 16
    requests with a ``chaos.serving.slot`` fault at slot ``CHAOS_SLOT``'s
    ``CHAOS_TOKEN``-th sampling step: exactly request 0 ends ``faulted`` /
    ``numeric_fault`` with the clean run's first tokens, every other one
    the clean run's tokens (``SERVED``, whatever slot and step it is
    admitted at), every slot free at the end, the reference's event, one
    ``lif_soma_fwd`` a layer a step."""
    cfg = lm_config("cuda-full")
    clean = SERVED[LM_ARCH]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = split_tree(init_lm(gen, lm_config("eager"), DEVICE))[0]
    reqs = lm_requests(cfg.vocab_size, seed)
    step = len(reqs[0][0]) - 1 + CHAOS_TOKEN
    engine = ServingEngine(params, cfg, slots=LM_SLOTS, max_seq=LM_MAX_SEQ)
    for uid, (prompt, new) in enumerate(reqs):
        if not engine.submit(Request(uid=uid, prompt=prompt,
                                     max_new_tokens=new)):
            fail(f"chaos serve: request {uid} rejected")
    torch.cuda.synchronize()
    reset_launch_counts()                    # the path starts here
    t0 = time.perf_counter()
    with chaos(FaultSchedule(seed=seed, faults=(FaultSpec(
            "chaos.serving.slot", step, "nan", value=float(CHAOS_SLOT)),))) \
            as inj:
        engine.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()                 # ... and ends here
    bad = engine.faulted
    done = {r.uid: r.output for r in engine.finished}
    others = all(done.get(u) == clean[u] for u in clean if u != 0)
    result = {
        "fault_step": step, "events": list(inj.events),
        "faulted": [(r.uid, r.status, r.reason, len(r.output))
                    for r in bad],
        "faulted_tokens_are_clean_prefix": bool(bad) and bad[0].output ==
        clean[0][:len(bad[0].output)],
        "finished": len(engine.finished), "others_tokens_equal": others,
        "free_slots": engine.sched.free_slots(), "steps": engine.step_count,
        "wall_s": wall, "launches": counts}
    if not (result["faulted"] == [(0, "faulted", "numeric_fault",
                                   CHAOS_TOKEN)]
            and result["faulted_tokens_are_clean_prefix"] and others
            and len(engine.finished) == LM_REQUESTS - 1
            and result["free_slots"] == list(range(LM_SLOTS))
            and result["events"] == [f"chaos.serving.slot@{step}:nan "
                                     f"slot={CHAOS_SLOT}"]
            and counts == lm_expected(cfg.num_layers * engine.step_count)):
        fail(f"chaos serve: {result}")
    return result


def chaos_phase(seed: int, smi: str) -> None:
    """The chaos harness on the card (``repro_torch.chaos``): the drill
    twice (:func:`chaos_drill`), each run's events and loss history equal
    to the other's (NaN equal to NaN, the rest bit for bit); the breaker's
    demotion in this process (:func:`chaos_demotion`), no trip left after
    it; the serving quarantine (:func:`chaos_serve`). Prints the ``chaos``
    line."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        runs = [chaos_drill(tmp, tag) for tag in ("run1", "run2")]
    a, b = (r["report"] for r in runs)
    same = a["events"] == b["events"] and len(a["history"]) == len(
        b["history"]) and all((math.isnan(x) and math.isnan(y)) or x == y
                              for x, y in zip(a["history"], b["history"]))
    if not same:
        fail(f"chaos drill: the two replays differ: {a} against {b}")
    t1 = time.perf_counter()
    demotion = chaos_demotion(seed)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    serve = chaos_serve(seed)
    torch.cuda.empty_cache()
    emit("chaos", card=smi, preset=f"{PRESET}@cuda-full", batch=BATCH,
         schedule=json.loads(CHAOS_SCHEDULE.to_json()),
         drill={"replays_equal": same, "runs": runs},
         demotion=demotion, serving=serve,
         seconds={"drill": t1 - t0, "demotion": t2 - t1,
                  "serving": time.perf_counter() - t2,
                  "phase": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# Phase 10: data parallelism over a mesh (a world of 1 on this card)
# ---------------------------------------------------------------------------

#: Timed steps of the mesh phase's runs, after one warm-up step.
MESH_STEPS = 2
#: The halves' statistics against the whole batch's: relative to their
#: scale (the chunks' fp32 partials start at other rows).
HALVES_LIMIT = 1e-6


def split_bn_shapes(batch: int) -> list[tuple[str, int, int]]:
    """(case, rows, D) of the BN kernels under the split path: the blocks'
    (T*B*N, d) and (T*B*N, d_ff), then each tokenizer stage's (T*M, K)."""
    cfg = get_spikingformer_config(PRESET)
    rows = cfg.time_steps * batch * cfg.num_tokens
    return [("blocks d", rows, cfg.d_model), ("blocks d_ff", rows, cfg.d_ff)] \
        + [(case, t * m, k) for case, t, m, _, k, _ in
           neuron_layer_sites(batch) if case.startswith("tokenizer")]


def bits_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def split_bn_case(gen, group, case, m, d) -> dict:
    """bn_fwd and bn_bwd at (m, d): (a) the split path (the group's
    all-reduce between its two launches) against the fused path, outputs
    and statistics bit for bit; (b) the rows cut in two halves, each
    half's sums taken, added as two ranks' all-reduce adds them, and each
    half normalised with the sum, against the whole: mu and var within
    HALVES_LIMIT of their scale, y and dx as measured; the times of both
    paths at a world of 1."""
    x = torch.randn((m, d), generator=gen, device=DEVICE) * 2.0 + 0.5
    gamma = torch.rand((d,), generator=gen, device=DEVICE) + 0.5
    beta = torch.randn((d,), generator=gen, device=DEVICE) * 0.3
    g = torch.randn((m, d), generator=gen, device=DEVICE)
    fused = fused_bn.bn_fwd(x, gamma, beta)
    split = fused_bn.bn_fwd(x, gamma, beta, group=group)
    _, mu, sd = fused
    dfused = fused_bn.bn_bwd(g, x, gamma, mu, sd)
    dsplit = fused_bn.bn_bwd(g, x, gamma, mu, sd, group)
    h = m // 2
    sums = fused_bn.bn_fwd_sums(x[:h]) + fused_bn.bn_fwd_sums(x[h:])
    lo, hi = (fused_bn.bn_fwd_apply(part, gamma, beta, sums)
              for part in (x[:h], x[h:]))
    (s_lo, dg_lo, _), (s_hi, dg_hi, _) = (
        fused_bn.bn_bwd_sums(gp, xp, gamma, mu, sd)
        for gp, xp in ((g[:h], x[:h]), (g[h:], x[h:])))
    dx = torch.cat([fused_bn.bn_bwd_apply(gp, xp, gamma, mu, sd, s_lo + s_hi)
                    for gp, xp in ((g[:h], x[:h]), (g[h:], x[h:]))])
    torch.cuda.synchronize()
    var = (lambda sq: sq * sq - 1e-5)
    halves = {"mu": rel_err(lo[1], mu), "var": rel_err(var(lo[2]), var(sd)),
              "y_max_abs_err": float((torch.cat([lo[0], hi[0]])
                                      - fused[0]).abs().max()),
              "dx_rel_err": rel_err(dx, dfused[0]),
              "dgamma_rel_err": rel_err(dg_lo + dg_hi, dfused[1])}
    return {"case": case, "shape": [m, d],
            "bitwise_fwd": bits_equal(fused, split),
            "bitwise_bwd": bits_equal(dfused, dsplit), "halves": halves,
            "fwd_ms": time_ms(lambda: fused_bn.bn_fwd(x, gamma, beta)),
            "fwd_split_ms": time_ms(lambda: fused_bn.bn_fwd(
                x, gamma, beta, group=group)),
            "bwd_ms": time_ms(lambda: fused_bn.bn_bwd(g, x, gamma, mu, sd)),
            "bwd_split_ms": time_ms(lambda: fused_bn.bn_bwd(
                g, x, gamma, mu, sd, group))}


def split_neuron_layer_case(gen, group, case, t, m, c, k, packed) -> dict:
    """neuron_layer_train at one site: (a) split against fused, spikes and
    statistics bit for bit, and the backward's replay on the split
    forward's global statistics equal to its emitted spikes; (b) the rows
    of each time step cut in two halves, their sums added, each half's
    spikes from the sum, against the whole: mu and var within
    HALVES_LIMIT, the spike mismatch fraction measured; both paths'
    times."""
    x, w, gamma, beta = neuron_layer_train_inputs(gen, t, m, c, k, packed)
    fused = neuron_layer.neuron_layer_train_fwd(x, w, gamma, beta,
                                                packed=packed)
    split = neuron_layer.neuron_layer_train_fwd(x, w, gamma, beta,
                                                packed=packed, group=group)
    h = m // 2
    parts = [x[:, :h].contiguous(), x[:, h:].contiguous()]
    sums_z = [neuron_layer.neuron_layer_train_sums(p, w, packed=packed)
              for p in parts]
    total = sums_z[0][0] + sums_z[1][0]
    out = [neuron_layer.neuron_layer_train_apply(z, gamma, beta, total)
           for _, z in sums_z]
    spikes_h = torch.cat([o[0] for o in out], dim=1)
    torch.cuda.synchronize()
    return {"case": case, "shape": [t, m, c, k], "packed": packed,
            "bitwise": bits_equal(fused[:4], split[:4]),
            "replay_mismatch": replay_mismatch(x, w, gamma, beta, packed,
                                               emitted=split),
            "halves": {"mu": rel_err(out[0][1], fused[1]),
                       "var": rel_err(out[0][2], fused[2]),
                       "spike_mismatch": float(
                           (spikes_h != fused[0]).float().mean())},
            "ms": time_ms(lambda: neuron_layer.neuron_layer_train(
                x, w, gamma, beta, packed=packed)),
            "split_ms": time_ms(lambda: neuron_layer.neuron_layer_train(
                x, w, gamma, beta, packed=packed, group=group))}


def check_split_cases(bn: list[dict], nl: list[dict]) -> None:
    """(a) must hold bit for bit, (b)'s statistics within HALVES_LIMIT."""
    bad = [c["case"] for c in bn if not (c["bitwise_fwd"]
                                         and c["bitwise_bwd"])] + \
        [c["case"] for c in nl if not c["bitwise"] or c["replay_mismatch"]]
    far = [(c["case"], c["halves"]) for c in bn + nl
           if max(c["halves"]["mu"], c["halves"]["var"]) > HALVES_LIMIT]
    if bad or far:
        fail(f"split statistics path: not the fused path's bits at {bad}; "
             f"halves beyond {HALVES_LIMIT} at {far}")


def mesh_vision_run(cfg, seed: int, mesh, ckpt_dir: str) -> dict:
    """``train_vision`` for 1 + MESH_STEPS steps of BATCH images from
    ``seed``, on ``mesh`` or without one, checkpointing after the last
    step: the losses, the timed steps' wall times (host clock between the
    driver's ``on_step`` calls, each once the loss is on the host) and
    the launch counts of the run."""
    stamps = []
    reset_launch_counts()                    # the path starts here
    with contextlib.redirect_stdout(sys.stderr):
        _, history = train_vision(
            cfg, steps=1 + MESH_STEPS, global_batch=BATCH, ckpt_dir=ckpt_dir,
            mesh=mesh, ckpt_every=1 + MESH_STEPS, seed=seed, device=DEVICE,
            on_step=lambda step, m: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    counts = launch_counts()                 # ... and ends here
    return {"history": history, "counts": counts,
            "ms_per_step": [(b - a) * 1e3 for a, b in zip(stamps,
                                                          stamps[1:])]}


def mesh_lm_equal(seed: int, mesh) -> dict:
    """``qwen3-0.6b`` + LIF through the driver, ``cuda-full``, 1 +
    MESH_STEPS steps on ``mesh`` (a (1, 1) mesh: the tensor-parallel code
    path with a model group of none) and without one from the same seed:
    whether every loss and every parameter leaf is bit-equal, and the
    mesh run's launch counts."""
    cfg = lm_train_config("cuda-full")
    runs = {name: lm_train_run(cfg, seed, MESH_STEPS, mesh=m)
            for name, m in (("mesh", mesh), ("no_mesh", None))}
    a, b = (tree_leaves(runs[n]["params"]) for n in ("mesh", "no_mesh"))
    names = tree_paths(runs["mesh"]["params"])
    out = {"losses": {n: r["history"] for n, r in runs.items()},
           "losses_bit_equal": runs["mesh"]["history"]
           == runs["no_mesh"]["history"],
           "leaves": len(names),
           "leaves_differing": [n for n, x, y in zip(names, a, b)
                                if not torch.equal(x, y)],
           "ms_per_step": {n: r["ms_per_step"] for n, r in runs.items()},
           "counts": runs["mesh"]["counts"]}
    del a, b, runs
    torch.cuda.empty_cache()
    return out


#: The expert-parallel path's model on the (1, 1) mesh: the ``moe_train``
#: phase's ``mixtral-8x7b`` + LIF cut, and its decode steps.
MESH_MOE_ARCH = "mixtral-8x7b"
MESH_MOE_DECODE_STEPS = 8


def mesh_moe_equal(seed: int, mesh) -> dict:
    """``mixtral-8x7b`` + LIF (2 layers, published widths, ``cuda-full``)
    through ``launch.train.train``, 1 + MESH_STEPS steps on ``mesh`` (the
    (1, 1) mesh: the expert-parallel code path with a model group of none,
    the MoE's layout bound to a model axis of 1) and without one from the
    same seed, then MESH_MOE_DECODE_STEPS decode steps of 8 slots on the
    mesh and off it from the same weights: whether every loss, every
    parameter leaf and every step's logits are bit-equal, and the mesh
    runs' launch counts."""
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models.lm import init_cache, lm_decode_step
    cfg = lm_train_config("cuda-full", MESH_MOE_ARCH)
    runs = {name: lm_train_run(cfg, seed, MESH_STEPS, mesh=m)
            for name, m in (("mesh", mesh), ("no_mesh", None))}
    a, b = (tree_leaves(runs[n]["params"]) for n in ("mesh", "no_mesh"))
    names = tree_paths(runs["mesh"]["params"])
    out = {"losses": {n: r["history"] for n, r in runs.items()},
           "losses_bit_equal": runs["mesh"]["history"]
           == runs["no_mesh"]["history"],
           "leaves": len(names),
           "leaves_differing": [n for n, x, y in zip(names, a, b)
                                if not torch.equal(x, y)],
           "ms_per_step": {n: r["ms_per_step"] for n, r in runs.items()},
           "counts": runs["mesh"]["counts"]}
    del a, b, runs
    torch.cuda.empty_cache()
    params = build_state(cfg, seed=seed, device=DEVICE)[0]
    toks = torch.randint(0, cfg.vocab_size, (MESH_MOE_DECODE_STEPS, 8, 1),
                         generator=torch.Generator().manual_seed(seed + 7))
    logits = {}
    for name in ("mesh", "no_mesh"):
        cache = init_cache(cfg, 8, 64, torch.float32, DEVICE)
        steps = []
        reset_launch_counts()                # the path starts here
        with use_mesh(mesh) if name == "mesh" else contextlib.nullcontext(), \
                torch.inference_mode():
            for i in range(MESH_MOE_DECODE_STEPS):
                lg, cache = lm_decode_step(
                    params, cache, toks[i].to(DEVICE),
                    torch.full((8,), i, dtype=torch.int32, device=DEVICE),
                    cfg)
                steps.append(lg)
        torch.cuda.synchronize()
        if name == "mesh":
            out["decode_counts"] = launch_counts()   # ... and ends here
        logits[name] = steps
    out["decode_bit_equal"] = all(torch.equal(x, y) for x, y in zip(
        logits["mesh"], logits["no_mesh"]))
    out["decode_steps"] = MESH_MOE_DECODE_STEPS
    del params, logits, cache
    torch.cuda.empty_cache()
    return out


#: The rest of the model axis on the (1, 1) mesh (``mesh_families``): each
#: family's model at published widths, cut in depth (MLA's to
#: ``MOE_LAYERS``; the hybrid to one group, its SSD chunk the training
#: phase's; whisper to 4 + 4 layers), and the decode steps.
MESH_FAMILY_LAYERS = {MOE_ARCH: MOE_LAYERS, RWKV_ARCH: 4, HYBRID_ARCH: 6,
                      "whisper-large-v3": 4}
#: Each family's name in the phase's paths (``mesh_<name>_<path>``).
MESH_FAMILY_NAMES = {MOE_ARCH: "mla", RWKV_ARCH: "rwkv",
                     HYBRID_ARCH: "hybrid", "whisper-large-v3": "whisper"}
MESH_FAMILY_DECODE_STEPS = 8
MESH_FAMILY_PREFILL = (8, 64)          # MLA's prefill tokens (B, S)


def mesh_family_config(arch: str):
    """``arch`` at ``MESH_FAMILY_LAYERS`` (see there), the LIF under
    ``cuda-full`` (whisper never reads it)."""
    cfg = lm_config("cuda-full", arch).replace(
        num_layers=MESH_FAMILY_LAYERS[arch])
    if cfg.family == "audio":
        cfg = cfg.replace(encoder_layers=cfg.num_layers)
    if cfg.ssm is not None:
        cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm,
                                                  chunk=HYBRID_TRAIN_CHUNK))
    return cfg


def family_weights(cfg, seed: int):
    """``build_state``'s weights of ``cfg`` from ``seed`` on the card,
    without its optimizer state."""
    from repro_torch.models.encdec import init_encdec
    init = init_encdec if cfg.family == "audio" else init_lm
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return split_tree(init(gen, cfg, DEVICE))[0]


def mesh_family_decode(params, cfg, mesh, seed: int) -> tuple[list, dict]:
    """``MESH_FAMILY_DECODE_STEPS`` decode steps of 8 slots from a zero
    cache (whisper's from ``init_encdec_cache`` of 8 rows of frames) on
    ``mesh`` or without one: every step's logits and the launch counts of
    the steps (the cache's making not counted)."""
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models.lm import init_cache, lm_decode_step
    gen = torch.Generator().manual_seed(seed + 7)
    toks = torch.randint(0, cfg.vocab_size,
                         (MESH_FAMILY_DECODE_STEPS, 8, 1), generator=gen)
    audio = cfg.family == "audio"
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext(), \
            torch.inference_mode():
        if audio:
            frames = torch.randn((8, cfg.encoder_seq, cfg.d_model),
                                 generator=gen).to(DEVICE)
            cache = init_encdec_cache(params, frames, cfg, 8, 64,
                                      torch.float32)
        else:
            cache = init_cache(cfg, 8, 64, torch.float32, DEVICE)
        step = encdec_decode_step if audio else lm_decode_step
        steps = []
        torch.cuda.synchronize()
        reset_launch_counts()                # the path starts here
        for i in range(MESH_FAMILY_DECODE_STEPS):
            lg, cache = step(params, cache, toks[i].to(DEVICE), torch.full(
                (8,), i, dtype=torch.int32, device=DEVICE), cfg)
            steps.append(lg)
        torch.cuda.synchronize()
        counts = launch_counts()             # ... and ends here
    return steps, counts


def mesh_family_step(cfg, mesh, seed: int) -> tuple[dict, list, dict]:
    """One donated train step (``make_train_step``) of ``cfg`` from
    ``seed``'s weights (whisper's query and key projections times 1/4,
    C7) on the driver's first batch, on ``mesh`` or without one: the
    metrics, the new parameter leaves and the step's launch counts."""
    from repro_torch.launch.train import lm_step_batch
    opt_cfg = OptimizerConfig()
    params, opt, specs = build_state(cfg, mesh, seed=seed, device=DEVICE)
    if cfg.family == "audio":
        qk_scale_(params, 0.25)
    host = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=LM_TRAIN_SEQ,
                                  global_batch=LM_TRAIN_BATCH,
                                  seed=seed)).batch(0)
    batch = lm_step_batch(cfg, host, DEVICE, mesh)
    step = make_train_step(cfg, opt_cfg, mesh=mesh,
                           specs=specs if mesh is not None else None,
                           donate=True)
    torch.cuda.synchronize()
    reset_launch_counts()                    # the path starts here
    params, opt, metrics = step(params, opt, batch)
    torch.cuda.synchronize()
    counts = launch_counts()                 # ... and ends here
    metrics = {k: float(v) for k, v in metrics.items()}
    del opt, batch
    return metrics, tree_leaves(params), counts


def mesh_families_equal(seed: int, mesh) -> tuple[dict, dict]:
    """The rest of the model axis on ``mesh`` (the (1, 1) mesh) against
    the mesh-less run from the same weights. Each family has one code
    path for every mesh: at a model axis of 1 its split arithmetic runs
    with every rank's part the whole and every region op the identity,
    so this holds the mesh's plumbing (the driver's plan, ZeRO-3 over
    "data", the cache's layout) and the one path on the card; the
    collectives of a model axis above 1 run on cards only in the
    four-card bench (``benchmarks/torch/bench_data_parallel.py``): ``deepseek-v2-236b``
    + LIF (MLA, ``MOE_LAYERS``) a prefill of ``MESH_FAMILY_PREFILL``
    tokens and the decode steps; ``rwkv6-7b`` + LIF, ``zamba2-2.7b`` +
    LIF and whisper one train step and the decode steps. Per family:
    whether the logits, the metrics and every parameter leaf are
    bit-equal, and the mesh runs' launch counts, by path."""
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models.lm import lm_prefill
    out, counts = {}, {}
    for arch in MESH_FAMILY_LAYERS:
        cfg = mesh_family_config(arch)
        key = MESH_FAMILY_NAMES[arch]
        row = {"layers": cfg.num_layers}
        t0 = time.perf_counter()
        if arch == MOE_ARCH:
            params = family_weights(cfg, seed)
            toks = torch.randint(0, cfg.vocab_size, MESH_FAMILY_PREFILL,
                                 generator=torch.Generator().manual_seed(
                                     seed + 3)).to(DEVICE)
            logits = {}
            for name, m in (("mesh", mesh), ("no_mesh", None)):
                with use_mesh(m) if m is not None else \
                        contextlib.nullcontext(), torch.inference_mode():
                    torch.cuda.synchronize()
                    reset_launch_counts()    # the path starts here
                    logits[name] = lm_prefill(params, {"tokens": toks}, cfg)
                    torch.cuda.synchronize()
                    if name == "mesh":
                        counts[f"mesh_{key}_prefill"] = launch_counts()
            row["prefill_bit_equal"] = torch.equal(logits["mesh"],
                                                   logits["no_mesh"])
            del logits
        else:
            runs = {name: mesh_family_step(cfg, m, seed)
                    for name, m in (("mesh", mesh), ("no_mesh", None))}
            row["metrics"] = {n: r[0] for n, r in runs.items()}
            row["metrics_bit_equal"] = runs["mesh"][0] == runs["no_mesh"][0]
            row["leaves"] = len(runs["mesh"][1])
            row["leaves_differing"] = sum(
                not torch.equal(a, b) for a, b in zip(runs["mesh"][1],
                                                      runs["no_mesh"][1]))
            counts[f"mesh_{key}_train"] = runs["mesh"][2]
            del runs
            torch.cuda.empty_cache()
            params = family_weights(cfg, seed)
            if cfg.family == "audio":
                qk_scale_(params, 0.25)
        dec = {name: mesh_family_decode(params, cfg, m, seed)
               for name, m in (("mesh", mesh), ("no_mesh", None))}
        row["decode_bit_equal"] = all(torch.equal(a, b) for a, b in zip(
            dec["mesh"][0], dec["no_mesh"][0]))
        counts[f"mesh_{key}_decode"] = dec["mesh"][1]
        row["seconds"] = time.perf_counter() - t0
        out[key] = row
        del params, dec
        torch.cuda.empty_cache()
    return out, counts


def mesh_family_expected(arch: str, path: str) -> dict[str, int]:
    """The launches of a ``mesh_families`` path: the LIF's, once a layer
    in a prefill or a decode step, twice in the train step's forward
    (``remat``'s recompute) and once in its backward; none for whisper."""
    cfg = mesh_family_config(arch)
    layers = 0 if cfg.family == "audio" else cfg.num_layers
    counts = dict.fromkeys(COUNTED, 0)
    if path == "train":
        counts["lif_soma_fwd"] = (2 if cfg.remat else 1) * layers
        counts["lif_soma_bwd"] = layers
    else:
        counts["lif_soma_fwd"] = layers * (
            MESH_FAMILY_DECODE_STEPS if path == "decode" else 1)
    return counts


def mesh_train_phase(seed: int, batch: int, smi: str) -> tuple[dict, dict]:
    """Data parallelism through the driver on a world of 1 (one card, NCCL,
    a file store): the BN kernels' split path at the preset's shapes
    (``split_bn_case``, ``split_neuron_layer_case``); ``train_vision`` at
    ``spikingformer-8-512``, batch 16, ``cuda-full``, full depth, on a
    (1, 1) mesh against the mesh-less driver from the same seed (every
    step's loss and every parameter, BN-state and moment leaf after the
    last step bit-equal, read back from each run's checkpoint; the mesh
    run's checkpoint restored by the mesh-less path equal to its own);
    ``qwen3-0.6b`` + LIF through the driver on the mesh with
    ``compress_grads`` (every step finite, every leaf moved, the residual
    non-zero, the LIF launches per step). Returns the launch counts of the
    mesh runs, by path, and the split-path cases of each BN kernel."""
    from repro_torch.launch.mesh import (init_distributed, make_test_mesh,
                                         shutdown_distributed)
    from repro_torch.launch.train import build_spikingformer_state
    from repro_torch.train import checkpoint as ckpt
    rank, world, _ = init_distributed()
    try:
        mesh = make_test_mesh(world, 1)
        group = mesh.batch_group
        gen = torch.Generator(device=DEVICE).manual_seed(seed + 40)
        bn = [split_bn_case(gen, group, *shape)
              for shape in split_bn_shapes(batch)]
        nl = [split_neuron_layer_case(gen, group, *site)
              for site in neuron_layer_sites(batch)]
        emit("mesh_kernels", world=world, bn=bn, neuron_layer_train=nl,
             card=smi, note="bitwise: the split path (sums, all-reduce, "
                            "apply) against the fused path at a world of "
                            "1; halves: two halves' sums added, against "
                            "the whole batch")
        check_split_cases(bn, nl)
        torch.cuda.empty_cache()

        cfg = get_spikingformer_config(PRESET + "@cuda-full")
        runs = {}
        with tempfile.TemporaryDirectory() as tmp:
            for name, m in (("mesh", mesh), ("no_mesh", None)):
                runs[name] = mesh_vision_run(cfg, seed, m,
                                             os.path.join(tmp, name))
                torch.cuda.empty_cache()
            like = build_spikingformer_state(cfg, seed=seed, device=DEVICE)
            like = {"params": like[0], "state": like[1], "opt": like[2]}
            step = 1 + MESH_STEPS
            got, want = (ckpt.restore_checkpoint(os.path.join(tmp, n), step,
                                                 like)
                         for n in ("mesh", "no_mesh"))
        names = [n for n, _ in ckpt._flatten_with_paths(want)]
        differ = [n for n, a, b in zip(names, tree_leaves(got),
                                       tree_leaves(want))
                  if not torch.equal(a, b)]
        losses_equal = runs["mesh"]["history"] == runs["no_mesh"]["history"]
        per_step = {k: v / step for k, v in runs["mesh"]["counts"].items()}
        del got, want, like
        torch.cuda.empty_cache()

        lm_cfg = lm_train_config("cuda-full")
        lm = lm_train_run(lm_cfg, seed, MESH_STEPS, mesh=mesh,
                          compress_grads=True)
        params = build_state(lm_cfg, seed=seed, device=DEVICE)[0]
        lm["moved_leaves"] = moved_leaves(lm, params)
        leaves = len(tree_leaves(params))
        del params
        torch.cuda.empty_cache()
        emit("mesh_train", world=world, mesh=dict(mesh.shape),
             backend="nccl", card=smi,
             vision={"preset": f"{PRESET}@cuda-full", "batch": batch,
                     "steps": f"1 warm-up + {MESH_STEPS} timed",
                     "losses": {n: r["history"] for n, r in runs.items()},
                     "losses_bit_equal": losses_equal,
                     "leaves": len(names), "leaves_differing": differ,
                     "launches_per_step": per_step,
                     "ms_per_step": {n: r["ms_per_step"]
                                     for n, r in runs.items()},
                     "restore": "the mesh run's checkpoint restored by the "
                                "mesh-less path, against the mesh-less "
                                "run's own"},
             lm={"arch": f"{LM_ARCH}@cuda-full", "compress_grads": True,
                 **{k: v for k, v in lm.items() if k != "history"}})
        if not losses_equal or differ:
            fail(f"mesh_train: the (1, 1) mesh's step is not the mesh-less "
                 f"step's bits: losses {runs['mesh']['history']} vs "
                 f"{runs['no_mesh']['history']}, leaves differing {differ}")
        packs = pack_per_pass(cfg.num_layers, cfg.tokenizer_stages)
        if per_step[PACK_ENTRY] != packs:
            fail(f"mesh_train: {per_step[PACK_ENTRY]} pack launches a step "
                 f"on the mesh, not {packs}")
        check_train_run("mesh_train lm", lm, leaves, 1 + MESH_STEPS,
                        lm_train_expected(1 + MESH_STEPS))
        if not all(r.get("err_norm", 0.0) > 0.0 for r in lm["steps"]):
            fail(f"mesh_train lm: the compression residual is zero at "
                 f"{lm['steps']}")
        eq = mesh_lm_equal(seed, mesh)
        emit("tp_one_by_one", mesh=dict(mesh.shape), card=smi,
             arch=f"{LM_ARCH}@cuda-full",
             **{k: v for k, v in eq.items() if k != "counts"},
             note="the model-axis code path on a model axis of 1 against "
                  "the mesh-less driver")
        if not eq["losses_bit_equal"] or eq["leaves_differing"]:
            fail(f"tp: the LM on the (1, 1) mesh is not the mesh-less run's "
                 f"bits: {eq['losses']}, leaves differing "
                 f"{eq['leaves_differing']}")
        moe = mesh_moe_equal(seed, mesh)
        moe_counts = {"train": moe["counts"], "decode": moe["decode_counts"]}
        emit("mesh_moe", mesh=dict(mesh.shape), card=smi,
             arch=f"{MESH_MOE_ARCH}@cuda-full",
             layers=TRAIN_LAYERS[MESH_MOE_ARCH],
             **{k: v for k, v in moe.items()
                if k not in ("counts", "decode_counts")},
             note="the expert-parallel code path on a model axis of 1 "
                  "against the mesh-less training run and decode")
        if not moe["losses_bit_equal"] or moe["leaves_differing"] or \
                not moe["decode_bit_equal"]:
            fail(f"mesh_moe: {MESH_MOE_ARCH} on the (1, 1) mesh is not the "
                 f"mesh-less run's bits: losses {moe['losses']}, leaves "
                 f"differing {moe['leaves_differing']}, decode bit-equal "
                 f"{moe['decode_bit_equal']}")
        layers = TRAIN_LAYERS[MESH_MOE_ARCH]
        want = lm_train_expected(1 + MESH_STEPS, MESH_MOE_ARCH)
        if moe["counts"] != want or moe["decode_counts"] != lm_expected(
                layers * MESH_MOE_DECODE_STEPS):
            fail(f"mesh_moe launch counts: train {moe['counts']} (want "
                 f"{want}), decode {moe['decode_counts']} (want "
                 f"{layers * MESH_MOE_DECODE_STEPS} lif_soma_fwd)")
        del moe
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        fam, fam_counts = mesh_families_equal(seed, mesh)
        emit("mesh_families", mesh=dict(mesh.shape), card=smi,
             seconds=time.perf_counter() - t0, families=fam,
             launches={p: {k: v for k, v in c.items() if v}
                       for p, c in fam_counts.items()},
             note="MLA, the recurrent heads and the encoder-decoder on a "
                  "model axis of 1 against the mesh-less paths")
        unequal = [f"{k} {f}" for k, row in fam.items() for f in (
            "prefill_bit_equal", "metrics_bit_equal", "decode_bit_equal")
            if row.get(f) is False] + \
            [f"{k} leaves" for k, row in fam.items()
             if row.get("leaves_differing")]
        if unequal:
            fail(f"mesh_families: not the mesh-less bits: {unequal}")
        arch_of = {v: k for k, v in MESH_FAMILY_NAMES.items()}
        for path, got in fam_counts.items():
            _, key, kind = path.split("_", 2)
            want = mesh_family_expected(arch_of[key], kind)
            if got != want:
                fail(f"mesh_families launch counts on {path}: {got} "
                     f"(want {want})")
        return {"mesh_train": runs["mesh"]["counts"],
                "mesh_lm_train": lm["counts"],
                "tp_lm_train": eq["counts"],
                "mesh_moe_train": moe_counts["train"],
                "mesh_moe_decode": moe_counts["decode"],
                **fam_counts}, \
            {"bn_fwd": bn, "bn_bwd": bn, "neuron_layer_train": nl}
    finally:
        shutdown_distributed()


# ---------------------------------------------------------------------------
# The tensor-parallel kernel cases: one rank's site shapes on a model axis
# ---------------------------------------------------------------------------

#: The model axes whose per-rank site shapes the ``tp`` phase runs.
TP_SHARDS = (2, 4, 8)
#: The sites whose shapes the model axis changes.
TP_SITES = ("pssa.qkv", "smlp.a", "pssa.proj", "smlp.b", "attn_qk",
            "attn_av")


def tp_kernel_cases(gen, batch: int, shards: int) -> dict[str, list[dict]]:
    """Every kernel of the training path (and the eval arm of the neuron
    layer) at one rank's shapes on a model axis of ``shards``, checked as
    the ``kernels`` cases are (plain version, cold and warm device time,
    bound, plain time): the column-parallel neuron layers at K / M, the
    row-parallel spike products at C / M (bitwise on 21-bit weights too),
    ``attn_qk`` and the ``attn_av``-style product on h / M heads, the LIF
    of the attention output on D / M columns. The BN kernels run after the
    row-parallel sum on the whole D, the shapes of the ``kernels`` cases."""
    cfg = get_spikingformer_config(PRESET)
    t, d, f, h = cfg.time_steps, cfg.d_model, cfg.d_ff, cfg.n_heads
    n, dh = cfg.num_tokens, cfg.d_model // cfg.n_heads
    m, hl = batch * n, h // shards
    out: dict[str, list[dict]] = {name: [] for name in KERNELS}

    def tag(site):
        return f"{site}@model={shards}"
    for site, k in (("pssa.qkv", d // shards), ("smlp.a", f // shards)):
        out["neuron_layer_train"].append(check_neuron_layer_train(
            gen, tag(site), t, m, d, k, True))
        out["neuron_layer_eval"].append(check_neuron_layer(
            gen, tag(site), t, m, d, k, True))
        torch.cuda.empty_cache()
    for site, c in (("pssa.proj", d // shards), ("smlp.b", f // shards)):
        packed = spike_matmul.spike_pack(spikes(gen, (t * m, c)))
        w = torch.randn((c, d), generator=gen, device=DEVICE) * c ** -0.5
        exact = (spike_matmul.spike_pack(at_most_12(
            spikes(gen, (t * m, c), rate=min(1.0, 8 / c)))),
            int21(gen, (c, d)))
        out["spike_matmul_packed"].append(check_matmul(
            tag(site), packed, w, spike_matmul.spike_matmul_packed,
            exact=exact))

    def heads(a):
        return a.view(t * batch, n, hl, dh).permute(0, 2, 1, 3)
    bmm = spike_matmul.spike_matmul_packed_batched
    q, k = (spikes(gen, (t * batch, n, hl * dh)) for _ in range(2))
    out["spike_matmul_packed_batched"].append(check_matmul(
        tag("attn_qk"), spike_matmul.spike_pack(heads(q)),
        heads(k).transpose(-1, -2), bmm))
    v = spikes(gen, (t * batch, hl, 64, dh))
    attn = torch.randint(0, dh, (t * batch, hl, 64, 64), generator=gen,
                         device=DEVICE).float()
    out["spike_matmul_packed_batched"].append(check_matmul(
        tag("attn_av(N=64)"), spike_matmul.spike_pack(v.transpose(-1, -2)),
        attn.transpose(-1, -2), bmm))
    out["lif_soma_fwd"].append(check_lif(gen, t, m, d // shards,
                                         case=tag("pssa.lif(out)")))
    out["lif_soma_bwd"].extend(check_lif_bwd(gen, t, m, d // shards,
                                             case=tag("pssa.lif(out)")))
    torch.cuda.empty_cache()
    return out


def tp_oracle_cases(gen, batch: int, shards: int) -> list[dict]:
    """Each contract of the model axis's sites at one rank's shapes
    (``config_cases(cfg, batch, shards)``, ``cuda-full``) launched and held
    against its oracle (``hold_against_oracle``: a neuron layer's spikes
    the oracle's outside the band around the threshold)."""
    from repro_torch.analysis.contracts import (config_cases,
                                                hold_against_oracle)
    from repro_torch.kernels.contract import SkipCase
    cfg = get_spikingformer_config(PRESET + "@cuda-full")
    rows, seen = [], set()
    for site, decl, case in config_cases(cfg, batch, shards):
        if site not in TP_SITES or (decl.name, case) in seen:
            continue
        seen.add((decl.name, case))
        try:
            rows.append({"site": site, "model": shards,
                         **hold_against_oracle(decl, case, gen)})
        except SkipCase:
            continue
        torch.cuda.empty_cache()
    return rows


def tp_phase(seed: int, batch: int, cases: dict[str, list[dict]],
             smi: str) -> None:
    """The ``tp`` phase: :func:`tp_kernel_cases` and
    :func:`tp_oracle_cases` on model axes of 2, 4 and 8; the kernel cases
    join ``cases`` (the ``kernels`` line). Launches made here are
    comparisons: the counts are left as they were."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 60)
    counts = launch_counts()
    t0 = time.perf_counter()
    oracle, by_shards = [], {}
    for shards in TP_SHARDS:
        rows = tp_kernel_cases(gen, batch, shards)
        for name, r in rows.items():
            cases[name].extend(r)
        by_shards[shards] = {name: [{k: c.get(k) for k in (
            "case", "shape", "max_abs_err", "ms", "device_ms",
            "device_ms_l2_warm", "plain_ms", "library_ms", "bound_ms",
            "bound_by")} for c in r] for name, r in rows.items() if r}
        oracle += tp_oracle_cases(gen, batch, shards)
    torch.cuda.synchronize()
    set_launch_counts(counts)
    bad = [r for r in oracle if not r["ok"]]
    emit("tp", preset=PRESET, batch=batch, model=list(TP_SHARDS), card=smi,
         kernels=by_shards, oracle_cases=len(oracle),
         oracle=[{k: r.get(k) for k in ("site", "model", "contract", "case",
                                         "packed", "ok", "max_abs_err",
                                         "spikes", "tolerance")}
                 for r in oracle],
         seconds=time.perf_counter() - t0)
    if bad:
        fail(f"tp: {len(bad)} case(s) beyond the oracle's tolerance: "
             f"{bad[:3]}")
    if not oracle:
        fail("tp: no contract of the model axis's sites was held against "
             "its oracle")


# ---------------------------------------------------------------------------
# Phase 9: the autotuner and dispatch under its table (spikingformer-8-512)
# ---------------------------------------------------------------------------

#: The tunable sites of the preset under ``cuda-full`` and their impls
#: (``attn_av`` demotes at N = 196 and has no knob).
TUNABLE_SITES = {**{f"tokenizer.conv.{i}": "fused_epilogue"
                    for i in range(4)},
                 "pssa.qkv": "fused_epilogue", "smlp.a": "fused_epilogue",
                 "pssa.proj": "cuda+spike_mm", "smlp.b": "cuda+spike_mm",
                 "attn_qk": "cuda_packed"}
TUNE_REPS = 10                  # timed calls a candidate, after a warm-up


#: The CUDA kernels behind each wrapper's launches, by the start of their
#: names in ``csrc/`` (as the profiler lists them).
KERNEL_SYMBOLS = {"lif_soma_fwd": "lif_fwd_", "lif_soma_bwd": "lif_bwd_",
                  "spike_matmul_packed": "spike_mma_kernel",
                  "spike_matmul_packed_batched": "spike_mma_kernel",
                  "bn_fwd": "bn_fwd_", "bn_bwd": "bn_bwd_",
                  "neuron_layer_train": "neuron_layer_train_",
                  "neuron_layer_eval": "neuron_layer_eval_",
                  PACK_ENTRY: "spike_pack_kernel"}


def busy_ms(fn, launched: dict[str, int]) -> float | None:
    """Device busy ms of one call of ``fn``: the sum of the device times of
    its kernels (``pass_ms``, one call a profiling session). None (not
    measured) when no two sessions agree, or when the profile lacks a
    kernel that ``launched``, the call's launch counts, says it ran.
    (``queued_ms`` cannot hold a forward or a step: their thousands of
    launches fill the launch queue behind the held stream.)"""
    passes = pass_ms(fn, iters=1)
    names = " ".join(passes)
    if not passes or any(n and KERNEL_SYMBOLS[k] not in names
                         for k, n in launched.items()):
        return None
    return sum(passes.values())


@contextlib.contextmanager
def tuned_table(path):
    """Dispatch consults the table at ``path`` inside (None: no table, as
    every other phase runs)."""
    from repro_torch.tune import table
    old = os.environ.pop(table.ENV_VAR, None)
    if path is not None:
        os.environ[table.ENV_VAR] = str(path)
    table.reload()
    try:
        active = table.active_table()
        if (path is None) != (not active):
            fail(f"expected {'no' if path is None else 'the'} tuned table, "
                 f"found {len(active)} entries ({table.table_path()})")
        yield active
    finally:
        os.environ.pop(table.ENV_VAR, None)
        if old is not None:
            os.environ[table.ENV_VAR] = old
        table.reload()


def candidate_row(cand, us) -> dict:
    tile = cand.as_tuned().tile()
    return {"arm": cand.arm, "block_m": cand.block_m,
            "block_k": cand.block_k, "block_c": cand.block_c,
            "tile": spike_matmul.TILES[tile].name if tile else None,
            "oracle_cycles": cand.cycles, "us": us}


def todays_choice(wl) -> dict:
    """What dispatch runs at ``wl`` without a table: the fused arm at a
    fused-epilogue site, else the spike matmul's tile by its rule."""
    if wl.impl == "fused_epilogue":
        return {"arm": "fused", "tile": None}
    rows = wl.shape[-3]
    return {"arm": None,
            "tile": spike_matmul.TILES[spike_matmul.default_tile(rows)].name}


def tune_sites(cfg, batch, report) -> tuple:
    """Steps 2-3: the preset's tunable sites, then the timed sweep with the
    L2 cold; one line per site."""
    from repro_torch.tune import autotune, workloads
    wls = workloads.site_workloads(cfg, batch, report.site_sparsity())
    tunable = {w.site: w.impl for w in wls if w.tunable}
    emit("tune_workloads", preset=f"{PRESET}@cuda-full", batch=batch,
         sites=[{"site": w.site, "op": w.op, "impl": w.impl,
                 "packed": w.packed, "shape": list(w.shape),
                 "calls": w.calls, "trailing_lif": w.trailing_lif,
                 "in_sparsity": w.mm.in_sparsity if w.mm else None,
                 "tunable": w.tunable} for w in wls])
    if tunable != TUNABLE_SITES:
        fail(f"tunable sites {tunable} != {TUNABLE_SITES}")
    rep = autotune.tune(cfg, batch=batch, reps=TUNE_REPS, sparsity=report,
                        device=DEVICE)
    moved = {}
    for res in rep.results:
        wl, win = res.workload, candidate_row(res.winner, res.winner_us)
        today = todays_choice(wl)

        def is_today(c):
            if today["arm"] == "fused":
                return c.arm == "fused"
            return candidate_row(c, None)["tile"] == today["tile"]
        today_us = next(us for c, us in res.timed if is_today(c))
        off = not is_today(res.winner)
        if off:
            moved[wl.site] = {"today": today, "today_us": today_us,
                              "winner": win,
                              "saved_us": today_us - res.winner_us}
        emit("tune_site", site=wl.site, op=wl.op, impl=wl.impl,
             shape=list(wl.shape), packed=wl.packed,
             in_sparsity=wl.mm.in_sparsity,
             candidates=[candidate_row(c, us) for c, us in res.timed],
             winner=win, winner_is_oracle_first=res.winner_in_top1,
             today=today, today_us=today_us, moves_off_today=off,
             timing=f"CUDA events over {TUNE_REPS} calls after a warm-up, "
                    f"L2 cold (l2_cold)")
    if len(rep.entries) != len(TUNABLE_SITES) or \
            rep.device_kind != torch.cuda.get_device_name(0).replace(" ",
                                                                    "-"):
        fail(f"tuned {len(rep.entries)} sites under {rep.device_kind!r}")
    return rep, moved


def tuned_forward(full, img, path) -> dict:
    """One forward of ``full`` with or without the table: logits, taps,
    the forward's launch counts (set to 0 just before it, read just after)
    and its device busy time."""
    with tuned_table(path):
        taps: list = []
        reset_launch_counts()
        logits = full(img, taps=taps)
        torch.cuda.synchronize()
        counts = launch_counts()
        busy = busy_ms(lambda: full(img), counts)
    return {"logits": logits, "taps": taps, "launches": counts,
            "busy_ms": busy}


def tuned_step(cfg, params, state, images, labels, path) -> dict:
    """The train-mode forward (taps) and one ``make_train_step`` step with
    or without the table, from the same state: the forward's taps, the
    step's metrics, its launch counts (set to 0 just before the step, read
    just after), its peak memory and its device busy time."""
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=100,
                              weight_decay=0.01)
    with tuned_table(path):
        taps: list = []
        with torch.no_grad():
            spikingformer_apply(params, state, images, cfg, train=True,
                                taps=taps)
        step = make_train_step(cfg, opt_cfg)
        opt = init_opt_state(params)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        _, _, _, m = step(params, state, opt, images, labels)
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        busy = busy_ms(lambda: step(params, state, opt, images, labels),
                       counts)
        replay = step_replay_check(cfg, params, state, images)
    return {"taps": taps, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]), "launches": counts,
            "peak_memory_bytes": peak, "busy_ms": busy, "replay": replay}


def block_mismatch_same_input(cfg, params, state, taps, path) -> list:
    """Each block in train mode under the table, fed the untuned forward's
    input to it: its spikes against the untuned forward's (after the next
    block's LIF)."""
    out = []
    with tuned_table(path), torch.no_grad():
        for i in range(cfg.num_layers):
            y, _ = block_apply(_index_tree(params["blocks"], i),
                               _index_tree(state["blocks"], i), taps[i],
                               cfg.block, train=True)
            out.append(spike_mismatch(y, taps[i + 1], cfg.lif))
    return out


def energy_line(report) -> None:
    """Step 5: the paper's energy model over its preset's training workload
    for all nine dataflows, at the default and at the measured sparsity."""
    from repro_torch.core.energy import (E2ATSTSimulator,
                                         SpikingWorkloadConfig)
    rows = {}
    for name, sp in (("default", None), ("measured", report.aggregate())):
        wl = SpikingWorkloadConfig() if sp is None else \
            SpikingWorkloadConfig(sparsity=sp)
        sim = E2ATSTSimulator(wl)
        rows[name] = {
            "sparsity": dataclasses.asdict(wl.sparsity),
            "dataflows": {n: {"energy_mj": r.energy_j * 1e3,
                              "latency_ms": r.latency_s * 1e3,
                              "energy_mj_by_stage": {
                                  st: b.energy_j * 1e3
                                  for st, b in r.stages.items()}}
                          for n, r in sim.sweep().items()},
            "optimal_energy": sim.optimal("energy").dataflow,
            "optimal_latency": sim.optimal("latency").dataflow,
            "table_ix": sim.table_ix()}
    emit("tune_energy_model",
         model="the paper's 28 nm ASIC model (E2ATST section IV-V, eq. "
               "26-28; 64 x 64 array at 500 MHz), arithmetic on the "
               "preset's training workload: not a reading of this card",
         **rows)


def tune_phase(seed: int, batch: int) -> dict[str, int]:
    """The autotuner at the preset, full width and depth, under
    ``cuda-full``: (1) sparsity measured on the card; (2) the nine tunable
    sites; (3) the timed sweep, L2 cold; (4) a table keyed by the card
    written, reloaded and consulted by a forward of ``batch`` images and a
    training step, each against the same call without a table (exact
    weights: spikes bit-equal where every neuron-layer site keeps its fused
    arm, else each block held at the per-block limit on the same input; the
    step's replay intact); (5) the paper's energy model at the default and
    the measured sparsity. Returns the launch counts of the path under
    the table: the tuned forward's and the tuned step's (the sweep, the
    profiler's and the checks' launches are not the path's)."""
    from repro_torch.tune import sparsity, table

    cfg = get_spikingformer_config(PRESET + "@cuda-full")
    t0 = time.perf_counter()
    seconds = {}

    def lap(name):
        seconds[name] = time.perf_counter() - t0 - sum(seconds.values())

    report = sparsity.measure_sparsity(cfg, batch=batch, seed=seed,
                                       device=DEVICE)
    lap("sparsity")
    agg = report.aggregate()
    emit("tune_sparsity", preset=PRESET, batch=batch, seed=seed,
         operand=report.operand, spike=report.spike, mask=report.mask,
         aggregate=dataclasses.asdict(agg),
         note="zeros-fractions of one train-mode forward under the probe "
              "policy (eager), weights and images from the seed; s_pg "
              "keeps the paper's default")
    rep, moved = tune_sites(cfg, batch, report)
    torch.cuda.empty_cache()
    lap("sweep")

    eager, make_images = make_model(seed, cfg.num_layers, batch, "dyadic")
    full = eager.with_policy(named_policy("cuda-full"))
    img = make_images()
    labels = torch.randint(0, cfg.num_classes, (batch,),
                           generator=torch.Generator().manual_seed(seed)
                           ).to(DEVICE)
    params, state = full.params, full.state
    lap("model")
    demoted = {r.workload.site for r in rep.results
               if r.winner.arm == "pipeline"}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "tuned_blocks.json"
        table.save_table(path, rep.entries,
                         meta={"device_kind": rep.device_kind})
        with tuned_table(path) as active:
            if len(active) != len(TUNABLE_SITES):
                fail(f"the written table loads {len(active)} entries")
            described = full.cfg.describe_execution().split("\n\n")[1]
        fwd = {name: tuned_forward(full, img, p)
               for name, p in (("untuned", None), ("tuned", path))}
        lap("forward")
        fwd_equal = torch.equal(fwd["tuned"]["logits"],
                                fwd["untuned"]["logits"]) and all(
            torch.equal(a, b) for a, b in zip(fwd["tuned"]["taps"],
                                              fwd["untuned"]["taps"]))
        stp = {name: tuned_step(full.cfg, params, state, img, labels, p)
               for name, p in (("untuned", None), ("tuned", path))}
        step_equal = all(torch.equal(a, b) for a, b in
                         zip(stp["tuned"]["taps"], stp["untuned"]["taps"]))
        per_block = block_mismatch_same_input(
            full.cfg, params, state, stp["untuned"]["taps"], path)
        tok = float((stp["tuned"]["taps"][0] !=
                     stp["untuned"]["taps"][0]).float().mean())
        lap("step")
    fused_kept = not demoted
    tolerance = ("exact weights: forward logits and spikes bit-equal; the "
                 "training step's spikes bit-equal when every neuron-layer "
                 "site keeps its fused arm, else each block's spikes on the "
                 f"untuned input within {SPIKE_LIMIT} (batch statistics "
                 "over T*M rows summed by other kernels)")
    emit("tune_table", device_kind=rep.device_kind, entries=len(rep.entries),
         describe=described, moved_off_today=moved,
         demoted_to_pipeline=sorted(demoted),
         forward={k: {"launches": v["launches"],
                      "device_busy_ms": v["busy_ms"]}
                  for k, v in fwd.items()},
         forward_bit_equal=fwd_equal,
         step={k: {"launches": v["launches"],
                   "device_busy_ms": v["busy_ms"],
                   "peak_memory_bytes": v["peak_memory_bytes"],
                   "loss": v["loss"], "grad_norm": v["grad_norm"],
                   "replay": v["replay"]} for k, v in stp.items()},
         step_spikes_bit_equal=step_equal,
         step_mismatch_tokenizer=tok,
         step_mismatch_per_block_same_input=per_block,
         tolerance=tolerance, note="busy times and peak memory are "
         "findings, not claims")
    if not fwd_equal:
        fail("the forward under the tuned table differs from the untuned "
             "one on exact weights")
    if fused_kept and (not step_equal or
                       stp["tuned"]["loss"] != stp["untuned"]["loss"]):
        fail("the training step under the tuned table differs from the "
             "untuned one on exact weights with every fused arm kept")
    if not fused_kept and (max(per_block) > SPIKE_LIMIT or tok > SPIKE_LIMIT):
        fail(f"the tuned training step's spikes differ beyond {SPIKE_LIMIT}: "
             f"tokenizer {tok}, blocks {per_block}")
    sites = 4 * cfg.num_layers + cfg.tokenizer_stages - sum(
        r.workload.calls for r in rep.results if r.winner.arm == "pipeline")
    for name, v in stp.items():
        want = sites if name == "tuned" else \
            4 * cfg.num_layers + cfg.tokenizer_stages
        if v["replay"]["mismatch"] or v["replay"]["sites"] != want:
            fail(f"the {name} step's replay: {v['replay']} (sites {want})")
    # in eval a table changes tiles only; in train it changes launches only
    # where it demotes a site
    per_step = per_train_step(cfg.num_layers, cfg.tokenizer_stages)
    if fwd["tuned"]["launches"] != fwd["untuned"]["launches"]:
        fail(f"the tuned forward's launches {fwd['tuned']['launches']} != "
             f"the untuned forward's {fwd['untuned']['launches']}")
    for name, v in stp.items():
        if (name == "untuned" or not demoted) and v["launches"] != per_step:
            fail(f"the {name} step's launches {v['launches']} != {per_step}")
    counts = {k: fwd["tuned"]["launches"][k] + stp["tuned"]["launches"][k]
              for k in COUNTED}
    fused = {s for s, impl in TUNABLE_SITES.items()
             if impl == "fused_epilogue"}
    path = {k for k in COUNTED if fwd["untuned"]["launches"][k] +
            stp["untuned"]["launches"][k]} - (
        {"neuron_layer_train"} if demoted == fused else set())
    if any(counts[k] == 0 for k in path):
        fail(f"a kernel of the tuned path never launched: {counts}")
    energy_line(report)
    lap("energy_model")
    emit("tune", seconds=time.perf_counter() - t0, seconds_by_step=seconds,
         launches=counts, launches_from="the tuned forward and the tuned "
         "step, each counted from 0 just before it")
    return counts


# ---------------------------------------------------------------------------
# The analysis phase: contracts, audit, every kernel against the oracles
# ---------------------------------------------------------------------------

def analysis_phase(seed: int) -> dict[str, dict]:
    """``python -m repro_torch.analysis --audit --contracts`` on the card:
    the contract families with the launch family over every declared case
    at batch ``BATCH`` (each launch read from the plan exports, none made
    and none counted) and the plan audit at the same batch; then each of
    the eleven contracts at each of its site geometries at batch 1 launched
    and held against ``kernels/ref.py``
    (``analysis.contracts.hold_against_oracle``: bitwise or 1e-6 for the
    LIF kernels, the matmul and BN tolerances elsewhere, a neuron layer's
    spikes exactly the oracle's outside the band around the threshold).
    Fails on any ``error`` finding, a case out of tolerance, or a launch
    family that did not run. Prints the ``analysis`` line; returns per
    kernel its largest error against the oracles (``max_abs_err``, None
    where the kernel returns spikes alone) and, for a neuron layer, its
    spike counts summed over the cases. The oracle comparisons' launches do
    not count: the counts are left as they were."""
    from collections import Counter

    from repro_torch.analysis.audit import run_audit
    from repro_torch.analysis.contracts import (hold_against_oracle,
                                                kernel_cases,
                                                launch_family_ran,
                                                run_contracts)
    from repro_torch.kernels.contract import SkipCase, kernel_contracts

    t0 = time.perf_counter()
    findings = run_contracts(batch=BATCH, launches=True) + \
        run_audit(batch=BATCH)
    errors = [f.format() for f in findings if f.level == "error"]
    if errors:
        fail(f"analysis: {len(errors)} error finding(s): {errors[:5]}")
    if not launch_family_ran(findings):
        fail("analysis: the launch family of the contracts did not run")
    static_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    counts = launch_counts()
    rows = []
    for where, decl, case in kernel_cases(batch=1):
        try:
            rows.append({"where": where,
                         **hold_against_oracle(decl, case, gen)})
        except SkipCase:
            continue
    torch.cuda.synchronize()
    set_launch_counts(counts)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"analysis: {len(bad)} case(s) beyond the oracle's tolerance: "
             f"{bad[:3]}")
    decls = kernel_contracts()
    missing = set(decls) - {r["contract"] for r in rows}
    if missing:
        fail(f"analysis: contracts never held against the oracle: "
             f"{sorted(missing)}")
    per_contract: dict[str, dict] = {}
    oracle: dict[str, dict] = {}
    for r in rows:
        c = per_contract.setdefault(r["contract"], {
            "cases": 0, "max_abs_err": None, "bitwise": 0, "spikes": None,
            "tolerance": r["tolerance"]})
        c["cases"] += 1
        c["bitwise"] += bool(r["bitwise"])
        for into in (c, oracle.setdefault(decls[r["contract"]].kernel, {
                "max_abs_err": None, "spikes": None})):
            if r["max_abs_err"] is not None:
                into["max_abs_err"] = max(into["max_abs_err"] or 0.0,
                                          r["max_abs_err"])
            if r["spikes"] is not None:
                into["spikes"] = {k: (into["spikes"] or {}).get(k, 0) + v
                                  for k, v in r["spikes"].items()}
    by_family = Counter(f"{f.check}:{f.level}" for f in findings)
    wgmma = wgmma_launch_family(gen)
    oracle[WGMMA_ENTRY] = {"max_abs_err": wgmma["max_abs_err"],
                           "spikes": None}
    heads = wgmma_launch_family(gen, None, spike_matmul.HEADS, "heads")
    oracle[HEADS_ENTRY] = {"max_abs_err": heads["max_abs_err"],
                           "spikes": None}
    z_wgmma = wgmma_launch_family(
        gen, lambda decl: decl.name == "neuron_layer_train",
        neuron_layer.Z_WGMMA, "z_wgmma")
    oracle[Z_WGMMA_ENTRY] = {"max_abs_err": z_wgmma["max_abs_err"],
                             "spikes": z_wgmma["spikes"]}
    eval_wgmma = wgmma_launch_family(
        gen, lambda decl: decl.name == "neuron_layer_eval",
        neuron_layer.EVAL_WGMMA, "eval_wgmma")
    oracle[EVAL_WGMMA_ENTRY] = {"max_abs_err": eval_wgmma["max_abs_err"],
                                "spikes": eval_wgmma["spikes"]}
    emit("analysis", findings=dict(sorted(by_family.items())),
         launch_cases=next(f.message for f in findings
                           if f.check == "audit.kernel.launch"
                           and f.where == "matrix"),
         oracle_cases=len(rows), oracle=per_contract, wgmma=wgmma,
         heads=heads, z_wgmma=z_wgmma, eval_wgmma=eval_wgmma,
         static_seconds=static_s,
         seconds=time.perf_counter() - t0)
    return oracle


def wgmma_launch_family(gen, select=None, code=None,
                        what: str = "wgmma") -> dict:
    """A bf16 wgmma kernel in the analysis phase: every contract case of
    the matrix at batch ``BATCH`` that ``select(decl)`` takes (by default
    the spike matmul's), in bf16 (the matrix's cases are fp32), its
    launches read from the plan exports and held to the card's limits
    (``check_launch_contract``); each case whose launches run plan kernel
    ``code`` (by default 3, the spike matmul's wgmma kernel; its heads
    kernel is ``spike_matmul.HEADS``, the neuron layer's bf16 z pass
    ``neuron_layer.Z_WGMMA``, its bf16 eval arm ``neuron_layer.EVAL_WGMMA``)
    is then launched and
    held against ``kernels/ref.py`` (exact operands: the oracle's bits, a
    neuron layer's spikes outside the band). Fails on a finding, a case
    out of tolerance, or no case on the kernel. The launches do not
    count: the counts are left as they were."""
    from collections import Counter

    from repro_torch.analysis.contracts import (check_launch_contract,
                                                hold_against_oracle,
                                                kernel_cases, read_launches)
    from repro_torch.kernels.contract import SkipCase

    select = select or (lambda decl: decl.kernel.startswith("spike_matmul")
                        and decl.name != PACK_ENTRY)
    code = spike_matmul.WGMMA if code is None else code
    counts = launch_counts()
    seen, findings, codes, held = set(), [], Counter(), []
    for where, decl, case in kernel_cases(batch=BATCH):
        if not select(decl):
            continue
        case16 = dataclasses.replace(case, dtype="bfloat16")
        if (decl.name, case16) in seen:
            continue
        seen.add((decl.name, case16))
        try:
            args, fn_kwargs, _ = decl.build(case16)
        except SkipCase:
            continue
        calls = read_launches(decl, args, fn_kwargs)
        findings += check_launch_contract(calls, f"{where}[bf16]")
        kinds = [launch.kernel for call in calls
                 if call.entry != "e2a_spike_pack" for launch in call.launches]
        codes.update(kinds)
        if code in kinds:
            held.append({"where": where,
                         **hold_against_oracle(decl, case16, gen)})
    torch.cuda.synchronize()
    set_launch_counts(counts)
    errors = [f.format() for f in findings if f.level == "error"]
    bad = [r for r in held if not r["ok"]]
    if errors or bad or not held:
        fail(f"analysis, {what}: {len(errors)} launch finding(s) "
             f"{errors[:3]}, {len(bad)} case(s) beyond the oracle's "
             f"tolerance {bad[:2]}, {len(held)} case(s) on plan kernel "
             f"{code}")
    errs = [r["max_abs_err"] for r in held if r["max_abs_err"] is not None]
    spikes = [r["spikes"] for r in held if r["spikes"] is not None]
    return {"cases": len(seen),
            "launches_read_by_plan_kernel": dict(sorted(codes.items())),
            "held": len(held), "bitwise": sum(bool(r["bitwise"]) for r in held),
            "max_abs_err": max(errs) if errs else None,
            "spikes": {k: sum(v[k] for v in spikes) for k in spikes[0]}
            if spikes else None,
            "shapes": sorted({tuple(r["case"]) for r in held})}


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 11: the dry run held against the card (launch/dryrun.py)
# ---------------------------------------------------------------------------

#: The estimated peak of a step within this share of the measured one.
DRYRUN_PEAK_BAND = 0.15
#: The counted flops may undercount the model's by this much at most.
DRYRUN_RATIO_MAX = 1.05
#: The production cell counted on ``data16`` (well under 90 s on the host).
DRYRUN_CELL = (LM_ARCH, "decode_32k")
DRYRUN_TIMEOUT_S = 300


def dryrun_cells() -> dict:
    """The two training steps this script measures, as they run in it: name
    -> (config, ``launch.specs.ShapeSpec``); a world of 1, fp32."""
    from repro_torch.launch.specs import ShapeSpec
    return {"train": (get_spikingformer_config(PRESET + "@cuda-full"),
                      ShapeSpec("train", 0, BATCH)),
            "lm_train": (lm_train_config("cuda-full"),
                         ShapeSpec("train", LM_TRAIN_SEQ, LM_TRAIN_BATCH))}


def dryrun_child(path: str) -> None:
    """The estimating side of the phase, in its own process (the parent's
    card work and process groups stay apart from the dry run's): each step
    of :func:`dryrun_cells` counted on ``meta`` tensors at a world of 1
    (``launch.specs.input_specs`` on a (1, 1) abstract mesh gives the
    mesh-less step the phases ran), written to ``path`` as JSON."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.specs import input_specs
    world1 = AbstractMesh(("data", "model"), (1, 1))
    out = {}
    for name, (cfg, shape) in dryrun_cells().items():
        fn, structs, _ = input_specs(cfg, shape, world1)
        counts = dryrun.count_step(fn, structs)
        del structs
        out[name] = dryrun.cell_result(getattr(cfg, "name", PRESET), shape,
                                       cfg, counts, "world1", 1)
    with open(path, "w") as f:
        json.dump(out, f)


def run_child(cmd: list[str], what: str, phase: str = "dryrun",
              timeout: float = DRYRUN_TIMEOUT_S) -> subprocess.CompletedProcess:
    """``cmd`` in a process of its own with ``src`` on its path; fails the
    script on a non-zero exit (``phase`` names the phase) and kills the
    process past ``timeout`` seconds."""
    return run_children({what: cmd}, phase, timeout)[what][0]


def run_children(cmds: dict[str, list[str]], phase: str,
                 timeout: float) -> dict[str, tuple]:
    """Each of ``cmds`` (what it is -> its command) in a process of its
    own with ``src`` on its path, all started together: independent
    children overlap, so a phase takes about its longest child.
    ``{what: (CompletedProcess, seconds)}``, the seconds from the start to
    that child's exit (to 0.1 s). Fails the script on a non-zero exit
    (``phase`` names the phase); kills every child still running past
    ``timeout`` seconds, or when the script stops for any other reason."""
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent
                                           / "src")}
    files = {what: (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile(
        "w+")) for what in cmds}
    t0 = time.perf_counter()
    procs = {what: subprocess.Popen(cmd, stdout=files[what][0],
                                    stderr=files[what][1], text=True,
                                    env=env)
             for what, cmd in cmds.items()}
    ended: dict[str, float] = {}
    try:
        while len(ended) < len(procs):
            for what, proc in procs.items():
                if what not in ended and proc.poll() is not None:
                    ended[what] = time.perf_counter() - t0
            if time.perf_counter() - t0 > timeout:
                raise subprocess.TimeoutExpired(
                    [w for w in procs if w not in ended], timeout)
            time.sleep(0.1)
    finally:
        for proc in procs.values():       # none is left running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = {}
    for what, proc in procs.items():
        text = []
        for f in files[what]:
            f.seek(0)
            text.append(f.read())
            f.close()
        done = subprocess.CompletedProcess(proc.args, proc.returncode, *text)
        if done.returncode != 0:
            fail(f"{phase}: {what} exited {done.returncode}: "
                 f"{(done.stdout + done.stderr)[-3000:]}")
        out[what] = (done, ended[what])
    return out


def measured_vision_step(seed: int):
    """The ``train`` phase's step (``make_train_step`` at the preset,
    ``cuda-full``, batch ``BATCH``) and its inputs on the card."""
    cfg = get_spikingformer_config(PRESET + "@cuda-full")
    params, state = init_spikingformer(torch.Generator().manual_seed(seed),
                                       cfg, DEVICE)
    data = SyntheticVision(VisionDataConfig(
        image_size=cfg.image_size, num_classes=cfg.num_classes,
        global_batch=BATCH, channels=cfg.in_channels, seed=seed))
    b = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.batch(0).items()}
    step = make_train_step(cfg, OptimizerConfig(lr=1e-3, warmup_steps=2,
                                                total_steps=100,
                                                weight_decay=0.01))
    args = (params, state, init_opt_state(params), b["images"], b["labels"])
    return lambda: step(*args)


def measured_lm_step(seed: int, arch: str = LM_ARCH):
    """``arch``'s training phase's step (``lm_train`` for qwen3-0.6b): the
    driver's (``donate=True``, AdamW written into the state) on its state
    and first batch."""
    from repro_torch.launch.train import lm_step_batch
    cfg = lm_train_config("cuda-full", arch)
    opt_cfg = OptimizerConfig(lr=3e-4, total_steps=1 + LM_TRAIN_STEPS,
                              warmup_steps=5)
    params, opt, _ = build_state(cfg, opt_cfg=opt_cfg, seed=seed,
                                 device=DEVICE)
    batch = lm_step_batch(cfg, SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=LM_TRAIN_SEQ,
        global_batch=LM_TRAIN_BATCH, seed=seed)).batch(0), DEVICE)
    step = make_train_step(cfg, opt_cfg, donate=True)
    return lambda: step(params, opt, batch)


def measure_step(make) -> dict:
    """One step of ``make(...)``'s (a warm-up first) on the card: its peak
    memory above what was allocated before its inputs were made (the dry
    run counts the inputs too), its launches (counted from 0 just before
    it) and its device busy ms (``busy_ms``; a second try where the first
    comes back without a number)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    step = make()
    step()                                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = step()
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    busy = busy_ms(step, counts)
    if busy is None:
        busy = busy_ms(step, counts)
    del step
    torch.cuda.empty_cache()
    return {"peak_bytes": peak, "launches": counts, "busy_ms": busy}


def hold_estimate(name: str, est: dict, got: dict) -> dict:
    """An estimate against the measured step: the peak within
    ``DRYRUN_PEAK_BAND``, the roofline's largest term no more than the
    busy ms (a lower bound above the time means a wrong count), the useful
    ratio at most ``DRYRUN_RATIO_MAX``, the kernel sites the launches."""
    rl = est["roofline"]
    bound_ms = max(rl["compute_s"], rl["memory_s"], rl["collective_s"]) * 1e3
    peak = est["bytes_per_device"]["peak"]
    launched = {k: n for k, n in got["launches"].items() if n}
    row = {"estimated_peak_bytes": peak,
           "measured_peak_bytes": got["peak_bytes"],
           "peak_rel_err": (peak - got["peak_bytes"]) / got["peak_bytes"],
           "roofline_ms": {k[:-2]: rl[k] * 1e3 for k in
                           ("compute_s", "memory_s", "collective_s")},
           "bound": rl["bound"], "bound_ms": bound_ms,
           "busy_ms": got["busy_ms"],
           "useful_flops_ratio": est["useful_flops_ratio"],
           "flops": est["hlo_flops_per_device"],
           "bytes": est["hlo_bytes_per_device"],
           "trace_s": est["compile_s"],
           "kernel_sites": est["kernel_sites"], "launches": launched}
    if abs(row["peak_rel_err"]) > DRYRUN_PEAK_BAND:
        fail(f"dryrun {name}: estimated peak {peak} bytes, measured "
             f"{got['peak_bytes']} ({row['peak_rel_err']:+.3f} > "
             f"{DRYRUN_PEAK_BAND})")
    if got["busy_ms"] is None or bound_ms > got["busy_ms"]:
        fail(f"dryrun {name}: the roofline's {rl['bound']} term "
             f"{bound_ms:.3f} ms against {got['busy_ms']} ms busy")
    if est["useful_flops_ratio"] > DRYRUN_RATIO_MAX:
        fail(f"dryrun {name}: useful flops ratio "
             f"{est['useful_flops_ratio']} > {DRYRUN_RATIO_MAX}")
    if est["kernel_sites"] != launched:
        fail(f"dryrun {name}: the dry run passed kernel sites "
             f"{est['kernel_sites']}, the step launched {launched}")
    return row


def dryrun_phase(seed: int, smi: str) -> dict[str, dict[str, int]]:
    """The dry run (``repro_torch.launch.dryrun``) held against this card:
    the two training steps of :func:`dryrun_cells` estimated in a child
    process (:func:`dryrun_child`) and, beside it in a second child, the
    production cell ``DRYRUN_CELL`` on ``data16`` through the module's
    command line (its terms, peak and ``fits`` printed); then the two steps
    measured here (:func:`measure_step`, each held by
    :func:`hold_estimate`). Returns the measured steps' launch counts, by
    path."""
    t0 = time.perf_counter()
    arch, shape = DRYRUN_CELL
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "world1.json")
        cli_what = f"python -m repro_torch.launch.dryrun {arch} {shape}"
        kids = run_children({
            "the world-1 estimates": [sys.executable,
                                      str(Path(__file__).resolve()),
                                      "--dryrun-child", path],
            cli_what: [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out", tmp]},
            "dryrun", DRYRUN_TIMEOUT_S)
        with open(path) as f:
            est = json.load(f)
        with open(os.path.join(tmp, f"{arch}__{shape}.json")) as f:
            cell = json.load(f)
    cli, cell_s = kids[cli_what]
    estimate_s = kids["the world-1 estimates"][1]
    got = {"train": measure_step(lambda: measured_vision_step(seed)),
           "lm_train": measure_step(lambda: measured_lm_step(seed))}
    held = {name: hold_estimate(name, est[name], got[name])
            for name in ("train", "lm_train")}
    rl = cell["roofline"]
    emit("dryrun", card=smi, world1=held,
         data16={"arch": arch, "shape": shape,
                 "peak_bytes": cell["bytes_per_device"]["peak"],
                 "argument_bytes": cell["bytes_per_device"]["argument"],
                 "fits": cell["fits"], "roofline": rl,
                 "collective_bytes": cell["collective_bytes_per_device"],
                 "useful_flops_ratio": cell["useful_flops_ratio"],
                 "trace_s": cell["compile_s"], "command_s": cell_s,
                 "cli": cli.stdout.strip().splitlines()[-2:]},
         seconds={"estimates": estimate_s, "data16": cell_s,
                  "phase": time.perf_counter() - t0},
         timing="the estimates and the data16 command run side by side, "
                "each timed from their common start: trace_s, command_s "
                "and both seconds are taken under each other's load",
         tolerance=f"peak within {DRYRUN_PEAK_BAND:.0%} of the measured "
                   f"step's; the roofline's largest term <= the step's "
                   f"device busy ms; useful ratio <= {DRYRUN_RATIO_MAX}; "
                   f"kernel sites = launches")
    return {"dryrun_train": got["train"]["launches"],
            "dryrun_lm_train": got["lm_train"]["launches"]}


# ---------------------------------------------------------------------------
# Phase 12: the vlm family (pixtral-12b + LIF) served and trained, and the
# examples
# ---------------------------------------------------------------------------

def vlm_estimate(layers: int) -> dict:
    """The dry run's world-1 count of ``pixtral-12b``'s training step (the
    driver's, fp32, 8 x 128 tokens with patches) at ``layers`` layers."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.specs import ShapeSpec, input_specs
    cfg = lm_config("cuda-full", VLM_ARCH).replace(num_layers=layers)
    shape = ShapeSpec("train", LM_TRAIN_SEQ, LM_TRAIN_BATCH)
    fn, structs, _ = input_specs(cfg, shape,
                                 AbstractMesh(("data", "model"), (1, 1)))
    counts = dryrun.count_step(fn, structs)
    del structs
    return dryrun.cell_result(cfg.name, shape, cfg, counts, "world1", 1)


def vlm_depth_child(path: str) -> None:
    """The depth side of the ``vlm`` phase, in its own process: the deepest
    depth of ``pixtral-12b`` whose estimated peak is within
    ``VLM_FIT_BYTES`` (the estimate is affine in the depth: counted at 1 and
    2 layers, then checked down from the line's depth), with its estimate
    and the next depth's peak, written to ``path`` as JSON."""
    peaks = {n: vlm_estimate(n)["bytes_per_device"]["peak"] for n in (1, 2)}
    top = get_config(VLM_ARCH).num_layers
    n = max(1, min(int((VLM_FIT_BYTES - peaks[1])
                       // (peaks[2] - peaks[1])) + 1, top))
    while True:
        est = vlm_estimate(n)
        peaks[n] = est["bytes_per_device"]["peak"]
        if peaks[n] <= VLM_FIT_BYTES or n == 1:
            break
        n -= 1
    if n < top and n + 1 not in peaks:
        peaks[n + 1] = vlm_estimate(n + 1)["bytes_per_device"]["peak"]
    with open(path, "w") as f:
        json.dump({"layers": n, "estimate": est,
                   "peaks": {str(k): v for k, v in sorted(peaks.items())}},
                  f)


def vlm_forward(params, seed: int) -> tuple[dict, dict[str, int]]:
    """``lm_forward`` of ``pixtral-12b`` + LIF at bf16 on a (1, 256) token
    batch with image patches (``vlm_patches``), under ``cuda-full`` and
    ``eager``: hidden states and logits bit-equal, one ``lif_soma_fwd``
    launch a layer (none under ``eager``), the merge changing the hidden
    states (a forward without the patches differs). Returns the line's
    entry and the ``cuda-full`` launches."""
    cfg = lm_config("cuda-full", VLM_ARCH, BF16)
    toks = torch.from_numpy(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=LM_FWD_SEQ, global_batch=1,
        seed=seed)).batch(0)["tokens"]).to(DEVICE)
    batch = {"tokens": toks, **vlm_patches(cfg, toks.shape, seed)}
    out = {}
    for policy in ("cuda-full", "eager"):
        pcfg = lm_config(policy, VLM_ARCH, BF16)

        def fwd(b=batch):
            with torch.inference_mode():
                h, _ = lm_forward(params, b, pcfg)
                return h, unembed(params["embed"], h)
        fwd()                                # warm-up, not counted
        torch.cuda.synchronize()
        reset_launch_counts()                # the path starts here
        h, logits = fwd()
        torch.cuda.synchronize()
        counts = launch_counts()             # ... and ends here
        out[policy] = {"h": h, "logits": logits, "counts": counts,
                       "ms": time_ms(fwd)}
    full, eager = out["cuda-full"], out["eager"]
    with torch.inference_mode():
        plain_h = lm_forward(params, {"tokens": toks}, cfg)[0]
    row = {"tokens": list(toks.shape),
           "patched_positions": int(batch["patch_mask"].sum()),
           "hidden_bit_equal": torch.equal(full["h"], eager["h"]),
           "logits_bit_equal": torch.equal(full["logits"], eager["logits"]),
           "merge_changes_hidden": not torch.equal(plain_h, full["h"]),
           "finite": bool(torch.isfinite(full["logits"]).all()),
           "ms_cuda_full": full["ms"], "ms_eager": eager["ms"],
           "launches": full["counts"]}
    layers = cfg.num_layers
    if not (row["hidden_bit_equal"] and row["logits_bit_equal"]
            and row["merge_changes_hidden"] and row["finite"]
            and row["patched_positions"]) or \
            full["counts"] != lm_expected(layers) or \
            eager["counts"] != lm_expected(0):
        fail(f"vlm forward: {row}, eager launches {eager['counts']}")
    return row, full["counts"]


def qk_scale_lm_(params, scale: float) -> None:
    """Every layer's attention query and key projections of a dense LM's
    tree times ``scale``, in place (a power of two: exact either way)."""
    for k in ("wq", "wk"):
        params["blocks"]["attn"][k].mul_(scale)


@contextlib.contextmanager
def scaled_build(scale: float):
    """Inside the block the driver's ``build_state`` hands ``train()`` its
    LM weights with ``qk_scale_lm_(., scale)`` applied, as a fine-tune
    would start from them (whisper's phase writes such weights as a
    checkpoint for the driver to resume; at ``pixtral-12b``'s training
    depth that would be a checkpoint of 14 GB, written and read back)."""
    from repro_torch.launch import train as driver
    built = driver.build_state

    def build(*args, **kw):
        params, opt, specs = built(*args, **kw)
        qk_scale_lm_(params, scale)
        return params, opt, specs
    driver.build_state = build
    try:
        yield
    finally:
        driver.build_state = built


def vlm_train(seed: int, smi: str) -> dict[str, dict[str, int]]:
    """``pixtral-12b`` + LIF's training path in fp32 at its published
    widths and the depth of ``TRAIN_LAYERS`` (the dry run's): step 0's loss
    and gradients under ``cuda-full`` and ``eager`` on the driver's first
    batch with image patches (``lm_train_batch``: the merge runs), held as
    ``check_grads`` holds the other families; then 1 + FAMILY_TRAIN_STEPS
    driver steps under ``cuda-full`` from the reference's init, measured
    (finite and the launches held; the gradient norm and the leaves the
    clip leaves unmoved printed), and from the same weights with every wq
    and wk times ``VLM_QK_SCALE`` (``scaled_build``), held as
    ``check_train_run`` holds the other families: every step finite, every
    leaf moved, 2 / 1 LIF launches a layer a step. The initial weights
    wait on the host (the driver's state alone is sized to fill the card).
    Returns the launches of each run, by path."""
    pre = TRAIN_PHASES[VLM_ARCH]
    cfg = lm_train_config("cuda-full", VLM_ARCH)
    params = build_state(cfg, seed=seed, device=DEVICE)[0]
    leaves = len(tree_leaves(params))
    grads = lm_grad_check(params, seed, VLM_ARCH)
    torch.cuda.empty_cache()
    check_grads(pre, grads)
    host = tree_map(lambda a: a.cpu(), params)
    del params
    torch.cuda.empty_cache()
    want = lm_train_expected(1 + FAMILY_TRAIN_STEPS, VLM_ARCH)
    runs = {}
    for name, scale in (("at_init", None), ("qk_scaled", VLM_QK_SCALE)):
        if scale is not None:
            qk_scale_lm_(host, scale)
        with scaled_build(scale) if scale is not None else \
                contextlib.nullcontext():
            run = lm_train_run(cfg, seed, FAMILY_TRAIN_STEPS)
        run["moved_leaves"] = moved_leaves(run, host)
        run.pop("history")
        torch.cuda.empty_cache()
        runs[name] = run
    init = runs["at_init"]
    emit(pre, arch=f"{VLM_ARCH}@cuda-full", layers=cfg.num_layers,
         published_layers=get_config(VLM_ARCH).num_layers,
         d_model=cfg.d_model, vocab=cfg.vocab_size, dtype="float32",
         remat=cfg.remat, parameters=sum(a.numel() for a in
                                         tree_leaves(host)),
         bytes=nbytes(*tree_leaves(host)), batch=LM_TRAIN_BATCH,
         seq=LM_TRAIN_SEQ, tokens_per_step=LM_TRAIN_BATCH * LM_TRAIN_SEQ,
         steps=f"1 warm-up + {FAMILY_TRAIN_STEPS} timed", data="SyntheticLM",
         patches={"step0": f"patch_embeds N(0, 1), patch_mask at "
                           f"{VLM_PATCH_RATE} of the positions",
                  "driver": "zero patches, an all-false mask (the "
                            "reference driver's)"},
         parameter_leaves=leaves, launches_per_step=lm_train_expected(
             1, VLM_ARCH), step0=grads,
         cuda_full_at_init={**init, "held": "every step finite, the "
                            "launches; unmoved leaves measured"},
         cuda_full=runs["qk_scaled"] | {
             "weights": f"the driver's, every wq and wk times "
                        f"{VLM_QK_SCALE}"},
         times="host clock from one step's loss on the host to the next's, "
               "after the warm-up step", card=smi)
    check_train_run(f"{pre} qk {VLM_QK_SCALE}", runs["qk_scaled"], leaves,
                    1 + FAMILY_TRAIN_STEPS, want)
    if init["counts"] != want or any(
            r["nonfinite"] or not math.isfinite(r["loss"])
            for r in init["steps"]):
        fail(f"{pre} at init: {init['steps']}, launches {init['counts']}")
    return {pre: runs["qk_scaled"]["counts"],
            f"{pre}_at_init": init["counts"]}


def vlm_lif_cases(gen) -> dict[str, list[dict]]:
    """``lif_soma_fwd`` at bf16 at the shapes the served ``pixtral-12b``
    gives it: decode (1, VLM_SLOTS, 5120) from the carried state and the
    forward's (256, 1, 5120) view, each with its path (the training step's
    fp32 (128, 8, 5120) cases come from ``train_lif_cases``)."""
    d = get_config(VLM_ARCH).d_model
    rows = bf16_lif_cases(gen, BATCH, shapes=[
        (f"lm.ffn.lif decode ({VLM_ARCH})", 1, VLM_SLOTS, d, "dense", True,
         False),
        (f"lm.ffn.lif forward ({VLM_ARCH})", LM_FWD_SEQ, 1, d, "lm", False,
         False)])
    for row, path in zip(rows["lif_soma_fwd"], ("vlm_serve", "vlm_forward")):
        row["path"] = path
    return rows


def vlm_phase(seed: int, smi: str, cases: dict[str, list[dict]]
              ) -> tuple[dict[str, dict[str, int]], dict[str, int]]:
    """``pixtral-12b`` + LIF, the vlm family's one registry model, on the
    card. Serving at its published bf16, widths and depth (40 layers),
    weights from ``seed`` on the card: ``vlm_forward`` and the 16 requests
    through ``bf16_serve`` (``VLM_SLOTS`` slots; decode takes no patches,
    in the reference too). Training in fp32 at its published widths, at
    the deepest depth whose world-1 dry-run estimate fits
    ``VLM_FIT_BYTES`` (``vlm_depth_child``, in a child process):
    ``vlm_train``; then the driver's step measured alone (``measure_step``) and
    held against the dry run's estimate (``hold_estimate``: the peak within
    ``DRYRUN_PEAK_BAND``). Adds the bf16 LIF cases to ``cases``; returns
    each path's launches and the steps of the serving and training runs."""
    t0 = time.perf_counter()
    cfg = lm_config("eager", VLM_ARCH, BF16)
    params = split_tree(init_lm(torch.Generator(device=DEVICE).manual_seed(
        seed), cfg, DEVICE))[0]
    weights = {"parameters": sum(a.numel() for a in tree_leaves(params)),
               "bytes": nbytes(*tree_leaves(params))}
    fwd_row, fwd_counts = vlm_forward(params, seed)
    torch.cuda.empty_cache()
    serve, serve_counts, serve_steps = bf16_serve(params, VLM_ARCH, seed,
                                                  VLM_SLOTS)
    del params
    torch.cuda.empty_cache()
    emit("vlm_serve", arch=f"{VLM_ARCH}@cuda-full", dtype="bfloat16",
         cache_dtype="bfloat16", layers=cfg.num_layers, d_model=cfg.d_model,
         heads=[cfg.n_heads, cfg.n_kv_heads], d_head=cfg.d_head,
         d_ff=cfg.d_ff, vocab=cfg.vocab_size, **weights, forward=fwd_row,
         serve=serve, seconds=time.perf_counter() - t0, card=smi)

    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vlm_depth.json")
        run_child([sys.executable, str(Path(__file__).resolve()),
                   "--vlm-depth-child", path], "the vlm depth estimates",
                  phase="vlm")
        with open(path) as f:
            depth = json.load(f)
    TRAIN_LAYERS[VLM_ARCH] = depth["layers"]
    depth_s = time.perf_counter() - t1
    train_paths = vlm_train(seed, smi)
    torch.cuda.empty_cache()
    got = measure_step(lambda: measured_lm_step(seed, VLM_ARCH))
    held = hold_estimate("vlm_train", depth["estimate"], got)
    for name, rows in vlm_lif_cases(
            torch.Generator(device=DEVICE).manual_seed(seed + 33)).items():
        cases[name].extend(rows)
    emit("vlm_train_estimate", arch=f"{VLM_ARCH}@cuda-full",
         layers=depth["layers"], fit_bytes=VLM_FIT_BYTES,
         estimated_peaks_by_layers=depth["peaks"], world1=held,
         seconds={"depth_estimates": depth_s,
                  "phase": time.perf_counter() - t0},
         tolerance=f"the deepest depth whose estimate is within "
                   f"{VLM_FIT_BYTES:.0f} B; the measured step's peak within "
                   f"{DRYRUN_PEAK_BAND:.0%} of its estimate", card=smi)
    return ({"vlm_forward": fwd_counts, "vlm_serve": serve_counts,
             **train_paths, "vlm_dryrun_step": got["launches"]},
            {"vlm_serve": serve_steps, "vlm_train": 1 + FAMILY_TRAIN_STEPS})


#: The port's examples (``examples/torch/``) the ``examples`` phase runs, at
#: their default arguments, with the number each is judged by.
EXAMPLES = ("quickstart", "train_spikingformer", "serve_lm",
            "explore_dataflows")
EXAMPLES_TIMEOUT_S = 300


def example_figures(name: str, out: str) -> dict:
    """What an example's output says: its final loss (the last ``[snn]`` or
    ``step`` line; ``serve_lm``'s trained loss) beside ln 4, ``serve_lm``'s
    bigram consistency beside chance, ``explore_dataflows``' line count;
    a loss that is missing or not finite fails the phase."""
    row: dict = {}
    if name == "explore_dataflows":
        row["headlines"] = out.count("opt=")
        if row["headlines"] != 14:
            fail(f"examples: {name} printed {row['headlines']} of 14 "
                 f"headlines")
        return row
    if name == "serve_lm":
        m = re.search(r"trained: loss (\S+) -> (\S+)", out)
        hits = re.search(r"bigram-consistency of generations: (\d+)/(\d+)",
                         out)
        row.update(first_loss=float(m.group(1)) if m else None,
                   bigram_consistency=int(hits.group(1)) / int(hits.group(2))
                   if hits else None, bigram_chance=4 / 64)
        loss = float(m.group(2)) if m else math.nan
    else:
        pat = r"\[snn\] step \d+ loss (\S+)" if name == "quickstart" else \
            r"^step\s+\d+ loss (\S+)"
        found = re.findall(pat, out, re.M)
        loss = float(found[-1]) if found else math.nan
    row.update(final_loss=loss, chance_loss=math.log(4))
    if not math.isfinite(loss):
        fail(f"examples: {name} gave no finite final loss:\n{out[-2000:]}")
    return row


def examples_phase(smi: str) -> None:
    """The port's four examples as child processes on the card, all
    started together (``run_children``), each at its default arguments:
    a non-zero exit or a non-finite loss fails the phase; how well an
    example learns is printed (its final loss beside ln 4, ``serve_lm``'s
    bigram consistency beside chance), not held."""
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent / "examples" / "torch"
    kids = run_children({name: [sys.executable, str(root / f"{name}.py")]
                         for name in EXAMPLES}, "examples",
                        EXAMPLES_TIMEOUT_S)
    rows = {name: {**example_figures(name, out.stdout), "seconds": seconds}
            for name, (out, seconds) in kids.items()}
    emit("examples", examples=rows, seconds=time.perf_counter() - t0,
         timing="the four run side by side on the one card, each timed "
                "from their common start to its exit",
         held="exit 0 and a finite final loss; the losses against ln 4 and "
              "the bigram consistency against chance are printed, not held",
         card=smi)


def split_summary(name: str, rows: list[dict],
                  fused: list[dict]) -> list[dict]:
    """A BN kernel's split-path cases for the ``kernels`` line: each
    shape's fused and split times at a world of 1, the bitwise check, and
    ``library_ms``, the PyTorch call of the kernel's case at the same shape
    in ``fused`` (the split path computes the fused path's function; None
    where no case has the shape)."""
    fwd, bwd = name == "bn_fwd", name == "bn_bwd"
    key = "fwd" if fwd else "bwd"
    library = {tuple(c["shape"]): c.get("library_ms") for c in fused}
    return [{"case": r["case"], "shape": r["shape"],
             "ms": r[f"{key}_ms"] if fwd or bwd else r["ms"],
             "split_ms": r[f"{key}_split_ms"] if fwd or bwd else r["split_ms"],
             "bitwise": r[f"bitwise_{key}"] if fwd or bwd else r["bitwise"],
             "library_ms": library.get(tuple(r["shape"]))}
            for r in rows]


def summarise(cases: dict[str, list[dict]],
              paths: dict[str, dict[str, int]],
              split: dict[str, list[dict]] | None = None,
              oracle: dict[str, dict] | None = None) -> dict:
    """One entry per kernel. Where a kernel serves several sites, the entry
    carries the numbers of its first case (a site of the main path) and the
    largest error of all cases; ``cases`` keeps every site's numbers.
    ``oracle_max_abs_err``: the kernel's largest error against
    ``kernels/ref.py`` in the analysis phase (``oracle``; None for a kernel
    that returns spikes alone), ``oracle_spikes`` a neuron layer's spike
    counts there (``total``, ``differing`` from the oracle's, ``in_band``
    around the threshold, ``wrong``: 0).
    ``launches`` adds the counts of the paths (Spikingformer serving and
    training, the LM's forward, serving and training, and the forward and
    step under the tuned table), ``launches_by_path`` keeps them apart."""
    kernels = []
    for name, info in KERNELS.items():
        rows = cases[name]
        first = rows[0]
        kernels.append({
            "name": name, "route": "cuda", "source": info["source"],
            "replaces": info["replaces"],
            "launches": sum(c[name] for c in paths.values()),
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "oracle_max_abs_err": (oracle or {}).get(name, {}).get(
                "max_abs_err"),
            "oracle_spikes": (oracle or {}).get(name, {}).get("spikes"),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "case": first["case"],
            **({"tc_bound_ms": first["tc_bound_ms"]}
               if "tc_bound_ms" in first else {}),
            **({"split_path": split_summary(name, split[name], rows)}
               if split and name in split else {}),
            "cases": rows})
    kernels.append(wgmma_summary(cases, paths, oracle))
    kernels.append(heads_summary(cases, paths, oracle))
    kernels.append(z_wgmma_summary(cases, paths, oracle))
    kernels.append(eval_wgmma_summary(cases, paths, oracle))
    kernels.append(pack_summary(cases, paths))
    return {"kernels": kernels}


def eval_wgmma_summary(cases: dict[str, list[dict]],
                       paths: dict[str, dict[str, int]],
                       oracle: dict[str, dict] | None) -> dict:
    """The bf16 eval neuron layer's entry (``neuron_layer_eval_wgmma`` in
    ``csrc/neuron_layer.cu`` on ``csrc/wgmma_mainloop.cuh``, plan kernel
    ``EVAL_WGMMA`` of ``e2a_neuron_layer_eval``): the numbers of its first
    case (pssa.qkv, the wrapper's call with ``spike_pack``), its largest
    spike error against the oracle over every case that ran it, and its
    launches on the bf16 serving path. ``library_ms`` is null: no single
    library call computes the layer; ``yardstick_device_ms`` is the
    unfused path's, cuBLAS's fp32-output bf16 GEMM plus the bf16 LIF
    (``eval_wgmma_extra``)."""
    rows = [r for r in cases["neuron_layer_eval"]
            if r.get("kernel") == [neuron_layer.EVAL_WGMMA]]
    first = rows[0]
    keep = ("case", "shape", "ms", "device_ms", "device_ms_l2_warm",
            "plain_ms", "bound_ms", "bound_by", "bitwise_plain", "spikes",
            "kernel_alone", "one_plane", "yardstick_mm", "yardstick_lif",
            "yardstick_device_ms")
    return {
        "name": EVAL_WGMMA_ENTRY, "route": "cuda",
        "source": EVAL_WGMMA_SOURCE,
        "mainloop": "src/repro_torch/kernels/csrc/wgmma_mainloop.cuh",
        "replaces": KERNELS["neuron_layer_eval"]["replaces"],
        "launched_by": ["neuron_layer_eval"],
        "plan_kernel": neuron_layer.EVAL_WGMMA, "dtype": "bfloat16",
        "launches": sum(c.get(EVAL_WGMMA_ENTRY, 0) for c in paths.values()),
        "launches_by_path": {p: c[EVAL_WGMMA_ENTRY] for p, c in paths.items()
                             if EVAL_WGMMA_ENTRY in c},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "oracle_max_abs_err": (oracle or {}).get(EVAL_WGMMA_ENTRY, {}).get(
            "max_abs_err"),
        "oracle_spikes": (oracle or {}).get(EVAL_WGMMA_ENTRY, {}).get(
            "spikes"),
        "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": None,
        "yardstick_device_ms": first.get("yardstick_device_ms"),
        "case": first["case"], "device_ms": first["device_ms"],
        "device_ms_l2_warm": first["device_ms_l2_warm"],
        "cases": [{k: r[k] for k in keep if k in r} for r in rows]}


def z_wgmma_summary(cases: dict[str, list[dict]],
                    paths: dict[str, dict[str, int]],
                    oracle: dict[str, dict] | None) -> dict:
    """The bf16 z pass's entry (``neuron_layer_train_z_wgmma`` in
    ``csrc/neuron_layer.cu`` on ``csrc/wgmma_mainloop.cuh``, plan kernel
    ``Z_WGMMA`` of the train-mode entry points): the numbers of its first
    case (pssa.qkv, the pass alone: ``z_pass_row``), its largest distance
    from the fp32 product on Gaussian weights over every case that ran it,
    and its launches on the bf16 paths (forward and replay)."""
    rows = [dict(r["z_pass"], case=r["case"], shape=r["shape"])
            for r in cases["neuron_layer_train"]
            if r.get("z_pass", {}).get("z_kernel") == neuron_layer.Z_WGMMA]
    first = rows[0]
    return {
        "name": Z_WGMMA_ENTRY, "route": "cuda", "source": Z_WGMMA_SOURCE,
        "mainloop": "src/repro_torch/kernels/csrc/wgmma_mainloop.cuh",
        "replaces": KERNELS["neuron_layer_train"]["replaces"],
        "launched_by": ["neuron_layer_train"],
        "plan_kernel": neuron_layer.Z_WGMMA, "dtype": "bfloat16",
        "launches": sum(c.get(Z_WGMMA_ENTRY, 0) for c in paths.values()),
        "launches_by_path": {p: c[Z_WGMMA_ENTRY] for p, c in paths.items()
                             if Z_WGMMA_ENTRY in c},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "oracle_max_abs_err": (oracle or {}).get(Z_WGMMA_ENTRY, {}).get(
            "max_abs_err"),
        "oracle_spikes": (oracle or {}).get(Z_WGMMA_ENTRY, {}).get("spikes"),
        "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": first["library_ms"],
        "library_call": first["library_call"], "case": first["case"],
        "device_ms": first["device_ms"],
        "device_ms_l2_warm": first["device_ms_l2_warm"],
        "cases": rows}


def wgmma_summary(cases: dict[str, list[dict]],
                  paths: dict[str, dict[str, int]],
                  oracle: dict[str, dict] | None) -> dict:
    """The bf16 wgmma kernel's entry (``csrc/spike_wgmma.cuh``, plan
    kernel 3 of ``e2a_spike_matmul``, launched by both spike-matmul
    wrappers): the numbers of its first case (pssa.proj), its largest error
    over every case that ran it, the one-plane mainloop forced (tile 1) on
    the same operands beside it, and its launches on the bf16 paths."""
    rows = [r for name in ("spike_matmul_packed",
                           "spike_matmul_packed_batched")
            for r in cases[name] if r.get("kernel") == spike_matmul.WGMMA]
    first = rows[0]
    return {
        "name": WGMMA_ENTRY, "route": "cuda", "source": WGMMA_SOURCE,
        "replaces": KERNELS["spike_matmul_packed"]["replaces"],
        "also_replaces": KERNELS["spike_matmul_packed_batched"]["replaces"],
        "launched_by": ["spike_matmul_packed", "spike_matmul_packed_batched"],
        "plan_kernel": spike_matmul.WGMMA, "dtype": "bfloat16",
        "launches": sum(c.get(WGMMA_ENTRY, 0) for c in paths.values()),
        "launches_by_path": {p: c[WGMMA_ENTRY] for p, c in paths.items()
                             if WGMMA_ENTRY in c},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "oracle_max_abs_err": (oracle or {}).get(WGMMA_ENTRY, {}).get(
            "max_abs_err"),
        "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": first["library_ms"], "case": first["case"],
        "device_ms": first["device_ms"],
        "tile1_device_ms": first["tile1_device_ms"],
        "cases": [{k: r[k] for k in (
            "case", "shape", "device_ms", "device_ms_l2_warm",
            "tile1_device_ms", "tile1_device_ms_l2_warm", "library_ms",
            "library_device_ms", "bound_ms", "host_us", "tile1_host_us",
            "max_abs_err", "bitwise_gaussian")} for r in rows]}


def heads_summary(cases: dict[str, list[dict]],
                  paths: dict[str, dict[str, int]],
                  oracle: dict[str, dict] | None) -> dict:
    """The bf16 heads kernel's entry (``csrc/spike_heads.cuh``, plan kernel
    ``spike_matmul.HEADS`` of ``e2a_spike_matmul``): the numbers of its
    case, ``attn_qk`` (its largest error, the Small tile forced on the same
    operands beside it, the faster cuBLAS yardstick), its largest error
    against the oracle in the analysis phase, and its launches on the bf16
    paths."""
    rows = [r for name in ("spike_matmul_packed",
                           "spike_matmul_packed_batched")
            for r in cases[name] if r.get("kernel") == spike_matmul.HEADS]
    first = rows[0]
    return {
        "name": HEADS_ENTRY, "route": "cuda", "source": HEADS_SOURCE,
        "replaces": KERNELS["spike_matmul_packed_batched"]["replaces"],
        "launched_by": ["spike_matmul_packed_batched"],
        "plan_kernel": spike_matmul.HEADS, "dtype": "bfloat16",
        "launches": sum(c.get(HEADS_ENTRY, 0) for c in paths.values()),
        "launches_by_path": {p: c[HEADS_ENTRY] for p, c in paths.items()
                             if HEADS_ENTRY in c},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "oracle_max_abs_err": (oracle or {}).get(HEADS_ENTRY, {}).get(
            "max_abs_err"),
        "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": first["library_ms"],
        "library_call": first["library_call"], "case": first["case"],
        "device_ms": first["device_ms"],
        "tile2_device_ms": first["tile2_device_ms"],
        "cases": [{k: r[k] for k in (
            "case", "shape", "device_ms", "device_ms_l2_warm",
            "tile2_device_ms", "tile2_device_ms_l2_warm", "library_ms",
            "library_device_ms", "library_view_device_ms",
            "library_contiguous_device_ms", "bound_ms", "host_us",
            "tile2_host_us", "max_abs_err", "bitwise_gaussian",
            "tile2_bitwise_gaussian")} for r in rows]}


def setup_card() -> dict:
    """Fails without a CUDA device; turns TF32 off; prints the ``device``
    line and returns ``repro_torch.probe()`` with ``smi``, the card's name
    and power limit as nvidia-smi gives them."""
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    # The yardsticks are full fp32: cuDNN's fp32 convolution is TF32 by
    # default, the matmul is not; state both.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = repro_torch.probe()
    if not info["nvidia_smi"]:
        fail("nvidia-smi gave no name and power limit for the card")
    smi = info["nvidia_smi"].splitlines()[0]
    emit("device", name=info["device_name"], nvidia_smi=smi,
         torch=info["torch"], cuda=info["cuda_runtime"],
         count=info["device_count"])
    return {**info, "smi": smi}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--depth", type=int, default=8,
                    help="transformer blocks served (the preset has 8)")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print ptxas' registers / shared memory / spills")
    ap.add_argument("--dryrun-child", metavar="PATH", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--vlm-depth-child", metavar="PATH", default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dryrun_child:
        dryrun_child(args.dryrun_child)            # the dryrun phase's child
        return
    if args.vlm_depth_child:
        vlm_depth_child(args.vlm_depth_child)      # the vlm phase's child
        return

    info = setup_card()
    smi = info["smi"]
    from repro_torch.tune import table
    if table.active_table():
        fail(f"a tuned-block table is active ({table.table_path()}): every "
             f"phase but the tune phase runs without one")
    t0 = time.perf_counter()
    build.load(verbose=args.verbose_build)
    emit("build", seconds=time.perf_counter() - t0,
         nvcc=info["nvcc_release"],
         sources=[s.name for s in build.sources()])
    oracle = analysis_phase(args.seed)
    torch.cuda.empty_cache()

    cases = kernel_phase(args.seed, BATCH)
    for name, rows in bf16_kernel_phase(args.seed, BATCH).items():
        cases[name].extend(rows)             # each kernel's bf16 arm
    torch.cuda.empty_cache()
    emit("kernels", cases=cases)

    counts = model_phase(args.seed, args.depth, REQUESTS, BATCH)
    torch.cuda.empty_cache()
    block_grad_check(args.seed, BATCH)
    torch.cuda.empty_cache()
    train_counts = train_phase(args.seed, BATCH)
    torch.cuda.empty_cache()
    lm_counts, lm_steps = lm_phase(args.seed)
    torch.cuda.empty_cache()
    lm_counts.update(lm_train_phase(args.seed))
    torch.cuda.empty_cache()
    path_steps = {"lm_serve": lm_steps, "lm_train": 1 + LM_TRAIN_STEPS}
    for arch in (MOE_ARCH, RWKV_ARCH, HYBRID_ARCH):
        arch_counts, path_steps[f"{phase_name(arch)}_serve"] = lm_phase(
            args.seed, arch, smi)
        lm_counts.update(arch_counts)
        torch.cuda.empty_cache()
    lm_counts.update(whisper_phase(args.seed, smi))
    torch.cuda.empty_cache()
    for arch in list(TRAIN_PHASES)[1:-1]:          # pixtral: the vlm phase
        lm_counts.update(lm_train_phase(args.seed, arch, smi))
        path_steps[TRAIN_PHASES[arch]] = 1 + FAMILY_TRAIN_STEPS
        torch.cuda.empty_cache()
    lm_launches({k: cases[k] for k in ("lif_soma_fwd", "lif_soma_bwd")},
                lm_counts, path_steps)
    bf16_counts = bf16_vision_phase(args.seed, BATCH, smi)
    torch.cuda.empty_cache()
    bf16_counts.update(lm_bf16_phase(args.seed, smi))
    torch.cuda.empty_cache()
    vlm_counts, vlm_steps = vlm_phase(args.seed, smi, cases)
    lm_launches({k: cases[k] for k in ("lif_soma_fwd", "lif_soma_bwd")},
                vlm_counts, vlm_steps)
    torch.cuda.empty_cache()
    examples_phase(smi)
    chaos_phase(args.seed, smi)
    torch.cuda.empty_cache()
    mesh_counts, split_cases = mesh_train_phase(args.seed, BATCH, smi)
    torch.cuda.empty_cache()
    tp_phase(args.seed, BATCH, cases, smi)
    torch.cuda.empty_cache()
    tune_counts = tune_phase(args.seed, BATCH)
    torch.cuda.empty_cache()
    dryrun_counts = dryrun_phase(args.seed, smi)

    print(json.dumps(summarise(cases, {"serve": counts, "train": train_counts,
                                       **lm_counts, **bf16_counts,
                                       **vlm_counts, **mesh_counts,
                                       "tune": tune_counts, **dryrun_counts},
                                     split_cases, oracle)),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
