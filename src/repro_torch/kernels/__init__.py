"""Hand-written CUDA kernels of the port, one module per kernel family.

Each module holds the wrapper (checks, output allocation, launch on the
current stream, launch counter), the plain PyTorch version of the same
function, and a note on the Pallas function it replaces. ``KERNELS`` is the
coverage table: kernel -> CUDA source, the reference's ``pallas_call`` it
replaces (``lif_soma_bwd`` serves both of the reference's GRAD calls, the
second as ``also_replaces``), and the ``(op, impl)`` registry pairs it
serves.

On ``meta`` tensors a wrapper launches nothing and runs no plain version:
it allocates its kernel's outputs on ``meta`` (one shape rule a wrapper,
beside its contract declaration) and reports the site to
:func:`meta_site`'s observers, the dry run's counter
(``repro_torch.launch.dryrun``). A CUDA tensor still launches or raises.
"""

KERNELS: dict[str, dict] = {
    "lif_soma_fwd": {
        "source": "src/repro_torch/kernels/csrc/lif_soma.cu",
        "replaces": "src/repro/kernels/lif_soma.py:92",
        "serves": (("lif", "cuda"), ("lif_state", "cuda")),
    },
    "lif_soma_bwd": {
        "source": "src/repro_torch/kernels/csrc/lif_soma.cu",
        "replaces": "src/repro/kernels/lif_soma.py:117",
        "also_replaces": "src/repro/kernels/lif_soma.py:124",
        "serves": (("lif", "cuda"), ("lif_state", "cuda"),
                   ("linear_bn", "fused_epilogue"),
                   ("conv", "fused_epilogue")),
    },
    "spike_matmul_packed": {
        "source": "src/repro_torch/kernels/csrc/spike_matmul.cu",
        "replaces": "src/repro/kernels/spike_matmul.py:80",
        "serves": (("linear_bn", "cuda+spike_mm"),),
    },
    "spike_matmul_packed_batched": {
        "source": "src/repro_torch/kernels/csrc/spike_matmul.cu",
        "replaces": "src/repro/kernels/spike_matmul.py:139",
        "serves": (("attn_qk", "cuda_packed"), ("attn_av", "cuda_packed"),
                   ("conv", "cuda_packed")),
    },
    "bn_fwd": {
        "source": "src/repro_torch/kernels/csrc/fused_bn.cu",
        "replaces": "src/repro/kernels/fused_bn.py:68",
        "serves": (("bn", "cuda"), ("linear_bn", "cuda"),
                   ("linear_bn", "cuda+spike_mm"), ("conv", "cuda"),
                   ("conv", "cuda_packed")),
    },
    "bn_bwd": {
        "source": "src/repro_torch/kernels/csrc/fused_bn.cu",
        "replaces": "src/repro/kernels/fused_bn.py:90",
        "serves": (("bn", "cuda"), ("linear_bn", "cuda"),
                   ("linear_bn", "cuda+spike_mm"), ("conv", "cuda"),
                   ("conv", "cuda_packed"), ("linear_bn", "fused_epilogue"),
                   ("conv", "fused_epilogue")),
    },
    "neuron_layer_train": {
        "source": "src/repro_torch/kernels/csrc/neuron_layer.cu",
        "replaces": "src/repro/kernels/neuron_layer.py:190",
        "serves": (("linear_bn", "fused_epilogue"),
                   ("conv", "fused_epilogue")),
    },
    "neuron_layer_eval": {
        "source": "src/repro_torch/kernels/csrc/neuron_layer.cu",
        "replaces": "src/repro/kernels/neuron_layer.py:228",
        "serves": (("linear_bn", "fused_epilogue"),
                   ("conv", "fused_epilogue")),
    },
}


#: The element types the kernels take -> the dtype code their entry points
#: are handed (``csrc/elem.cuh``: ``kFloat32``, ``kBfloat16``).
DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def dtype_code(dtype, what: str) -> int:
    """The entry points' code of ``dtype`` (a ``torch.dtype``): fp32 and
    bf16 have a kernel arm; any other type raises ``TypeError`` naming
    ``what``, before anything launches (fp16 is not ported)."""
    name = str(dtype).removeprefix("torch.")
    if name not in DTYPE_CODES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    return DTYPE_CODES[name]


#: The names :func:`launch_counts` reports: every row of :data:`KERNELS`
#: and ``spike_pack`` (``csrc/spike_pack.cu``), the pack every packed arm
#: runs before its kernel, an entry point of the spike matmul's row that
#: replaces no ``pallas_call`` of its own.
COUNTED = (*KERNELS, "spike_pack")


def _wrappers() -> dict:
    """Name of :data:`COUNTED` -> its wrapper, the function that carries
    the count."""
    from repro_torch.kernels import fused_bn, lif_soma, neuron_layer, \
        spike_matmul
    return {
        "lif_soma_fwd": lif_soma.lif_soma_fwd,
        "lif_soma_bwd": lif_soma.lif_soma_bwd,
        "spike_matmul_packed": spike_matmul.spike_matmul_packed,
        "spike_matmul_packed_batched":
            spike_matmul.spike_matmul_packed_batched,
        "bn_fwd": fused_bn.bn_fwd,
        "bn_bwd": fused_bn.bn_bwd,
        "neuron_layer_train": neuron_layer.neuron_layer_train,
        "neuron_layer_eval": neuron_layer.neuron_layer_eval,
        "spike_pack": spike_matmul.spike_pack,
    }


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`
    (one per wrapper call that reached the card; plain versions do not
    count)."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def set_launch_counts(counts: dict[str, int]) -> None:
    """Set each kernel's count, e.g. back to a :func:`launch_counts`
    snapshot."""
    for name, fn in _wrappers().items():
        fn.launches = counts[name]


def reset_launch_counts() -> None:
    set_launch_counts(dict.fromkeys(COUNTED, 0))


#: Observers of the kernel sites a run on ``meta`` tensors passes: each is
#: called as ``observer(name, operands, results, flops)``.
META_OBSERVERS: list = []


def meta_site(name: str, operands, results, flops: float = 0.0):
    """A wrapper's ``meta`` branch ends here: ``results`` are its kernel's
    outputs, allocated on ``meta``, and nothing was launched (the launch
    counts do not move). Tells the observers the site's kernel, its tensor
    operands and results, and ``flops``, the dense 2 * M * C * K of the
    product the kernel forms (0 where it forms none). Returns
    ``results``."""
    for observe in META_OBSERVERS:
        observe(name, tuple(operands), results, float(flops))
    return results
