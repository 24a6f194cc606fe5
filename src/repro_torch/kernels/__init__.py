"""Hand-written CUDA kernels of the port, one module per kernel family.

Each module holds the wrapper (checks, output allocation, launch on the
current stream, launch counter), the plain PyTorch version of the same
function, and a note on the Pallas function it replaces. ``KERNELS`` is the
coverage table: kernel -> CUDA source, the reference's function it replaces,
and the ``(op, impl)`` registry pairs it serves.
"""

KERNELS: dict[str, dict] = {
    "lif_soma_fwd": {
        "source": "src/repro_torch/kernels/csrc/lif_soma.cu",
        "replaces": "src/repro/kernels/lif_soma.py:92",
        "serves": (("lif", "cuda"), ("lif_state", "cuda")),
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
    "neuron_layer_eval": {
        "source": "src/repro_torch/kernels/csrc/neuron_layer.cu",
        "replaces": "src/repro/kernels/neuron_layer.py:228",
        "serves": (("linear_bn", "fused_epilogue"),
                   ("conv", "fused_epilogue")),
    },
}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    from repro_torch.kernels import lif_soma, neuron_layer, spike_matmul
    return {
        "lif_soma_fwd": lif_soma.lif_soma_fwd.launches,
        "spike_matmul_packed": spike_matmul.spike_matmul_packed.launches,
        "spike_matmul_packed_batched":
            spike_matmul.spike_matmul_packed_batched.launches,
        "neuron_layer_eval": neuron_layer.neuron_layer_eval.launches,
    }


def reset_launch_counts() -> None:
    from repro_torch.kernels import lif_soma, neuron_layer, spike_matmul
    for fn in (lif_soma.lif_soma_fwd, spike_matmul.spike_matmul_packed,
               spike_matmul.spike_matmul_packed_batched,
               neuron_layer.neuron_layer_eval):
        fn.launches = 0
