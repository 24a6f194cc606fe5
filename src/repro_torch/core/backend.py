"""Device resolution and small layout helpers for the PyTorch port.

Two execution backends implement the same math (E2ATST eq. 11-23):

* ``"eager"`` — plain PyTorch tensor code, the port's own reference.
* ``"cuda"``  — the hand-written CUDA kernels in :mod:`repro_torch.kernels`.

There is no ``interpret`` switch: where a tensor lives decides what runs. A
kernel wrapper launches its CUDA kernel for a CUDA tensor and uses its plain
PyTorch version only for a CPU tensor; it never falls back from one to the
other.

Entry points take ``device=None``, which means the card: it raises when
there is none. Nothing looks for a GPU and carries on without one; a caller
that wants the CPU says ``device="cpu"``.
"""
from __future__ import annotations

import shutil
import subprocess

import torch

#: The valid backend names, in preference order for tests/benchmarks.
BACKENDS: tuple[str, ...] = ("eager", "cuda")


def validate_backend(backend: str) -> str:
    """Return ``backend`` or raise with the list of valid names."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}")
    return backend


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``, raising when there is no card.

    An explicit device is returned as given (``"cpu"`` is how the tests ask
    for the plain versions); an explicit CUDA device is checked too.
    """
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available (torch.cuda.is_available() is False); pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def fold_time_major(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    """(T, ..., D) -> ((T, M, D), original_shape) with M = prod(middle dims).

    The fused kernels operate on time-major 3-D blocks; LIF/BN are
    element-/feature-wise over the folded axes so the reshape is exact.
    """
    t, d = x.shape[0], x.shape[-1]
    return x.reshape(t, -1, d), tuple(x.shape)


def fold_rows(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    """(..., D) -> ((M, D), original_shape): row-fold for per-feature BN."""
    return x.reshape(-1, x.shape[-1]), tuple(x.shape)


def _run(cmd: list[str]) -> str | None:
    exe = shutil.which(cmd[0])
    if exe is None:
        return None
    out = subprocess.run([exe] + cmd[1:], capture_output=True, text=True,
                         check=False)
    return out.stdout.strip() if out.returncode == 0 else None


def probe() -> dict:
    """What this process can run on: torch and CUDA versions, whether
    ``nvcc`` is on the path (the kernels need it at first launch), and the
    card's name and power limit as ``nvidia-smi`` reports them."""
    from repro_torch.kernels.build import find_nvcc

    nvcc = find_nvcc(required=False)
    release = None
    if nvcc is not None:
        text = _run([nvcc, "--version"]) or ""
        release = next((ln.strip() for ln in text.splitlines()
                        if "release" in ln), None)
    has_cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda_runtime": torch.version.cuda,
        "cuda_available": has_cuda,
        "device_count": torch.cuda.device_count() if has_cuda else 0,
        "device_name": torch.cuda.get_device_name(0) if has_cuda else None,
        "nvcc": nvcc,
        "nvcc_release": release,
        "nvidia_smi": _run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"]),
    }
