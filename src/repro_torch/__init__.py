"""PyTorch/CUDA port of the E2ATST Spikingformer stack (NVIDIA Hopper).

The package mirrors :mod:`repro` (``core/``, ``kernels/``, ``configs/``,
``models/``, ``serving/``, ``train/``) so the counterpart of a module is
found by its path. It imports ``torch`` and numpy only. Importing it never
compiles anything: the CUDA kernels under ``kernels/csrc`` are built with
``nvcc`` the first time a kernel is launched on a CUDA tensor (see
:mod:`repro_torch.kernels.build`).

Ported so far: the Spikingformer vision model, its eval-mode (serving)
forward and its BPTT training step (``repro_torch.train``), with every
kernel of the reference written by hand for the card; the LM zoo's
registry and dense family (``models``), with the spiking LM's LIF on the
SOMA kernel, and its continuous-batching server (``serving``).
"""
from repro_torch.core.backend import probe, resolve_device  # noqa: F401
from repro_torch.core.policy import (ExecutionPolicy,  # noqa: F401
                                     IMPL_FROM_JAX, named_policy)

__all__ = ["ExecutionPolicy", "IMPL_FROM_JAX", "named_policy", "probe",
           "resolve_device"]
