"""PyTorch/CUDA port of the E2ATST Spikingformer stack (NVIDIA Hopper).

The package mirrors :mod:`repro` (``core/``, ``kernels/``, ``configs/``) so
the counterpart of a module is found by its path. It imports ``torch`` and
numpy only. Importing it never compiles anything: the CUDA kernels under
``kernels/csrc`` are built with ``nvcc`` the first time a kernel is launched
on a CUDA tensor (see :mod:`repro_torch.kernels.build`).

Ported so far: the eval-mode (serving) forward of the Spikingformer vision
model with its four forward kernels. Training arrives with a later slice;
until then ``train=True`` on any implementation other than ``eager`` raises
``NotImplementedError``.
"""
from repro_torch.core.backend import probe, resolve_device  # noqa: F401
from repro_torch.core.policy import (ExecutionPolicy,  # noqa: F401
                                     IMPL_FROM_JAX, named_policy)

__all__ = ["ExecutionPolicy", "IMPL_FROM_JAX", "named_policy", "probe",
           "resolve_device"]
