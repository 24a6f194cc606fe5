"""Kernel-contract declarations consumed by ``repro_torch.analysis.contracts``
(the counterpart of ``repro.kernels.contract``).

Every kernel module of the port declares its public entry points here as
:class:`KernelContract` rows: the wrapper itself, a builder that produces
operands on the ``meta`` device for a normalized :class:`KernelCase`
geometry, the oracle from :mod:`repro_torch.kernels.ref`, and the ``(op,
impl)`` registry pairs whose dispatch launches the kernel. The verifier
calls each wrapper on those ``meta`` operands: a ``meta`` tensor is no CUDA
tensor, so the wrapper takes its plain branch and no kernel runs, and its
output shapes and dtypes are held against the oracle's. On the card the
verifier also reads the launches each case would make from the library's
plan exports (grid, block, shared memory), again without launching.

Declaring a new kernel:

1. Write a builder ``(case: KernelCase) -> (args, fn_kwargs, ref_kwargs)``
   at the bottom of the kernel's own module.
2. ``declare_contract(KernelContract(name=..., kernel=..., fn=...,
   build=..., ref=..., serves=((op, impl), ...)))`` next to it, ``kernel``
   naming its entry of ``repro_torch.kernels.KERNELS``.
3. Add the oracle to ``ref.py`` if one does not exist yet.

``serves`` must name registered ``(op, impl)`` pairs
(:func:`repro_torch.core.policy.registered_kernels`); the verifier errors on
a non-exempt registered impl that no declaration covers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

#: Geometry axes follow the canonical dispatch shapes
#: (``repro_torch.tune.workloads.kernel_shape_cases``): ``t`` is the leading
#: time/batch axis (1 when the kernel has none), ``m`` the row axis, ``c``
#: the contraction axis (0 for elementwise/BN kernels with no matmul), ``k``
#: the output feature axis.


@dataclasses.dataclass(frozen=True)
class KernelCase:
    """One abstract geometry a kernel contract is checked at."""

    t: int
    m: int
    c: int
    k: int
    packed: bool = False
    dtype: str = "float32"

    @property
    def shape4(self) -> tuple[int, int, int, int]:
        return (self.t, self.m, self.c, self.k)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def meta(*shape: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """An operand of a builder: shape and dtype only, on the ``meta``
    device."""
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """Declaration of one kernel entry point's static contract.

    ``build(case)`` returns ``(args, fn_kwargs, ref_kwargs)`` where ``args``
    are ``meta`` tensors, ``fn_kwargs`` go to ``fn`` and ``ref_kwargs`` to
    ``ref``; the two are called on the *same* positional args so outputs can
    be compared leaf by leaf. ``build`` may raise :class:`SkipCase` for
    geometries the kernel legitimately never sees.
    """

    name: str
    #: The entry of ``repro_torch.kernels.KERNELS`` whose CUDA kernel the
    #: wrapper launches; the union of the ``serves`` of a kernel's contracts
    #: is that entry's ``serves`` (``audit.kernel.coverage`` checks it).
    kernel: str
    fn: Callable[..., Any]
    build: Callable[[KernelCase], tuple[tuple, dict, dict]]
    ref: Callable[..., Any] | None
    serves: tuple[tuple[str, str], ...]


class SkipCase(Exception):
    """Raised by a builder for a geometry the kernel never dispatches at
    (e.g. a packed arm with a ragged contraction: the planner demotes those
    before the kernel is reached)."""


_CONTRACTS: dict[str, KernelContract] = {}


def declare_contract(contract: KernelContract) -> KernelContract:
    if contract.name in _CONTRACTS:
        raise ValueError(f"duplicate kernel contract {contract.name!r}")
    _CONTRACTS[contract.name] = contract
    return contract


def kernel_contracts() -> dict[str, KernelContract]:
    """All declared contracts, importing the kernel modules on demand."""
    import repro_torch.kernels.conv_spike  # noqa: F401
    import repro_torch.kernels.fused_bn  # noqa: F401
    import repro_torch.kernels.lif_soma  # noqa: F401
    import repro_torch.kernels.neuron_layer  # noqa: F401
    import repro_torch.kernels.spike_matmul  # noqa: F401

    return dict(_CONTRACTS)
