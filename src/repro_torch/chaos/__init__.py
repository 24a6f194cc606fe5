"""Deterministic fault injection for the whole stack (the counterpart of
``repro.chaos``).

The seeded chaos harness the guardrails are tested against: a serializable
:class:`FaultSchedule` names *what* fails and *when* (scopes
``chaos.step``, ``chaos.grad``, ``chaos.kernel.<site>``, ``chaos.ckpt``,
``chaos.serving.slot``), a :class:`ChaosInjector` activates it process
wide, and :mod:`repro_torch.chaos.runner` drives an end-to-end train run
under the schedule with orchestrator-style restart on failure.

Injection is **opt-in only**: every hook is a no-op unless a schedule was
explicitly activated (programmatically or via the ``CHAOS_SCHEDULE``
environment variable), so production paths pay a single ``is None`` check.
A ``chaos.kernel.<site>`` fault is the only exception the per-site circuit
breaker (``core.policy.dispatch_site``) absorbs: it demotes the site to its
eager arm; a real kernel error propagates.
"""
from repro_torch.chaos.inject import (ChaosInjector, ChaosKernelFault,
                                      ChaosStepFault, activate,
                                      activate_from_env, active, chaos,
                                      deactivate)
from repro_torch.chaos.schedule import SCOPES, FaultSchedule, FaultSpec

__all__ = [
    "ChaosInjector", "ChaosKernelFault", "ChaosStepFault", "FaultSchedule",
    "FaultSpec", "SCOPES", "activate", "activate_from_env", "active",
    "chaos", "deactivate",
]
