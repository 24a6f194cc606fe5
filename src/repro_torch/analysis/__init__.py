"""Static analysis of the port (the counterpart of ``repro.analysis``):
kernel contracts, plan audit, the port's lint, the signature guards and
bench drift.
CLI: ``python -m repro_torch.analysis``.

Submodules are imported lazily: ``repro_torch.analysis.tracing`` is used on
the serving engine's path and must not drag the lint, audit and contract
machinery (or model imports) in with it.
"""
from __future__ import annotations

from typing import Any

__all__ = ["Finding", "assert_signature_count", "bench_drift", "lint_paths",
           "lint_source",
           "run_audit", "run_contracts", "signature_count",
           "track_signatures"]

_LAZY = {
    "Finding": ("repro_torch.analysis.report", "Finding"),
    "assert_signature_count": ("repro_torch.analysis.tracing",
                               "assert_signature_count"),
    "bench_drift": ("repro_torch.analysis.drift", "bench_drift"),
    "lint_paths": ("repro_torch.analysis.lint", "lint_paths"),
    "lint_source": ("repro_torch.analysis.lint", "lint_source"),
    "run_audit": ("repro_torch.analysis.audit", "run_audit"),
    "run_contracts": ("repro_torch.analysis.contracts", "run_contracts"),
    "signature_count": ("repro_torch.analysis.tracing", "signature_count"),
    "track_signatures": ("repro_torch.analysis.tracing", "track_signatures"),
}


def __getattr__(name: str) -> Any:
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib
    return getattr(importlib.import_module(module), attr)
