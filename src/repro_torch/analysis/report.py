"""Finding records shared by the analysis passes (lint / audit /
contracts), a copy of ``repro.analysis.report``.

Every check emits :class:`Finding` rows instead of printing or raising, so
one CLI (``python -m repro_torch.analysis``) can aggregate them, render one
report, and turn severity into an exit code uniformly:

* ``error``   — a violated invariant; fails the CI ``analysis`` leg.
* ``warning`` — reported but non-fatal (``--strict`` promotes to error).
* ``info``    — context rows (``--verbose`` shows them).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

LEVELS = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analysis result row.

    ``check`` names the rule or audit pass (``E2A001`` ... for lint rules,
    dotted names like ``audit.plan.packing`` for audit checks); ``where``
    locates it (``path:line`` for lint, ``preset@policy/site`` for audit).
    """

    level: str
    check: str
    where: str
    message: str

    def __post_init__(self):
        if self.level not in LEVELS:
            raise ValueError(f"unknown level {self.level!r}; "
                             f"expected one of {LEVELS}")

    def format(self) -> str:
        return f"{self.level.upper():7s} {self.check:22s} " \
               f"{self.where}: {self.message}"


def error(check: str, where: str, message: str) -> Finding:
    return Finding("error", check, where, message)


def warning(check: str, where: str, message: str) -> Finding:
    return Finding("warning", check, where, message)


def info(check: str, where: str, message: str) -> Finding:
    return Finding("info", check, where, message)


def promote_warnings(findings: Iterable[Finding]) -> list[Finding]:
    """``--strict``: every warning becomes an error."""
    return [dataclasses.replace(f, level="error")
            if f.level == "warning" else f for f in findings]


def render(findings: Sequence[Finding], *, verbose: bool = False) -> str:
    """One line per finding (errors first), plus a summary line."""
    order = {lvl: i for i, lvl in enumerate(LEVELS)}
    shown = [f for f in findings if verbose or f.level != "info"]
    lines = [f.format() for f in
             sorted(shown, key=lambda f: (order[f.level], f.where))]
    counts = {lvl: sum(1 for f in findings if f.level == lvl)
              for lvl in LEVELS}
    lines.append(f"{counts['error']} error(s), {counts['warning']} "
                 f"warning(s), {counts['info']} info")
    return "\n".join(lines)


def exit_code(findings: Sequence[Finding]) -> int:
    """Non-zero iff any finding is an error."""
    return 1 if any(f.level == "error" for f in findings) else 0


def findings_json(findings: Sequence[Finding]) -> dict:
    """Machine-readable report: the rows plus per-level counts (the shape
    CI uploads as the ``findings.json`` artifact)."""
    return {
        "findings": [dataclasses.asdict(f) for f in findings],
        "counts": {lvl: sum(1 for f in findings if f.level == lvl)
                   for lvl in LEVELS},
    }


def write_json(findings: Sequence[Finding], path) -> None:
    """Serialize :func:`findings_json` to ``path``."""
    import json
    from pathlib import Path
    Path(path).write_text(
        json.dumps(findings_json(findings), indent=2) + "\n")


__all__ = ["Finding", "LEVELS", "error", "exit_code", "findings_json",
           "info", "promote_warnings", "render", "warning", "write_json"]
