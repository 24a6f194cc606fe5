"""BENCH.json drift detection against a baseline snapshot (a copy of
``repro.analysis.drift``).

``python -m repro_torch.analysis --bench-drift CURRENT --baseline BASE``
diffs a fresh BENCH.json against a committed snapshot:

* a section or metric present in the baseline but missing now — **error**
  (a benchmark silently stopped reporting);
* a *deterministic* metric whose value moved beyond tolerance —
  **warning** (seeded traces and the analytic energy model should
  reproduce bit-for-bit; real drift means the modeled system changed);
* timing metrics (wall seconds, tokens/sec, compile time, ...) — never
  compared; they measure the host, not the code.

Snapshots with different ``smoke`` flags are not comparable (info only).
The findings (check, location, level, message) are the reference's, letter
for letter. Unlike the reference's CLI, the port's gives ``--baseline`` no
default: ``benchmarks/BENCH_seed.json`` measures the JAX package, and the
port has no snapshot of its own until its benchmark exists.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

from repro_torch.analysis.report import Finding, error, info, warning

__all__ = ["bench_drift", "load_report"]

#: Metric-name fragments that measure wall-clock, not behavior. (The
#: analytic ``latency_cycles`` of the energy section is NOT timing — it is
#: a deterministic model output and *should* drift-compare.)
_TIMING_RE = re.compile(
    r"seconds|_per_sec|latency_s\b|generated_unix|^_section"
    r"|us_per_call|_us\b|_ms\b|\bus_per_sim\b")


def load_report(path: str | Path) -> dict:
    return json.loads(Path(path).read_text())


def _flat(section: dict, prefix: str = "") -> dict[str, float]:
    """Flatten ``metric -> scalar | {col: scalar}`` to dotted keys,
    numeric values only."""
    out: dict[str, float] = {}
    for key, val in section.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flat(val, f"{name}."))
        elif isinstance(val, (int, float)) and not isinstance(val, bool):
            out[name] = float(val)
    return out


def bench_drift(current: str | Path, baseline: str | Path, *,
                rtol: float = 1e-6) -> list[Finding]:
    """Diff ``current`` BENCH.json against the ``baseline`` snapshot."""
    try:
        cur = load_report(current)
    except (OSError, ValueError) as e:
        return [error("drift.load", str(current),
                      f"cannot read current BENCH.json: {e}")]
    try:
        base = load_report(baseline)
    except (OSError, ValueError) as e:
        return [error("drift.load", str(baseline),
                      f"cannot read baseline: {e} — regenerate with "
                      f"`python benchmarks/run.py --smoke --json "
                      f"benchmarks/BENCH_seed.json`")]

    if cur.get("smoke") != base.get("smoke"):
        return [info("drift.bench", str(current),
                     f"smoke={cur.get('smoke')} vs baseline "
                     f"smoke={base.get('smoke')}: not comparable")]

    findings: list[Finding] = []
    cur_sections = cur.get("sections", {})
    for sec_name, base_sec in base.get("sections", {}).items():
        cur_sec = cur_sections.get(sec_name)
        if cur_sec is None:
            findings.append(error("drift.bench", sec_name,
                                  "section present in the seed snapshot "
                                  "but missing from the current run"))
            continue
        b, c = _flat(base_sec), _flat(cur_sec)
        drifted = same = 0
        for metric, bval in b.items():
            if _TIMING_RE.search(metric):
                continue
            if metric not in c:
                findings.append(error(
                    "drift.bench", f"{sec_name}/{metric}",
                    "metric present in the seed but missing now"))
                continue
            cval = c[metric]
            denom = max(abs(bval), abs(cval), 1e-12)
            if abs(cval - bval) / denom > rtol:
                drifted += 1
                findings.append(warning(
                    "drift.bench", f"{sec_name}/{metric}",
                    f"{bval!r} (seed) -> {cval!r} "
                    f"(rel {abs(cval - bval) / denom:.2e})"))
            else:
                same += 1
        new = sorted(set(c) - set(b))
        if new:
            findings.append(info("drift.bench", sec_name,
                                 f"{len(new)} new metric(s): "
                                 f"{', '.join(new[:5])}"
                                 f"{'...' if len(new) > 5 else ''}"))
        findings.append(info("drift.bench", sec_name,
                             f"{same} metric(s) match, {drifted} drifted"))
    return findings
