"""CLI for the port's analysis: ``python -m repro_torch.analysis``.

    python -m repro_torch.analysis --lint --audit --contracts   # everything
    python -m repro_torch.analysis --contracts --batch 16       # contracts
    python -m repro_torch.analysis --lint --paths src/repro_torch
    python -m repro_torch.analysis --bench-drift BENCH.json --baseline BASE.json
    python -m repro_torch.analysis --rules                      # lint catalog

On a machine without a CUDA device the launch family of ``--contracts`` and
the shared-memory check of ``--audit`` do not run (each says so in an
``info`` row, shown with ``-v``); on the card they read every launch from
the built library's plan exports, launching nothing. Exit status is 0 when
no check reports an error; ``--strict`` promotes warnings to errors (bench
drift among them). ``--bench-drift`` takes no default ``--baseline``: the
reference's ``benchmarks/BENCH_seed.json`` measures the JAX package, and
the port has no snapshot of its own until its benchmark exists.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Kernel contracts, execution-plan audit and lint of the "
                    "PyTorch/CUDA port")
    ap.add_argument("--lint", action="store_true",
                    help="run the port's lint rules over --paths")
    ap.add_argument("--audit", action="store_true",
                    help="audit execution plans, serving caches, the tuned "
                         "table and mesh renders for every config x policy")
    ap.add_argument("--contracts", action="store_true",
                    help="verify the kernel contracts (coverage, reference "
                         "parity on meta tensors, launch limits on the "
                         "card, autograd cotangents, config hashing); "
                         "launches no kernel")
    ap.add_argument("--bench-drift", metavar="BENCH_JSON", default=None,
                    help="diff a BENCH.json artifact against --baseline")
    ap.add_argument("--baseline", default=None,
                    help="snapshot for --bench-drift (required with it: the "
                         "port has no committed snapshot)")
    ap.add_argument("--paths", nargs="*", default=None,
                    help="lint roots (default: the port's tree, "
                         "src/repro_torch chip_smoke.py benchmarks/torch "
                         "examples/torch tests/test_torch_*.py)")
    ap.add_argument("--batch", type=int, default=1,
                    help="global batch of the contract geometries and the "
                         "audit's shared-memory reads (default: "
                         "%(default)s)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the findings (post --strict promotion) "
                         "as machine-readable JSON to PATH")
    ap.add_argument("--strict", action="store_true",
                    help="promote warnings to errors")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print info findings")
    ap.add_argument("--rules", action="store_true",
                    help="print the lint-rule catalog and exit")
    args = ap.parse_args(argv)

    if args.rules:
        from repro_torch.analysis.lint import RULES
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0
    if not (args.lint or args.audit or args.contracts or args.bench_drift):
        ap.error("nothing to do: pass --lint, --audit, --contracts and/or "
                 "--bench-drift")
    if args.bench_drift and args.baseline is None:
        ap.error("--bench-drift needs --baseline: the port has no "
                 "committed snapshot to compare against")

    findings = []
    if args.lint:
        from repro_torch.analysis.lint import DEFAULT_PATHS, lint_paths
        paths = args.paths if args.paths is not None else [
            p for p in DEFAULT_PATHS
            if any(Path(".").glob(p)) or Path(p).exists()]
        findings += lint_paths(paths)
    if args.audit:
        from repro_torch.analysis.audit import run_audit
        findings += run_audit(batch=args.batch)
    if args.contracts:
        from repro_torch.analysis.contracts import run_contracts
        findings += run_contracts(batch=args.batch)
    if args.bench_drift:
        from repro_torch.analysis.drift import bench_drift
        findings += bench_drift(args.bench_drift, args.baseline)

    from repro_torch.analysis.report import (exit_code, promote_warnings,
                                             render, write_json)
    if args.strict:
        findings = promote_warnings(findings)
    if args.json:
        write_json(findings, args.json)
    print(render(findings, verbose=args.verbose))
    return exit_code(findings)


if __name__ == "__main__":
    sys.exit(main())
