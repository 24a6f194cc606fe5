"""Golden-file tests for the port's lint rules (``repro_torch.analysis.lint``):
every rule catches its known-bad snippet and stays silent on the known-good
twin, the ``# e2a-torch: ignore[...]`` allowlist works, the CLI turns
findings into exit codes, and the port's own tree lints clean. The snippets
live in ``tests/data/torch_lint/``, a directory the tree lint excludes (as
the reference's lint excludes ``tests/data/lint/``)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis.lint import (DEFAULT_PATHS, RULES, iter_py_files,
                                       lint_paths, lint_source)

DATA = Path(__file__).parent / "data" / "torch_lint"
REPO = Path(__file__).parent.parent

#: Findings each golden bad snippet must give, per rule.
BAD_COUNTS = {"E2A001": 2, "E2A005": 2, "E2A006": 5, "E2A101": 4,
              "E2A102": 2, "E2A103": 2, "E2A105": 2}


def _run_cli(*argv: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_the_catalog_is_the_kept_rules_and_the_ports_own():
    assert sorted(RULES) == sorted(BAD_COUNTS)
    assert not {"E2A002", "E2A003", "E2A004", "E2A007"} & set(RULES)


@pytest.mark.parametrize("rule", sorted(RULES))
def test_golden_bad_snippet_is_caught(rule):
    src = (DATA / f"{rule.lower()}_bad.py").read_text()
    findings = lint_source(src, f"{rule.lower()}_bad.py")
    hits = [f for f in findings if f.check == rule]
    assert len(hits) == BAD_COUNTS[rule], [f.format() for f in findings]
    assert all(f.level == "error" for f in findings)


@pytest.mark.parametrize("rule", sorted(RULES))
def test_golden_good_snippet_is_clean(rule):
    src = (DATA / f"{rule.lower()}_good.py").read_text()
    assert lint_source(src, f"{rule.lower()}_good.py") == []


def test_jax_imports_are_the_tests_business():
    """E2A101 spares the CPU tests, which hold the port against the
    reference and import both; the same source is port code elsewhere."""
    src = "import jax\nfrom repro.kernels import ref\n"
    assert [f.check for f in lint_source(src, "tests/test_torch_x.py")] == []
    assert [f.check for f in lint_source(src, "src/repro_torch/x.py")] == \
        ["E2A101", "E2A101"]
    assert [f.check for f in lint_source(src, "chip_smoke.py")] == \
        ["E2A101", "E2A101"]


def test_allowlist_comment_suppresses_named_rule():
    findings = lint_source((DATA / "allowlist.py").read_text())
    errors = [f for f in findings if f.level == "error"]
    assert [f.check for f in errors] == ["E2A005"]
    assert "wrong_rule" not in errors[0].message
    stale = [f for f in findings if f.check == "lint.ignore"]
    assert len(stale) == 1 and "E2A001" in stale[0].message


def test_unused_suppression_is_flagged_and_docstrings_do_not_count():
    src = ('"""mentions # e2a-torch: ignore[E2A005] in prose only."""\n'
           "x = 1   # e2a-torch: ignore[E2A005]\n")
    findings = lint_source(src)
    assert [f.check for f in findings] == ["lint.ignore"]
    assert findings[0].level == "warning" and ":2" in findings[0].where


def test_the_ports_tree_lints_clean():
    """``src/repro_torch``, ``chip_smoke.py``, ``benchmarks/torch`` and
    ``tests/test_torch_*.py``: no finding, no stale suppression."""
    paths = [REPO / p for p in DEFAULT_PATHS]
    files = list(iter_py_files(paths))
    assert REPO / "chip_smoke.py" in files
    assert REPO / "src" / "repro_torch" / "analysis" / "lint.py" in files
    assert any(f.name == "test_torch_lint.py" for f in files)
    assert not [f for f in files if "data" in f.parts]
    findings = lint_paths(paths)
    assert findings == [], "\n".join(f.format() for f in findings)


def test_cli_exit_codes_and_rules_flag():
    bad = _run_cli("--lint", "--paths", str(DATA / "e2a103_bad.py"))
    assert bad.returncode == 1, bad.stdout + bad.stderr
    assert "E2A103" in bad.stdout
    good = _run_cli("--lint", "--paths", str(DATA / "e2a103_good.py"))
    assert good.returncode == 0, good.stdout + good.stderr
    rules = _run_cli("--rules")
    assert rules.returncode == 0
    for rule in RULES:
        assert rule in rules.stdout
    drift = _run_cli("--bench-drift", "BENCH.json")
    assert drift.returncode == 2 and "--baseline" in drift.stderr


def test_syntax_error_is_reported_not_raised(tmp_path):
    f = tmp_path / "broken.py"
    f.write_text("def oops(:\n")
    findings = lint_paths([f])
    assert len(findings) == 1 and findings[0].check == "lint.parse"
    assert findings[0].level == "error"
