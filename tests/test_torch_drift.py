"""``repro_torch.analysis.drift`` against ``repro.analysis.drift``: both
packages' ``bench_drift`` on the same fixture files, written to
``tmp_path``, give equal findings (check, location, level, message); and
the port's ``--bench-drift`` command line, which takes no default
``--baseline``. No test reads a file of ``benchmarks/``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import __main__ as jax_cli
from repro.analysis.drift import bench_drift as jax_bench_drift
from repro_torch.analysis import __main__ as torch_cli
from repro_torch.analysis.drift import bench_drift, load_report

REPO = Path(__file__).resolve().parents[1]

BASE = {"smoke": True, "sections": {
    "energy": {"latency_cycles": 1234, "energy_mj": 5.5,
               "per_dataflow": {"IP-OS": 1.0, "OP-WS": 2.0}},
    "serving": {"tokens_per_sec": 100.0, "wall_seconds": 3.0,
                "decode_traces": 1, "p50_ms": 4.0},
    "kernels": {"spike_mm_us": 12.0, "max_err": 1e-7}}}


def _variant(name: str) -> dict:
    """The baseline changed in one way each."""
    cur = json.loads(json.dumps(BASE))
    secs = cur["sections"]
    if name == "same":
        pass
    elif name == "missing_section":
        del secs["kernels"]
    elif name == "missing_metric":
        del secs["energy"]["per_dataflow"]["OP-WS"]
        del secs["serving"]["decode_traces"]
    elif name == "drifted":
        secs["energy"]["energy_mj"] = 5.6
        secs["energy"]["per_dataflow"]["IP-OS"] = 1.0 + 1e-9   # within rtol
        secs["kernels"]["max_err"] = 2e-7
    elif name == "timing":
        secs["serving"].update(tokens_per_sec=1.0, wall_seconds=99.0,
                               p50_ms=40.0)
        secs["kernels"]["spike_mm_us"] = 1.0
    elif name == "smoke":
        cur["smoke"] = False
    elif name == "new_metrics":
        secs["energy"].update({f"extra_{i}": i for i in range(7)})
        secs["serving"]["queue_depth"] = 3
        secs["serving"]["flag"] = True          # not numeric: ignored
    else:
        raise ValueError(name)
    return cur


CASES = ["same", "missing_section", "missing_metric", "drifted", "timing",
         "smoke", "new_metrics"]


def _write(tmp_path, name: str, report) -> str:
    path = tmp_path / name
    path.write_text(report if isinstance(report, str) else
                    json.dumps(report))
    return str(path)


def _rows(findings):
    return [(f.check, f.where, f.level, f.message) for f in findings]


@pytest.mark.parametrize("case", CASES)
def test_findings_equal_the_references(tmp_path, case):
    base = _write(tmp_path, "base.json", BASE)
    cur = _write(tmp_path, "cur.json", _variant(case))
    got = _rows(bench_drift(cur, base))
    assert got == _rows(jax_bench_drift(cur, base))
    levels = {lvl for _, _, lvl, _ in got}
    want = {"same": {"info"}, "missing_section": {"error", "info"},
            "missing_metric": {"error", "info"},
            "drifted": {"warning", "info"}, "timing": {"info"},
            "smoke": {"info"}, "new_metrics": {"info"}}[case]
    assert levels == want, got


@pytest.mark.parametrize("which", ["current", "baseline", "both", "missing"])
def test_an_unreadable_file_gives_the_references_finding(tmp_path, which):
    good = _write(tmp_path, "good.json", BASE)
    bad = _write(tmp_path, "bad.json", "{not json")
    if which == "missing":
        cur, base = str(tmp_path / "absent.json"), good
    else:
        cur = bad if which in ("current", "both") else good
        base = bad if which in ("baseline", "both") else good
    got = _rows(bench_drift(cur, base))
    assert got == _rows(jax_bench_drift(cur, base))
    assert [lvl for _, _, lvl, _ in got] == ["error"]
    assert got[0][0] == "drift.load"


def test_a_drifted_value_names_both_values_and_the_rate(tmp_path):
    base = _write(tmp_path, "base.json", BASE)
    cur = _write(tmp_path, "cur.json", _variant("drifted"))
    warns = [f for f in bench_drift(cur, base) if f.level == "warning"]
    assert [f.where for f in warns] == ["energy/energy_mj",
                                        "kernels/max_err"]
    assert warns[0].message.startswith("5.5 (seed) -> 5.6 (rel ")
    assert load_report(cur)["sections"]["energy"]["energy_mj"] == 5.6


def _cli(module, argv, capsys):
    code = module.main(argv)
    return code, capsys.readouterr().out


@pytest.mark.parametrize("case,strict", [
    ("same", False), ("drifted", False), ("drifted", True),
    ("missing_metric", False), ("timing", False)])
def test_the_cli_prints_and_exits_as_the_references(tmp_path, capsys, case,
                                                     strict):
    base = _write(tmp_path, "base.json", BASE)
    cur = _write(tmp_path, "cur.json", _variant(case))
    argv = ["--bench-drift", cur, "--baseline", base, "-v"] + (
        ["--strict"] if strict else [])
    got = _cli(torch_cli, argv, capsys)
    assert got == _cli(jax_cli, argv, capsys)
    assert got[0] == {"same": 0, "drifted": int(strict),
                      "missing_metric": 1, "timing": 0}[case]


def test_the_cli_writes_the_findings_as_json(tmp_path, capsys):
    base = _write(tmp_path, "base.json", BASE)
    cur = _write(tmp_path, "cur.json", _variant("missing_section"))
    out = tmp_path / "findings.json"
    assert torch_cli.main(["--bench-drift", cur, "--baseline", base,
                           "--json", str(out)]) == 1
    capsys.readouterr()
    rows = json.loads(out.read_text())
    assert any(r["check"] == "drift.bench" and r["level"] == "error"
               for r in (rows if isinstance(rows, list)
                         else rows["findings"]))


def test_the_cli_refuses_bench_drift_without_a_baseline(tmp_path, capsys):
    cur = _write(tmp_path, "cur.json", BASE)
    with pytest.raises(SystemExit) as e:
        torch_cli.main(["--bench-drift", cur])
    assert e.value.code == 2
    assert "--baseline" in capsys.readouterr().err


def test_the_command_line_runs_the_drift_mode(tmp_path):
    """``python -m repro_torch.analysis --bench-drift A --baseline B`` in
    a process of its own: the mode counts alone (no other flag), exit 1 on
    a missing section, the finding printed."""
    base = _write(tmp_path, "base.json", BASE)
    cur = _write(tmp_path, "cur.json", _variant("missing_section"))
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--bench-drift", cur,
         "--baseline", base], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 1, out.stdout + out.stderr
    assert "drift.bench" in out.stdout and "kernels" in out.stdout
