"""The port's examples (``examples/torch/``) on the CPU: ``explore_dataflows``
prints the reference script's lines (the reference run through ``runpy``),
``quickstart``'s ``[sim]`` lines are the reference's figures from
``repro.core.energy``, and ``quickstart``, ``train_spikingformer`` and
``serve_lm`` run to their end with ``--device cpu`` at a few steps."""
import importlib.util
import math
import re
import runpy
from pathlib import Path

import pytest

from repro.core.energy import E2ATSTSimulator as JaxSimulator

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples" / "torch"
NAMES = ["quickstart", "train_spikingformer", "serve_lm",
         "explore_dataflows"]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name: str, argv: list[str], capsys) -> str:
    capsys.readouterr()
    _load(name).main(argv)
    return capsys.readouterr().out


def test_every_reference_example_has_a_twin_with_a_main():
    assert sorted(p.stem for p in (REPO / "examples").glob("*.py")) == \
        sorted(NAMES)
    for name in NAMES:
        assert callable(_load(name).main)


def test_explore_dataflows_prints_the_references_lines(capsys):
    capsys.readouterr()
    runpy.run_path(str(REPO / "examples" / "explore_dataflows.py"),
                   run_name="__main__")
    want = capsys.readouterr().out
    got = _run("explore_dataflows", [], capsys)
    assert got == want
    assert got.count("opt=") == 1 + 4 + 5 + 4


def _reference_sim_lines() -> list[str]:
    """The reference quickstart's two ``[sim]`` lines, its format strings
    on ``repro.core.energy``'s figures."""
    sim = JaxSimulator()
    best = sim.optimal(metric="energy")
    m = sim.table_ix()
    return [f"[sim] optimal dataflow: {best.dataflow}  "
            f"energy={best.energy_j * 1e3:.0f} mJ/step  "
            f"latency={best.latency_s * 1e3:.0f} ms/step",
            f"[sim] Table IX: {m['eff_tflops']:.2f} TFLOPS @ "
            f"{m['power_w']:.2f} W => {m['tflops_per_w']:.2f} TFLOPS/W "
            f"(util {m['mac_utilization']:.0%})"]


def test_quickstart_runs_and_prints_the_references_sim_lines(capsys):
    out = _run("quickstart", ["--device", "cpu"], capsys).splitlines()
    assert [ln for ln in out if ln.startswith("[sim]")] == \
        _reference_sim_lines()
    losses = [float(ln.split()[-1]) for ln in out
              if ln.startswith("[snn] step")]
    assert len(losses) == 5 and all(map(math.isfinite, losses))
    assert math.isfinite(float(re.search(
        r"train loss (\S+)", "\n".join(out)).group(1)))
    assert out[-1] == "[lm ] decode logits (2, 512) — quickstart OK"


def test_train_spikingformer_runs_on_the_cpu(capsys, tmp_path):
    out = _run("train_spikingformer", ["--steps", "3", "--batch", "4",
                                       "--device", "cpu"], capsys)
    steps = re.findall(r"^step\s+(\d+) loss (\S+)", out, re.M)
    assert [int(s) for s, _ in steps] == [0, 2]
    assert all(math.isfinite(float(v)) for _, v in steps)
    assert "(chance loss = 1.386)" in out


def test_serve_lm_runs_on_the_cpu(capsys):
    out = _run("serve_lm", ["--train-steps", "3", "--requests", "2",
                            "--device", "cpu"], capsys)
    first, last = map(float, re.search(
        r"trained: loss (\S+) -> (\S+)", out).groups())
    assert math.isfinite(first) and math.isfinite(last)
    assert len(re.findall(r"^req \d+: prompt=", out, re.M)) == 2
    hits, total = map(int, re.search(
        r"bigram-consistency of generations: (\d+)/(\d+)", out).groups())
    assert total == 2 * 8 and 0 <= hits <= total


@pytest.mark.parametrize("name", ["quickstart", "train_spikingformer",
                                  "serve_lm"])
def test_an_example_refuses_the_card_where_there_is_none(name, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        _load(name).main([])
