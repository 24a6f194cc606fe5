"""The dry run's reports (``launch.roofline``, ``launch.report``) render a
fixture cell as the reference's functions do, all but the titles, the
card's constants and the lever notes (which name the port's levers)."""
import json

import pytest

from repro_torch.launch import report, roofline

CELL = {
    "arch": "qwen3-0.6b", "shape": "decode_32k", "mesh": "data16",
    "devices": 16, "compile_s": 0.8,
    "bytes_per_device": {"argument": 31256871936, "output": 30069633024,
                         "temp": 60129574912, "peak": 91386446848},
    "hlo_flops_per_device": 69665292288.0,
    "hlo_bytes_per_device": 518904733984.0,
    "collective_bytes_per_device": {"all-gather": 2.5e9,
                                    "all-reduce": 1.25e8},
    "roofline": {"compute_s": 7.04e-05, "memory_s": 0.1549,
                 "collective_s": 0.0, "bound": "memory"},
    "model_flops_global": 152572002304,
    "model_flops_per_device": 9535750144.0,
    "useful_flops_ratio": 0.1369, "fits": False,
}
PERF = {"baseline": {"compute_s": 1.0e-3, "memory_s": 2.0e-3,
                     "collective_s": 3.0e-3, "peak_bytes": 5e9},
        "scatter_cache": {"compute_s": 1.0e-3, "memory_s": 1.0e-3,
                          "collective_s": 3.0e-3, "peak_bytes": None}}


@pytest.mark.parametrize("md", [False, True])
def test_fmt_row_equals_the_reference(md):
    from repro.launch import roofline as jroofline
    assert roofline.fmt_row(CELL, md) == jroofline.fmt_row(CELL, md)
    second = {**CELL, "useful_flops_ratio": None}
    assert roofline.fmt_row(second, md) == jroofline.fmt_row(second, md)


def _tables(text: str, lever: bool) -> list[str]:
    """The table rows and headers of a section: its title lines (which
    name the card) and blank lines left out, and where ``lever`` the last
    column, the lever note."""
    rows = [ln for ln in text.splitlines() if ln.startswith("|")]
    return [r.rsplit("|", 2)[0] for r in rows] if lever else rows


def test_sections_equal_the_reference(tmp_path, monkeypatch):
    from repro.launch import report as jreport
    meshes = {"data16": "pod16x16", "pod2xdata16": "pod2x16x16"}
    for port_mesh, ref_mesh in meshes.items():
        for base, mesh in ((tmp_path / "port", port_mesh),
                           (tmp_path / "ref", ref_mesh)):
            d = base / "dryrun" / mesh
            d.mkdir(parents=True)
            for shape in ("train_4k", "decode_32k"):
                (d / f"qwen3-0.6b__{shape}.json").write_text(
                    json.dumps({**CELL, "shape": shape}))
    for base in (tmp_path / "port", tmp_path / "ref"):
        (base / "perf").mkdir()
        (base / "perf" / "pixtral-12b__decode_32k.json").write_text(
            json.dumps(PERF))
    monkeypatch.setattr(report, "BASE", str(tmp_path / "port"))
    monkeypatch.setattr(jreport, "BASE", str(tmp_path / "ref"))
    for name in ("dryrun_section", "roofline_section", "perf_section"):
        got, want = getattr(report, name)(), getattr(jreport, name)()
        lever = name == "roofline_section"
        assert _tables(got, lever) == _tables(want, lever), name
        assert len(_tables(got, lever)) > 2
    assert "H100" in report.roofline_section()
    assert "2 cells, 0 fit in 80 GB" in report.dryrun_section()


def test_roofline_main_names_the_card(tmp_path, monkeypatch, capsys):
    d = tmp_path / "data16"
    d.mkdir()
    (d / "a.json").write_text(json.dumps(CELL))
    monkeypatch.setattr(roofline, "load_cells", lambda mesh: [CELL])
    roofline.main(["--md"])
    out = capsys.readouterr().out
    assert roofline.fmt_row(CELL, True) in out
    assert "H100" in out and "989 TFLOP/s" in out
    assert "1 cells on data16; dominant bounds: {'memory': 1}" in out
