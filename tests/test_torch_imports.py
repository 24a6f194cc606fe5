"""What the port may import, when it builds, and what it does without a
card: ``repro_torch`` and ``chip_smoke.py`` import ``torch`` and numpy,
never ``jax`` and nothing of ``repro``; importing builds nothing; every
entry point called with ``device=None`` (the Spikingformer's, the LM's,
the serving engine's and the training driver's) fails loudly where there is
no CUDA device."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import probe, resolve_device
from repro_torch.configs import get_spikingformer_config
from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import from_jax, lm_from_jax
from repro_torch.core.spikingformer import SpikingFormer, init_spikingformer
from repro_torch.kernels import build
from repro_torch.launch.mesh import init_distributed, make_test_mesh
from repro_torch.launch.train import build_state, main, train
from repro_torch.models.common import split_tree
from repro_torch.models.lm import init_cache, init_lm
from repro_torch.serving import ServingEngine

ROOT = Path(__file__).resolve().parent.parent
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))


def _run(code: str, cwd=ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})


def test_modules_are_where_the_reference_has_them():
    for name in ("core.backend", "core.policy", "core.lif",
                 "core.spiking_layers", "core.spikingformer",
                 "kernels.lif_soma", "kernels.spike_matmul",
                 "kernels.conv_spike", "kernels.neuron_layer", "kernels.ops",
                 "kernels.fused_bn", "configs.spikingformer",
                 "train.optimizer", "train.data", "train.loop",
                 "configs.base", "configs.registry", "models.common",
                 "models.attention", "models.mlp", "models.lm", "models.moe",
                 "models.mla", "models.rwkv", "models.ssm", "serving.engine",
                 "serving.scheduler", "train.checkpoint", "train.resilience",
                 "launch.train", "launch.mesh", "launch.specs",
                 "launch.dryrun", "launch.roofline", "launch.report",
                 "launch.perf",
                 "core.energy.constants",
                 "core.energy.dataflow", "core.energy.energy_model",
                 "core.energy.simulator", "core.energy.workload",
                 "analysis.audit", "tune.table", "tune.workloads",
                 "tune.oracle", "tune.sparsity", "tune.autotune",
                 "kernels.ref", "kernels.contract", "analysis.report",
                 "analysis.tracing", "analysis.contracts", "analysis.lint",
                 "analysis.__main__"):
        assert f"repro_torch.{name}" in MODULES
        assert (ROOT / "src" / "repro" / (name.replace(".", "/") + ".py")) \
            .is_file()


def test_the_analysis_modules_name_neither_jax_nor_repro():
    """The modules of the kernel oracles, the contracts and the analysis,
    and ``chip_smoke.py``, have no import of ``jax`` or ``repro`` in their
    source, not even one a branch never reaches (the port's lint rule
    E2A101 reads every import statement)."""
    from repro_torch.analysis.lint import lint_source

    files = [ROOT / "chip_smoke.py"] + [
        ROOT / "src" / "repro_torch" / f for f in (
            "kernels/ref.py", "kernels/contract.py", "analysis/__init__.py",
            "analysis/report.py", "analysis/tracing.py",
            "analysis/contracts.py", "analysis/audit.py", "analysis/lint.py",
            "analysis/__main__.py")]
    for f in files:
        found = [x for x in lint_source(f.read_text(), str(f))
                 if x.check == "E2A101"]
        assert found == [], (f, found)


def test_importing_every_module_leaves_jax_and_repro_out():
    code = (
        "import importlib, sys\n"
        f"mods = {MODULES!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import build\n"
        "assert build._lib is None, 'importing built the kernels'\n"
        "print('clean', len(mods))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["clean", str(len(MODULES))]


def test_the_tune_package_imports_only_its_table():
    """``repro_torch.tune`` sits on the dispatch path: importing it (and the
    model, which consults its table) loads ``tune.table`` alone; the other
    submodules load on first use of one of their names."""
    code = (
        "import sys\n"
        "import repro_torch.core.spikingformer, repro_torch.tune as t\n"
        "lazy = ('workloads', 'oracle', 'sparsity', 'autotune')\n"
        "got = [m for m in lazy if 'repro_torch.tune.' + m in sys.modules]\n"
        "assert 'repro_torch.tune.table' in sys.modules\n"
        "assert not got, got\n"
        "assert t.oracle_rank.__module__ == 'repro_torch.tune.oracle'\n"
        "assert t.tune.__module__ == 'repro_torch.tune.autotune'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('lazy')\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["lazy"]


def test_sources_name_neither_jax_nor_the_reference_package():
    files = list((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    for f in files:
        assert not pat.search(f.read_text()), f


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "repro_torch" in out.stderr


def test_device_none_means_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    cfg = get_spikingformer_config("spikingformer-smoke")
    gen = torch.Generator().manual_seed(0)
    lm_cfg = reduced(get_config("qwen3-0.6b"))
    lm_params = split_tree(init_lm(gen, lm_cfg, device="cpu"))[0]
    calls = {
        "resolve_device": lambda: resolve_device(None),
        "explicit cuda": lambda: resolve_device("cuda:0"),
        "init_spikingformer": lambda: init_spikingformer(gen, cfg),
        "SpikingFormer": lambda: SpikingFormer(cfg),
        "from_jax": lambda: from_jax({"w": np.zeros(3, np.float32)}, {}),
        "init_lm": lambda: init_lm(gen, lm_cfg),
        "init_cache": lambda: init_cache(lm_cfg, 1, 8),
        "lm_from_jax": lambda: lm_from_jax({"w": np.zeros(3, np.float32)}),
        "ServingEngine": lambda: ServingEngine(lm_params, lm_cfg),
        "build_state": lambda: build_state(lm_cfg),
        "train": lambda: train(lm_cfg, steps=1, global_batch=1),
        "train (vision)": lambda: train(cfg, steps=1, global_batch=1),
        "init_distributed": lambda: init_distributed(),
        "make_test_mesh": lambda: make_test_mesh(1, 1),
        "launch.train main": lambda: main(["--arch", "qwen3-0.6b",
                                           "--reduced", "--steps", "1"]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    info = probe()
    assert info["cuda_available"] is False and info["device_name"] is None
    assert info["torch"] == torch.__version__


def test_a_missing_compiler_raises_with_a_reason(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    for var in ("CUDA_HOME", "CUDA_PATH"):
        monkeypatch.setenv(var, str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has the CUDA toolkit")
    assert build.find_nvcc(required=False) is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "b").exists()       # nothing half-built


def test_c_interface_matches_the_ctypes_signatures():
    """Every ``extern "C"`` entry point of the CUDA sources has its argument
    types listed in ``build.SIGNATURES``, pointer for pointer: a pointer
    passed without its ``c_void_p`` would be cut to 32 bits."""
    import ctypes
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
             ctypes.c_longlong: "long long", ctypes.c_float: "float"}
    found = {}
    for src in build.sources():
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            args = [a.strip() for a in m.group(2).replace("\n", " ").split(",")]
            found[m.group(1)] = [
                "ptr" if "*" in a else a.rsplit(" ", 1)[0].strip()
                for a in args]
    assert set(found) == set(build.SIGNATURES)
    for name, argtypes in build.SIGNATURES.items():
        assert [kinds[t] for t in argtypes] == found[name], name
    assert [s.name for s in build.sources()] == [
        "fused_bn.cu", "lif_soma.cu", "neuron_layer.cu", "spike_matmul.cu",
        "spike_pack.cu"]
    assert "compute_90a" in " ".join(build.NVCC_FLAGS)


def test_python_tile_constants_mirror_the_cuda_sources():
    """The wrappers size their scratch from constants that mirror the CUDA
    sources: the packed train arm's 256-row tile (the ``Large`` tile of the
    shared tensor-core mainloop), its 192-row tile at bf16 on the wgmma
    mainloop (three consumer warpgroups of 64 rows) and the plan kernels
    that tell them apart, the dense arm's 1,024-row tile, and the columns
    one arrival counter of ``bn_fwd`` serves."""
    from repro_torch.kernels import fused_bn, neuron_layer
    src = {p.name: p.read_text() for p in build.CSRC.glob("*.cu*")}
    large = re.search(r"using Large = Tile<(\d+), (\d+), (\d+), (\d+), "
                      r"(\d+), (\d+)>;", src["spike_mma_mainloop.cuh"])
    warps_m, _, wm, *_ = map(int, large.groups())
    assert 16 * wm * warps_m == neuron_layer.TILE_ROWS
    assert "using ZTile = e2a::mma::Large;" in src["neuron_layer.cu"]
    dense = re.search(r"constexpr int DENSE_TILE_ROWS = (\d+);",
                      src["neuron_layer.cu"])
    assert int(dense.group(1)) == neuron_layer.DENSE_TILE_ROWS
    cols = re.search(r"constexpr int BN_COLS = (\d+);", src["fused_bn.cu"])
    assert int(cols.group(1)) == fused_bn.COUNTER_COLS
    cwg = re.search(r"constexpr int ZW_CWG = (\d+);", src["neuron_layer.cu"])
    assert 64 * int(cwg.group(1)) == neuron_layer.WGMMA_TILE_ROWS
    assert "using ZWide = e2a::wg::WTile<ZW_CWG, " in src["neuron_layer.cu"]
    assert "static constexpr int BM = 64 * CWG" in src["wgmma_mainloop.cuh"]
    enum = re.search(r"enum Kernel \{([^}]*)\}", src["neuron_layer.cu"])
    names = [n.strip() for n in enum.group(1).split(",")]
    assert [names.index(n) for n in ("Z_DENSE", "Z_MMA", "Z_WGMMA")] == [
        neuron_layer.Z_DENSE, neuron_layer.Z_MMA, neuron_layer.Z_WGMMA]


def test_one_tensor_core_mainloop():
    """The spike matmul and the neuron layer's packed arms, train and eval,
    multiply through one contraction loop: the only MMAs are those of
    ``spike_mma_mainloop.cuh``, which both kernels' sources include, so the
    spike matmul's bitwise checks on the card hold the neuron layer's
    product too; the dense arms' fp32 kernels take no packed input and
    call no MMA."""
    src = {p.name: p.read_text() for p in build.CSRC.glob("*.cu*")}
    calls = {name for name, text in src.items()
             if re.search(r"\bmma_bf16\(acc", text)}
    assert calls == {"spike_mma_mainloop.cuh"}
    for name in ("spike_matmul.cu", "neuron_layer.cu"):
        assert '#include "spike_mma_mainloop.cuh"' in src[name]
        assert "mainloop<" in src[name]
    nl = src["neuron_layer.cu"]
    for kernel in ("neuron_layer_eval_mma", "neuron_layer_train_z_mma"):
        body = nl[nl.index(f"    {kernel}("):]
        body = body[:body.index("\n}\n")]
        assert "mainloop<" in body, kernel
    dense = nl[nl.index("// ---- the dense arms"):
               nl.index("// ---- eval, packed arm ----")]
    for kernel in ("neuron_layer_eval_dense", "neuron_layer_train_z_dense"):
        assert f" {kernel}(" in dense, kernel
    assert "uint8_t" not in dense and "mainloop<" not in dense
    assert "spike_tile.cuh" not in src and all(
        "spike_tile.cuh" not in text for text in src.values())
