"""Builds and loads the CUDA kernels of the port.

The sources are ``csrc/*.cu`` (and the ``*.cuh`` they include) beside this
file. They are plain CUDA C++ with a C interface and include nothing of
PyTorch, so ``nvcc`` compiles each in a few seconds. :func:`load` compiles
them for ``sm_90a`` the first time a kernel is launched — one ``nvcc -c``
per source, all started together, then one link — into
``build/repro_torch/`` at the repository root, and opens the shared library
with ``ctypes``. The library's name carries a hash of the sources and the
flags, so an edited source is rebuilt and an unchanged one is not.

Importing this module (or any other module of the package) builds nothing
and needs no compiler. A missing ``nvcc`` or a failed compile raises with
the compiler's output; nothing falls back to another implementation.

Every entry point ``e2a_<name>`` has a twin ``e2a_<name>_plan`` that takes
the same arguments without the stream and reports the launches the entry
point would make (``csrc/launch_plan.cuh``) without making them. Inside
:func:`plan_launches`, :func:`load` returns a stand-in whose entry points
do just that: a wrapper called on CUDA tensors there computes its launches
and launches nothing.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator

CSRC = Path(__file__).resolve().parent / "csrc"

#: ``build/repro_torch`` at the repository root (``src/`` is its sibling);
#: ``REPRO_TORCH_BUILD_DIR`` moves it, e.g. for an installed package.
_DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"

NVCC_FLAGS: tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)

#: C interface of the library: function -> argument types. Every function
#: returns the ``cudaError_t`` of its launch as an int (0 = launched). A
#: pointer or a stream passed without its ``c_void_p`` entry here would be
#: cut to 32 bits by ctypes. Every entry point ends with the dtype code of
#: its operands (``repro_torch.kernels.dtype_code``: 0 fp32, 1 bf16; which
#: operands it names is said in each source) and the stream.
SIGNATURES: dict[str, tuple] = {
    # x, s, u, mask, u0, s0, u_last, s_last (the last four nullable), M, D,
    # T, 2 input strides (t, m), 2 output strides (t, m), alpha, th_fire,
    # th_lo, th_hi, arm (1 flat, 2 ring), dtype, stream
    "e2a_lif_soma_fwd": (_P,) * 8 + (_L, _I, _I) + (_L,) * 4 + (_F,) * 4 +
                        (_I, _I, _P),
    # g, u, s, mask, gu_last (nullable), dx, M, D, T, 2 input strides,
    # 2 output strides, alpha, grad_scale, arm, dtype, stream
    "e2a_lif_soma_bwd": (_P,) * 6 + (_L, _I, _I) + (_L,) * 4 + (_F, _F, _I,
                                                               _I, _P),
    # packed, w, out, G1, G2, M, C, K, 4 packed strides (g1, g2, m, byte),
    # 4 w strides (g1, g2, c, k), 4 out strides (g1, g2, m, k), tile (1
    # Large, 2 Small), dtype, stream
    "e2a_spike_matmul": (_P, _P, _P, _I, _I, _I, _I, _I) + (_L,) * 12 +
                        (_I, _I, _P),
    # x, gamma, beta, y, mu, sqrt_d, part, arrival counters, M, D,
    # rows per chunk, eps, dtype, stream
    "e2a_bn_fwd": (_P,) * 8 + (_L, _I, _L, _F, _I, _P),
    # the split path: x, part, arrival counters, sums, M, D, rows per chunk,
    # dtype, stream; then x, gamma, beta, sums, y, mu, sqrt_d, M, D, eps,
    # dtype, stream
    "e2a_bn_fwd_sums": (_P,) * 4 + (_L, _I, _L, _I, _P),
    "e2a_bn_fwd_apply": (_P,) * 7 + (_L, _I, _F, _I, _P),
    # g, x, gamma, mu, sqrt_d, dx, dgamma, dbeta, part, cols, arrival
    # counters, M, D, rows per chunk, dtype, stream
    "e2a_bn_bwd": (_P,) * 11 + (_L, _I, _L, _I, _P),
    # the split path: g, x, gamma, mu, sqrt_d, dgamma, dbeta, part, sums,
    # arrival counters, M, D, rows per chunk, dtype, stream; then g, x,
    # gamma, mu, sqrt_d, sums, cols, dx, M, D, dtype, stream
    "e2a_bn_bwd_sums": (_P,) * 10 + (_L, _I, _L, _I, _P),
    "e2a_bn_bwd_apply": (_P,) * 8 + (_L, _I, _I, _P),
    # x, w, bias, s, T, M, C, K, packed, tile (0 by rule, 1 Large, 2 Small),
    # alpha, th_fire, dtype, stream
    "e2a_neuron_layer_eval": (_P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _F, _F,
                              _I, _P),
    # x, w, gamma, beta, z, part, mu, var, sqrt_d, s, T, M, C, K, packed,
    # kernel (the first pass's, neuron_layer.z_kernel), alpha, th_fire, eps,
    # dtype, stream
    "e2a_neuron_layer_train": (_P,) * 10 + (_I, _L, _I, _I, _I, _I, _F, _F,
                                            _F, _I, _P),
    # the split path: x, w, z, part, sums, T, M, C, K, packed, kernel,
    # dtype, stream; then z, gamma, beta, sums, mu, var, sqrt_d, s, T, M, K,
    # alpha, th_fire, eps, dtype, stream
    "e2a_neuron_layer_train_sums": (_P,) * 5 + (_I, _L, _I, _I, _I, _I, _I,
                                                _P),
    "e2a_neuron_layer_train_apply": (_P,) * 8 + (_I, _L, _I, _F, _F, _F,
                                                 _I, _P),
    # x, w, z, T, M, C, K, packed, kernel, dtype, stream
    "e2a_neuron_layer_train_z": (_P, _P, _P, _I, _L, _I, _I, _I, _I, _I,
                                 _P),
    # x, out, 3 leading dims (d2 innermost), C, their 3 element strides and
    # C's, path (1 vector, 2 scalar), dtype (of x), stream
    "e2a_spike_pack": (_P, _P, _L, _L, _L, _I) + (_L,) * 4 + (_I, _I, _P),
}

#: Fields of one launch record and the most records of one entry point
#: (``kPlanFields``, ``kMaxLaunches`` in ``csrc/launch_plan.cuh``).
PLAN_FIELDS, MAX_LAUNCHES = 18, 4

# The plan twins: an entry point's arguments without the stream, then the
# int64 record array and its capacity in records; each returns the number
# of launches, or minus the cudaError_t the entry point would return.
SIGNATURES.update({f"{name}_plan": argtypes[:-1] + (_P, _I)
                   for name, argtypes in list(SIGNATURES.items())})

#: Libraries compiled by :func:`build` in this process
#: (``repro_torch.analysis.tracing.build_counter`` reads it).
compiles = 0

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR", _DEFAULT_BUILD_DIR))


def find_nvcc(required: bool = True) -> str | None:
    """Path of ``nvcc``: the ``PATH`` first, then ``$CUDA_HOME/bin`` and
    ``/usr/local/cuda/bin``. Raises when ``required`` and there is none."""
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(str(Path(root) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file() and os.access(c, os.X_OK):
            return c
    if required:
        raise RuntimeError(
            "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
            "/usr/local/cuda/bin): the CUDA kernels of repro_torch are "
            "compiled from source at first use and need the CUDA toolkit")
    return None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _finish(proc: subprocess.Popen, what: str) -> str:
    """Wait for ``proc``; its output, or a RuntimeError carrying it."""
    out = proc.communicate()[0].decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed (exit {proc.returncode}):\n{out}")
    return out


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into one shared library and return its path
    (at once when a library of the current sources is already there).
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's output
    (registers, shared memory and spills of each kernel)."""
    out_dir = build_dir()
    lib_path = out_dir / f"libe2a_kernels_{_digest()}.so"
    if lib_path.exists() and not verbose:
        return lib_path
    nvcc = find_nvcc()
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}_{threading.get_ident()}"
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if verbose else [])
    objs = [out_dir / f"{src.stem}_{tag}.o" for src in srcs]
    tmp = out_dir / f"{lib_path.stem}_{tag}.so"
    procs = [subprocess.Popen(            # one nvcc per source, together
        [nvcc, *flags, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for src, obj in zip(srcs, objs)]
    try:
        log = [_finish(proc, f"nvcc on {src.name}")
               for src, proc in zip(srcs, procs)]
        _finish(subprocess.Popen(
            [nvcc, "-shared", "-o", str(tmp)] + [str(o) for o in objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), "nvcc link")
    finally:
        for proc in procs:                 # a failed build leaves none running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    os.replace(tmp, lib_path)              # atomic: readers see all or none
    for o in objs:
        o.unlink(missing_ok=True)
    global compiles
    compiles += 1
    if verbose:
        print("\n".join(log))
    return lib_path


def load(verbose: bool = False):
    """The kernels' shared library, built on first use, with the argument
    types of :data:`SIGNATURES` set on its functions; inside
    :func:`plan_launches`, the stand-in that reports launches instead."""
    global _lib
    with _lock:
        if _lib is None or verbose:
            lib = ctypes.CDLL(str(build(verbose)))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        lib = _lib
    sink = getattr(_planning, "calls", None)
    return lib if sink is None else _Planner(lib, sink)


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch an entry point would make (``csrc/launch_plan.cuh``):
    grid and block dims, dynamic shared memory in bytes, whether the
    launcher raises the 48 KB limit first, and per grid axis the output
    elements a block covers (``tile``, 0 where the axis does not cut the
    output), the output's extent along it and whether the blocks stride
    over it (a capped grid). ``kernel`` is the launcher's own number of the
    kernel or template instance."""

    grid: tuple[int, int, int]
    block: tuple[int, int, int]
    smem: int
    opt_in: bool
    tile: tuple[int, int, int]
    extent: tuple[int, int, int]
    strided: tuple[bool, bool, bool]
    kernel: int

    @classmethod
    def from_record(cls, r) -> "Launch":
        return cls(grid=tuple(r[0:3]), block=tuple(r[3:6]), smem=r[6],
                   opt_in=bool(r[7]), tile=tuple(r[8:11]),
                   extent=tuple(r[11:14]),
                   strided=tuple(bool(v) for v in r[14:17]), kernel=r[17])


@dataclasses.dataclass(frozen=True)
class PlannedCall:
    """One call of an entry point inside :func:`plan_launches`."""

    entry: str
    launches: tuple[Launch, ...]


class _Planner:
    """Stands in for the library inside :func:`plan_launches`: its
    ``e2a_<name>(*args)`` reads ``e2a_<name>_plan`` on the same arguments
    (the stream left out), records the launches and returns 0 without
    launching. An entry point that would refuse the call raises."""

    def __init__(self, lib: ctypes.CDLL, sink: list):
        self._lib, self._sink = lib, sink

    def __getattr__(self, name: str):
        plan = getattr(self._lib, f"{name}_plan")

        def call(*args):
            buf = (ctypes.c_longlong * (MAX_LAUNCHES * PLAN_FIELDS))()
            n = plan(*args[:-1], buf, MAX_LAUNCHES)
            if n < 0:
                raise RuntimeError(f"{name}: the entry point refuses the "
                                   f"call (CUDA error {-n})")
            self._sink.append(PlannedCall(name, tuple(
                Launch.from_record(buf[i * PLAN_FIELDS:(i + 1) * PLAN_FIELDS])
                for i in range(n))))
            return 0

        return call


_planning = threading.local()


@contextlib.contextmanager
def plan_launches() -> Iterator[list[PlannedCall]]:
    """In this thread, inside the block, :func:`load` returns the stand-in
    that reports launches: yields the list of :class:`PlannedCall` the
    block's entry-point calls append to. Builds the library if need be;
    launches nothing. The wrappers count their calls inside the block as
    launches; the block ends with every count as it began, since none was
    made (so do not plan while another thread launches)."""
    from repro_torch.kernels import launch_counts, set_launch_counts

    load()
    calls: list[PlannedCall] = []
    counts = launch_counts()
    _planning.calls = calls
    try:
        yield calls
    finally:
        _planning.calls = None
        set_launch_counts(counts)


def check_launch(code: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``: a
    refused launch never runs and a later synchronize does not report it."""
    if code != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{code}")
