"""Golden BAD snippet for E2A103: the kernels built when the module is
imported."""
from repro_torch.kernels import build
from repro_torch.kernels.build import load as load_kernels

LIB = build.load()                     # BAD: nvcc runs at import


class Launcher:
    lib = load_kernels()               # BAD: a class body runs at import
