"""Golden BAD snippet for E2A102: library entry points called with no
argument types in build.SIGNATURES (ctypes would cut every pointer to 32
bits)."""
from repro_torch.kernels import build


def launch(x, out, stream):
    build.load().e2a_undeclared_kernel(x.data_ptr(), out.data_ptr(),
                                       x.numel(), stream)        # BAD


def launch_via_name(x, stream):
    lib = build.load()
    return lib.e2a_another_one(x.data_ptr(), stream)             # BAD
