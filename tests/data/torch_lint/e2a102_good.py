"""Golden GOOD snippet for E2A102: entry points and their plan twins that
build.SIGNATURES declares."""
from repro_torch.kernels import build


def launch(g, u, s, mask, dx, stream):
    lib = build.load()
    return lib.e2a_lif_soma_bwd(g, u, s, mask, None, dx, 1, 8, 4, 8, 8, 8,
                                8, 0.5, 1.0, 1, stream)


def plan(packed, w, out, buf):
    return build.load().e2a_spike_matmul_plan(packed, w, out, 1, 1, 8, 8, 8,
                                              *([1] * 12), 1, buf, 4)
