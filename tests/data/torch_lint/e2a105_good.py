"""Golden GOOD snippet for E2A105: the plain version is taken for a CPU
tensor, decided by the device; a failed launch raises."""
from repro_torch.kernels import build


def lif_fwd_plain(x):
    return x


def lif_fwd(x):
    if not x.is_cuda:
        return lif_fwd_plain(x)
    try:
        code = build.load().e2a_lif_soma_fwd(x.data_ptr())
    except OSError as e:
        raise RuntimeError("the kernel library did not load") from e
    build.check_launch(code, "lif_soma_fwd")
    return x
