"""Golden BAD snippet for E2A105: a kernel launch whose failure is hidden
behind its plain version."""
import torch

from repro_torch.kernels import build


def lif_fwd_plain(x):
    return x


def lif_fwd(x):
    try:
        return _launch_fwd(x)
    except RuntimeError:
        return lif_fwd_plain(x)        # BAD: the kernel's fault disappears


def bn(x):
    try:
        code = build.load().e2a_bn_fwd(x.data_ptr())
        build.check_launch(code, "bn_fwd")
    except Exception:
        x = torch.nn.functional.batch_norm_plain(x)   # BAD
    return x


def _launch_fwd(x):
    return x
