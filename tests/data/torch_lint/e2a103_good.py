"""Golden GOOD snippet for E2A103: the library is loaded inside the
function that launches, or under the script's entry."""
from repro_torch.kernels import build


def launch(x, stream):
    return build.load().e2a_lif_soma_fwd  # noqa: B018 - loaded at first use


class Launcher:
    def lib(self):
        return build.load()


if __name__ == "__main__":
    build.load(verbose=True)
