"""Golden GOOD snippet for E2A101: the port imports its own package and
torch; names that merely start alike are not the reference."""
import importlib

import torch

import repro_torch.analysis.report
from repro_torch.kernels import ref


def oracle(x):
    lint = importlib.import_module("repro_torch.analysis.lint")
    return ref.bn_fwd_ref(torch.as_tensor(x)), lint, repro_torch.analysis
