"""Golden BAD snippet for E2A101: the port's code importing JAX and the
reference package (the card's machine has neither)."""
import importlib

import jax.numpy as jnp                       # BAD
from repro.kernels import ref                 # BAD

import repro.analysis.report                  # BAD


def oracle(x):
    lint = importlib.import_module("repro.analysis.lint")   # BAD
    return ref.bn_fwd_ref(jnp.asarray(x)), lint, repro.analysis.report
