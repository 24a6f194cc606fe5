"""Shared helpers of the ``test_torch_*`` files: the same numpy-made inputs
and parameters go through the JAX package and through ``repro_torch``.

Both frameworks run on the CPU here. The JAX side runs as its own tests run
it: Pallas kernels in interpret mode (``interpret=None`` resolves to that
off a TPU), or the ``repro.kernels.ref`` oracles.
"""
from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.policy import named_policy as jax_named_policy
from repro_torch.convert import from_jax
from repro_torch.core.policy import IMPL_FROM_JAX, POLICY_FROM_JAX, \
    named_policy

#: (JAX policy name, port policy name) pairs the parity tests sweep.
POLICY_PAIRS = tuple(POLICY_FROM_JAX.items())


def single_thread():
    """Six test workers share the machine: keep torch to one thread."""
    torch.set_num_threads(1)


def np_tree(tree):
    """A JAX pytree as nested dicts/lists of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, tree)


def to_torch(tree):
    params, _ = from_jax(tree, {}, device="cpu")
    return params


def randomize_bn(params, state, rng: np.random.Generator):
    """Non-trivial BN everywhere, in place on numpy trees: gamma != 1,
    beta != 0, running mean != 0, running var != 1."""
    def walk(tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if isinstance(v, (dict, list)):
                    walk(v)
                elif k == "gamma":
                    tree[k] = rng.uniform(0.7, 1.3, v.shape).astype(v.dtype)
                elif k == "beta":
                    tree[k] = rng.normal(0, 0.3, v.shape).astype(v.dtype)
                elif k == "mean":
                    tree[k] = rng.normal(0, 0.2, v.shape).astype(v.dtype)
                elif k == "var":
                    tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
        elif isinstance(tree, list):
            for v in tree:
                walk(v)
    walk(params)
    walk(state)
    return params, state


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def both_policies(jax_name: str):
    return jax_named_policy(jax_name), named_policy(POLICY_FROM_JAX[jax_name])


def translate_impl(name: str) -> str:
    return IMPL_FROM_JAX[name]


_IMPL_RE = re.compile("|".join(
    re.escape(k) for k in sorted(IMPL_FROM_JAX, key=len, reverse=True)))


def translate_note(note: str) -> str:
    """A plan row's note with the reference's impl names ("-> pallas") and
    "jnp einsum"-style mentions replaced by the port's."""
    return _IMPL_RE.sub(lambda m: IMPL_FROM_JAX[m.group(0)], note)


def mismatch_fraction(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.mean(a != b))
