"""Reference (JAX) parameters -> the port's parameter dicts.

The port keeps the reference pytree's keys and layouts (HWIO conv weights,
(C_in, C_out) linear weights, block leaves stacked on a leading L axis), so
the conversion is leaf by leaf: same keys, same shapes, dtype kept. The
caller hands the pytrees over as numpy arrays (``jax.device_get`` or
``jax.tree_util.tree_map(np.asarray, tree)``); this module imports neither
JAX nor the reference package.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.backend import resolve_device


def _convert(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    # np.array copies: the tensor never aliases a buffer the caller (or an
    # asynchronous runtime behind it) still owns.
    return torch.from_numpy(np.array(tree)).to(device)


def from_jax(params: Any, state: Any,
             device: str | torch.device | None = None):
    """(params, state) pytrees of numpy arrays -> the port's nested dicts
    of tensors on ``device`` (``None`` = the card, raising without one)."""
    device = resolve_device(device)
    return _convert(params, device), _convert(state, device)
