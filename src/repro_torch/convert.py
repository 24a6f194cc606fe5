"""Reference (JAX) parameters and optimizer state -> the port's dicts
(the Spikingformer's, the LM's and the encoder-decoder's).

The port keeps the reference pytree's keys and layouts (HWIO conv weights,
(C_in, C_out) linear weights, block leaves stacked on a leading L axis), so
the conversion is leaf by leaf: same keys, same shapes, dtype kept. A
bfloat16 leaf (numpy holds it as ``ml_dtypes.bfloat16``, which torch cannot
take) becomes a ``torch.bfloat16`` tensor bit for bit, through the int16
view the checkpoints use (``train.checkpoint.bf16_tensor``). The
caller hands the pytrees over as numpy arrays (``jax.device_get`` or
``jax.tree_util.tree_map(np.asarray, tree)``); this module imports neither
JAX nor the reference package. The optimizer state converts too, so that
a training step in each package can start from the same state.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.backend import resolve_device
from repro_torch.train.checkpoint import bf16_tensor


def _convert(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    # np.array copies: the tensor never aliases a buffer the caller (or an
    # asynchronous runtime behind it) still owns.
    arr = np.array(tree)
    if arr.dtype.name == "bfloat16":
        return bf16_tensor(arr).to(device)
    return torch.from_numpy(arr).to(device)


def from_jax(params: Any, state: Any,
             device: str | torch.device | None = None):
    """(params, state) pytrees of numpy arrays -> the port's nested dicts
    of tensors on ``device`` (``None`` = the card, raising without one)."""
    device = resolve_device(device)
    return _convert(params, device), _convert(state, device)


def lm_from_jax(params: Any, device: str | torch.device | None = None):
    """The reference's LM parameters (``init_lm`` after ``split_tree``,
    numpy leaves) -> the port's tree on ``device`` (``None`` = the card,
    raising without one): the same keys, shapes and dtypes, the block
    leaves stacked on their leading ``(L, ...)`` axis. The reference's
    encoder-decoder tree (``init_encdec``: ``embed``, ``enc_blocks``,
    ``dec_blocks``, ``ln_enc``, ``ln_dec``) converts the same way, leaf
    by leaf."""
    return _convert(params, resolve_device(device))


def opt_state_from_jax(opt_state: Any,
                       device: str | torch.device | None = None):
    """The reference's AdamW state (``{"m", "v", "step", "err"}``, numpy
    leaves) -> the port's ``{"m", "v", "step"}`` on ``device``. ``err``
    (the int8 gradient-compression residual) is not converted and must be
    ``None``."""
    if opt_state.get("err") is not None:
        raise ValueError("opt_state_from_jax: the int8 compression residual "
                         "'err' is not converted; convert a state without it")
    device = resolve_device(device)
    return {"m": _convert(opt_state["m"], device),
            "v": _convert(opt_state["v"], device),
            "step": torch.tensor(int(np.asarray(opt_state["step"])),
                                 dtype=torch.int32, device=device)}
