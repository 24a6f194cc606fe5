"""Feed-forward layers (the counterpart of ``repro.models.mlp``): SwiGLU
(llama/qwen/mixtral family) and GELU (whisper). Dense products, as the
reference's einsums. On a model axis SwiGLU is Megatron's: ``w_gate`` and
``w_up`` column-parallel (the rank's d_ff/M hidden features), ``w_down``
row-parallel, its partial sums added over the group; the caller enters the
region (``copy_to_model``). The GELU MLP (whisper) likewise: ``w_in`` /
``b_in`` column-parallel, ``w_out`` row-parallel and summed, and the
replicated ``b_out`` added once, after the sum."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (MODEL, normal_leaf, reduce_from_model,
                                       zeros_leaf)


def init_swiglu(generator, d_model: int, d_ff: int, dtype=torch.float32,
                device="cpu"):
    return {
        "w_gate": normal_leaf(generator, (d_model, d_ff), (None, MODEL),
                              dtype=dtype, device=device),
        "w_up": normal_leaf(generator, (d_model, d_ff), (None, MODEL),
                            dtype=dtype, device=device),
        "w_down": normal_leaf(generator, (d_ff, d_model), (MODEL, None),
                              scale=d_ff ** -0.5, dtype=dtype, device=device),
    }


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, params["w_gate"].to(x.dtype))
    u = torch.matmul(x, params["w_up"].to(x.dtype))
    return reduce_from_model(
        torch.matmul(F.silu(g) * u, params["w_down"].to(x.dtype)))


def init_gelu_mlp(generator, d_model: int, d_ff: int, dtype=torch.float32,
                  device="cpu"):
    return {
        "w_in": normal_leaf(generator, (d_model, d_ff), (None, MODEL),
                            dtype=dtype, device=device),
        "b_in": zeros_leaf((d_ff,), (MODEL,), dtype, device),
        "w_out": normal_leaf(generator, (d_ff, d_model), (MODEL, None),
                             scale=d_ff ** -0.5, dtype=dtype, device=device),
        "b_out": zeros_leaf((d_model,), (None,), dtype, device),
    }


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation: so is this.
    On a model axis the caller enters the region (``copy_to_model``)."""
    h = torch.matmul(x, params["w_in"].to(x.dtype)) + params["b_in"].to(x.dtype)
    h = F.gelu(h, approximate="tanh")
    return reduce_from_model(torch.matmul(h, params["w_out"].to(x.dtype))) \
        + params["b_out"].to(x.dtype)
