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

from repro.configs import registry as jreg
from repro.core.lif import LIFConfig as JLIFConfig
from repro.core.policy import named_policy as jax_named_policy
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro_torch.configs import registry as treg
from repro_torch.convert import from_jax, lm_from_jax
from repro_torch.core.lif import LIFConfig
from repro_torch.core.policy import IMPL_FROM_JAX, POLICY_FROM_JAX, \
    named_policy
from repro_torch.core.spikingformer import tree_leaves, value_and_grad
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp
from repro_torch.train.data import DataConfig, SyntheticLM

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


# ---------------------------------------------------------------------------
# The LM zoo
# ---------------------------------------------------------------------------

def lm_cfgs(name: str, jax_policy: str | None):
    """(reference, port) reduced configs; ``jax_policy`` None = no LIF,
    else the LIF under that policy and its port twin."""
    jcfg, tcfg = jreg.reduced(jreg.get_config(name)), \
        treg.reduced(treg.get_config(name))
    if jax_policy is not None:
        jcfg = jcfg.replace(lif=JLIFConfig(
            policy=jax_named_policy(jax_policy)))
        tcfg = tcfg.replace(lif=LIFConfig(
            policy=named_policy(POLICY_FROM_JAX[jax_policy])))
    return jcfg, tcfg


def lm_params(jcfg, seed: int = 0):
    """The reference's ``init_lm`` parameters and their port conversion."""
    jparams = jcommon.split_tree(jlm.init_lm(jax.random.PRNGKey(seed),
                                             jcfg))[0]
    return jparams, lm_from_jax(np_tree(jparams), device="cpu")


def jax_branch_spikes(params, toks, cfg):
    """The reference's ``_dense_block``, taken apart to keep each layer's
    branch spikes (the reference's ``lm_forward`` returns none)."""
    x = jcommon.embed(params["embed"], toks, cfg.dtype)
    spikes = []
    for i in range(cfg.num_layers):
        p = jax.tree.map(lambda a: a[i], params["blocks"])
        x = x + jattn.attention(p["attn"],
                                jcommon.rmsnorm(p["ln1"], x, cfg.norm_eps),
                                cfg.attn)
        f = jlm._seq_lif(jmlp.swiglu(
            p["ffn"], jcommon.rmsnorm(p["ln2"], x, cfg.norm_eps)), cfg)
        spikes.append(np.asarray(f))
        x = x + f
    return spikes


def torch_branch_spikes(params, toks, cfg):
    """The port's ``_dense_block`` taken apart the same way."""
    with torch.no_grad():
        x = tcommon.embed(params["embed"], toks, cfg.dtype)
        spikes = []
        for i in range(cfg.num_layers):
            p = tcommon.layer(params["blocks"], i)
            x = x + tattn.attention(p["attn"], tcommon.rmsnorm(
                p["ln1"], x, cfg.norm_eps), cfg.attn)
            f = tlm._seq_lif(tmlp.swiglu(
                p["ffn"], tcommon.rmsnorm(p["ln2"], x, cfg.norm_eps)), cfg)
            spikes.append(f.numpy())
            x = x + f
    return spikes


def lm_batch(step: int = 0, batch: int = 4, seq: int = 16, vocab: int = 512):
    """Batch ``step`` of the ``SyntheticLM`` stream (numpy, seed 0)."""
    return SyntheticLM(DataConfig(vocab_size=vocab, seq_len=seq,
                                  global_batch=batch, seed=0)).batch(step)


def as_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def close_scaled(got, want, atol: float = 1e-5):
    """max|got - want| <= atol * max(1, max|want|): absolute on O(1)
    values, relative above."""
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got), want, atol=atol * scale,
                               rtol=0)


def trees_close(got, want, atol: float = 1e-5):
    """A port tree against a reference pytree, leaf by leaf in the
    reference's order: shapes equal, values as :func:`close_scaled`."""
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        close_scaled(a.numpy(), b, atol)


# ---------------------------------------------------------------------------
# The LM's loss and gradient
# ---------------------------------------------------------------------------

def _lm_spike_mismatch(jp, tp, toks, jcfg, tcfg) -> float:
    """Branch spikes differing between the packages, averaged over the
    layers (0 without the LIF)."""
    if jcfg.lif is None:
        return 0.0
    per_layer = [mismatch_fraction(t, j) for t, j in zip(
        torch_branch_spikes(tp, torch.from_numpy(toks), tcfg),
        jax_branch_spikes(jp, jnp.asarray(toks), jcfg))]
    assert len(per_layer) == jcfg.num_layers
    return float(np.mean(per_layer))


def _lm_grads_close(got, want, mismatch: float):
    """Every leaf at 1e-5 scale-aware where no spike differs; else at
    max(2 sqrt(f), 1e-4) relative L2."""
    if mismatch == 0.0:
        trees_close(got, want)
        return
    limit = max(2 * mismatch ** 0.5, 1e-4)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        rel = np.linalg.norm(a.numpy() - b) / max(np.linalg.norm(b), 1e-30)
        assert rel <= limit, (rel, limit, mismatch)


def lm_loss_and_grads_match(jcfg, tcfg, batch):
    """``lm_loss`` and its gradient in both packages on one numpy batch,
    from the reference's ``init_lm``: the loss and the three metrics at
    1e-5 scale-aware, every gradient leaf as :func:`_lm_grads_close`."""
    jp, tp = lm_params(jcfg)
    (jl, jm), jg = jax.value_and_grad(jlm.lm_loss, has_aux=True)(
        jp, as_jax(batch), jcfg)
    (tl, tm), tg = value_and_grad(tlm.lm_loss, tp, as_torch(batch), tcfg)
    close_scaled(tl, jl)
    assert sorted(tm) == sorted(jm) == ["aux_loss", "logits_mean_abs",
                                        "loss"]
    for k in jm:
        close_scaled(tm[k], jm[k])
    _lm_grads_close(tg, jg, _lm_spike_mismatch(jp, tp, batch["tokens"],
                                               jcfg, tcfg))
