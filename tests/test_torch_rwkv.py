"""The port's RWKV-6 layers (``repro_torch.models.rwkv``) and the rwkv
family of the LM (``reduced(rwkv6-7b)``: 4 layers, d 64, 4 heads of 16,
chunk 8) against the JAX package, both on the CPU: the layers, the tree,
decode, the cache, the engine and the driver. The LM's forward and its
loss and gradients are in ``test_torch_rwkv_lm.py``.

The same numpy inputs and the reference's own parameters (converted by
``lm_from_jax``) go through both packages, with the leaves that the init
leaves trivial drawn in numpy first (``_torch_port.randomize_recurrent``:
the token-shift mixes, the bonus, the decay bias), and the spread asserted
(``test_the_randomised_leaves_are_in_effect``). fp32, tolerance 1e-5
scale-aware (max|a - b| <= 1e-5 * max(1, max|b|)). Sequences of 16 (two
chunks) and 13 (not a multiple of the chunk: one chunk, the reference's
fallback).
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _serving_parity import assert_greedy_parity
from _torch_port import (RECURRENT_TOKENS, close_scaled,
                         converted_leaves_match, decode_equals_forward,
                         decode_matches, engine_tokens_match,
                         init_tree_matches, lm_cfgs, np_tree,
                         randomize_recurrent, recurrent_params,
                         reset_equals_init, single_thread, trees_close)

from repro.configs import registry as jreg
from repro.launch import train as jtrain
from repro.models import common as jcommon
from repro.models import rwkv as jrwkv
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_from_jax
from repro_torch.core.spikingformer import tree_leaves
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import rwkv as trwkv

single_thread()
KEY = jax.random.PRNGKey(0)
ARCH = "rwkv6-7b"
SEQS = sorted(RECURRENT_TOKENS)


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer(init, seed=0):
    """(reference config, port config, numpy params of the reference's
    ``init`` with the trivial leaves drawn, port params)."""
    jcfg = jreg.reduced(jreg.get_config(ARCH)).rwkv
    tcfg = treg.reduced(treg.get_config(ARCH)).rwkv
    jp = randomize_recurrent(np_tree(jcommon.split_tree(init(KEY, jcfg))[0]),
                             np.random.default_rng(seed))
    return jcfg, tcfg, jp, lm_from_jax(jp, device="cpu")


def _x(s, seed=1, b=2, d=64):
    return np.random.default_rng(seed).normal(0, 1, (b, s, d)).astype(
        np.float32)


def test_the_randomised_leaves_are_in_effect():
    """At layer 0 of ``recurrent_params``: the mixes span [0, 1] (the
    token shift and the carry show), the bonus is far from 0, and a chunk
    of 8 decays some channels to under 1e-2 and keeps others above 1/2
    (at init every channel keeps 0.95)."""
    jcfg, tcfg = lm_cfgs(ARCH, None)
    _, tp = recurrent_params(jcfg)
    p = tcommon.layer(tp["blocks"], 0)
    for part in ("time", "chan"):
        mu = p[part]["mu"]
        assert float(mu.min()) < 0.05 and float(mu.max()) > 0.95
    assert float(p["time"]["u_bonus"].abs().max()) > 0.5
    with torch.no_grad():
        x = tcommon.rmsnorm(p["ln1"], tcommon.embed(
            tp["embed"], _t(RECURRENT_TOKENS[16])), tcfg.norm_eps)
        lw = trwkv._rkvwg(p["time"], x, trwkv._token_shift(x), tcfg.rwkv)[3]
        chunk_decay = torch.exp(lw.reshape(2, 2, 8, -1).sum(2))
        assert float(chunk_decay.min()) < 1e-2
        assert float(chunk_decay.max()) > 0.5
        # the shift moves the time mix's output
        still = {**p["time"], "mu": torch.ones_like(p["time"]["mu"])}
        moved = trwkv.rwkv_time_mix(p["time"], x, tcfg.rwkv)
        assert float((moved - trwkv.rwkv_time_mix(still, x, tcfg.rwkv))
                     .abs().max()) > 1e-2 * float(moved.abs().max())


# ---------------------------------------------------------------------------
# The layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", SEQS)
def test_rwkv_time_mix_matches_reference(seq):
    jcfg, tcfg, jp, tp = _layer(jrwkv.init_rwkv_time_mix)
    x = _x(seq)
    want = jrwkv.rwkv_time_mix(jp, jnp.asarray(x), jcfg)
    close_scaled(trwkv.rwkv_time_mix(tp, _t(x), tcfg).numpy(), want)


def test_rwkv_time_mix_decode_matches_reference_token_by_token():
    """Thirteen recurrent steps from ``init_rwkv_state``: the output, the
    WKV state and the shift carry at each, and the outputs equal to the
    chunked forward's."""
    jcfg, tcfg, jp, tp = _layer(jrwkv.init_rwkv_time_mix)
    x = _x(13)
    js, ts = jrwkv.init_rwkv_state(2, jcfg), trwkv.init_rwkv_state(2, tcfg)
    trees_close(ts, js)
    outs = []
    for t in range(13):
        jy, js = jrwkv.rwkv_time_mix_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                            js, jcfg)
        ty, ts = trwkv.rwkv_time_mix_decode(tp, _t(x[:, t:t + 1]), ts, tcfg)
        close_scaled(ty.numpy(), jy)
        trees_close(ts, js)
        outs.append(ty)
    close_scaled(torch.cat(outs, 1).numpy(),
                 trwkv.rwkv_time_mix(tp, _t(x), tcfg).numpy())


@pytest.mark.parametrize("carry", [False, True])
def test_rwkv_channel_mix_matches_reference(carry):
    jcfg, tcfg, jp, tp = _layer(jrwkv.init_rwkv_channel_mix)
    x = _x(13)
    prev = _x(1, seed=2) if carry else None
    want = jrwkv.rwkv_channel_mix(jp, jnp.asarray(x), jcfg,
                                  x_prev=None if prev is None
                                  else jnp.asarray(prev))
    got = trwkv.rwkv_channel_mix(tp, _t(x), tcfg,
                                 x_prev=None if prev is None else _t(prev))
    close_scaled(got.numpy(), want)


# ---------------------------------------------------------------------------
# The LM: reduced rwkv6-7b
# ---------------------------------------------------------------------------

def test_init_lm_tree_has_the_reference_keys_shapes_and_specs():
    init_tree_matches(ARCH)


def test_lm_from_jax_carries_the_rwkv_leaves():
    keys = converted_leaves_match(ARCH)
    assert {"blocks/time/u_bonus", "blocks/time/decay_bias",
            "blocks/time/ln_x/bias", "blocks/chan/mu"} <= keys


@pytest.mark.parametrize("jax_policy", [None, "jnp", "pallas"])
def test_lm_decode_step_matches_reference(jax_policy):
    """Thirteen steps, two rows at different positions: logits and every
    cache leaf (the WKV state, both shift carries, the LIF's U and S)."""
    decode_matches(ARCH, jax_policy, 13, recurrent_params,
                   RECURRENT_TOKENS[16])


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("policy", ["eager", "cuda"])
def test_spiking_decode_matches_forward(policy, seq):
    """The reference's own check (``test_serving_continuous.py:105-118``)
    at its 1e-5, on both rows of the randomised model."""
    decode_equals_forward(ARCH, policy, 1e-5, recurrent_params,
                          RECURRENT_TOKENS[seq])


@pytest.mark.parametrize("spiking", [False, True])
def test_reset_cache_slots_matches_init(spiking):
    reset_equals_init(ARCH, spiking)


@pytest.mark.parametrize("spiking", [False, True])
def test_engine_tokens_equal_the_reference_engine(spiking):
    """The tokens equal the reference engine's, and each request's are a
    greedy trajectory of the reference's own solo decode
    (``_serving_parity``'s teacher-forced oracle)."""
    jp, jcfg, done = engine_tokens_match(ARCH, spiking, recurrent_params)
    for req in done:
        assert_greedy_parity(jp, jcfg, req)


def test_rwkv_cache_is_stacked_by_slot_and_reads_no_max_seq():
    cfg = treg.reduced(treg.get_config(ARCH))
    cache = tlm.init_cache(cfg, 3, 16, torch.float32, "cpu")
    assert tuple(cache["time"]["s"].shape) == (4, 3, 4, 16, 16)
    assert tuple(cache["time"]["x_prev"].shape) == (4, 3, 1, 64)
    assert tuple(cache["chan"].shape) == (4, 3, 1, 64)
    longer = tlm.init_cache(cfg, 3, 4096, torch.float32, "cpu")
    assert [a.shape for a in tree_leaves(longer)] == \
        [a.shape for a in tree_leaves(cache)]


def test_the_driver_resolves_and_trains_the_reduced_family(capsys):
    """``--arch rwkv6-7b --reduced`` resolves as the reference's
    ``_resolve_config`` does, and two steps train on the CPU."""
    args = argparse.Namespace(arch=ARCH, reduced=True, data_vocab=None,
                              seq=None, policy=None, time_chunk=None)
    cfg = ttrain._resolve_config(args)
    assert cfg == treg.reduced(treg.get_config(ARCH))
    assert cfg.name == jtrain._resolve_config(args).name
    ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                 "2", "--batch", "2", "--seq", "16"])
    assert "final loss" in capsys.readouterr().out
