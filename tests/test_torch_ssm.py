"""The port's Mamba2 (SSD) mixer (``repro_torch.models.ssm``) and the
hybrid family's tree, cache and checkpoint (``reduced(zamba2-2.7b)``: 4
Mamba2 layers in 2 groups, each group followed by the one weight-shared
attention + SwiGLU block; d 64, d_inner 128, 8 SSD heads of 16, d_state
16, chunk 8) against the JAX package, both on the CPU, with decode and
the engine. The LM's forward and its loss and gradients are in
``test_torch_ssm_lm.py``.

The same numpy inputs and the reference's own parameters (converted by
``lm_from_jax``) go through both packages, with the leaves that the init
leaves trivial drawn in numpy first (``_torch_port.randomize_recurrent``:
the conv bias, ``a_log``, ``dt_bias``, the skip) and the spread asserted
(``test_the_randomised_leaves_are_in_effect``); the shared attention's
query and key projections are scaled by ``_torch_port.QK_SCALE``. fp32,
tolerance 1e-5 scale-aware (max|a - b| <= 1e-5 * max(1, max|b|)).
Sequences of 16 (two chunks) and 13 (one chunk, the reference's
fallback).

Also the reference's fault C6 (ROADMAP Queue C), on both packages: at the
published chunk of 128 the masked ``exp`` overflows in the upper triangle,
the forward stays finite and the gradient does not.
"""
import argparse
import json
import os

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
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.train import checkpoint as jck
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_from_jax
from repro_torch.core.spikingformer import tree_leaves, tree_map
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.train import checkpoint as tck

single_thread()
KEY = jax.random.PRNGKey(0)
ARCH = "zamba2-2.7b"
SEQS = sorted(RECURRENT_TOKENS)


def _t(a):
    return torch.from_numpy(np.array(a))


def _mixer(seed=0, **kw):
    """(reference config, port config, numpy params of the reference's
    ``init_ssm`` with the trivial leaves drawn, port params); ``kw``
    replaces fields of the reduced config."""
    jcfg = jreg.reduced(jreg.get_config(ARCH)).ssm
    jcfg = jssm.SSMConfig(**{**jcfg.__dict__, **kw})
    tcfg = tssm.SSMConfig(**jcfg.__dict__)
    jp = randomize_recurrent(
        np_tree(jcommon.split_tree(jssm.init_ssm(KEY, jcfg))[0]),
        np.random.default_rng(seed))
    return jcfg, tcfg, jp, lm_from_jax(jp, device="cpu")


def _x(s, seed=1, b=2, d=64):
    return np.random.default_rng(seed).normal(0, 1, (b, s, d)).astype(
        np.float32)


def test_the_randomised_leaves_are_in_effect():
    """At layer 0 of ``recurrent_params``: a chunk of 8 decays some heads
    to under 1e-2 and keeps others above 1/2 (at init all decay alike),
    the largest masked exponent of a 13-step chunk is below fp32's
    overflow at 88.7 (so no gradient below meets C6), and the conv bias
    and the skip are off their init."""
    jcfg, tcfg = lm_cfgs(ARCH, None)
    _, tp = recurrent_params(jcfg)
    p = tcommon.layer(tp["blocks"], 0)["ssm"]
    assert float(p["conv_b"].abs().max()) > 0.3
    assert float(p["d_skip"].min()) < 0.8 and float(p["d_skip"].max()) > 1.2
    with torch.no_grad():
        x = tcommon.rmsnorm(tcommon.layer(tp["blocks"], 0)["ln"],
                            tcommon.embed(tp["embed"],
                                          _t(RECURRENT_TOKENS[16])),
                            tcfg.norm_eps)
        la = tssm._decay_log(p, tssm._split_proj(p, x, tcfg.ssm)[2])[1]
        chunk_decay = torch.exp(la.reshape(2, 2, 8, -1).sum(2))
        assert float(chunk_decay.min()) < 1e-2
        assert float(chunk_decay.max()) > 0.5
        assert float(-la[:, :13].sum(1).max()) < 80.0


# ---------------------------------------------------------------------------
# The mixer
# ---------------------------------------------------------------------------

def test_causal_conv_matches_reference():
    jcfg, tcfg, jp, tp = _mixer()
    xbc = np.random.default_rng(3).normal(0, 1, (2, 13, 160)).astype(
        np.float32)
    close_scaled(tssm._causal_conv(tp, _t(xbc), tcfg).numpy(),
                 jssm._causal_conv(jp, jnp.asarray(xbc), jcfg))


@pytest.mark.parametrize("seq", SEQS)
def test_ssm_mixer_matches_reference(seq):
    jcfg, tcfg, jp, tp = _mixer()
    x = _x(seq)
    close_scaled(tssm.ssm_mixer(tp, _t(x), tcfg).numpy(),
                 jssm.ssm_mixer(jp, jnp.asarray(x), jcfg))


def test_ssm_decode_matches_reference_token_by_token():
    """Thirteen recurrent steps from ``init_ssm_state``: the output, the
    SSD state and the conv window at each, and the outputs equal to the
    chunked forward's."""
    jcfg, tcfg, jp, tp = _mixer()
    x = _x(13)
    js, ts = jssm.init_ssm_state(2, jcfg), tssm.init_ssm_state(2, tcfg)
    trees_close(ts, js)
    outs = []
    for t in range(13):
        jy, js = jssm.ssm_decode(jp, jnp.asarray(x[:, t:t + 1]), js, jcfg)
        ty, ts = tssm.ssm_decode(tp, _t(x[:, t:t + 1]), ts, tcfg)
        close_scaled(ty.numpy(), jy)
        trees_close(ts, js)
        outs.append(ty)
    close_scaled(torch.cat(outs, 1).numpy(),
                 tssm.ssm_mixer(tp, _t(x), tcfg).numpy())


def _ssm_grads(chunk, seq):
    """Forward and gradient of sum(ssm_mixer) in both packages at the
    reference's init (d_model 32, 8 heads of 8, d_state 16), one row of
    ``seq`` tokens."""
    jcfg = jssm.SSMConfig(d_model=32, d_state=16, head_dim=8, chunk=chunk)
    jp = jcommon.split_tree(jssm.init_ssm(KEY, jcfg))[0]
    tp = lm_from_jax(np_tree(jp), device="cpu")
    x = np.random.default_rng(0).normal(0, 1, (1, seq, 32)).astype(
        np.float32)
    jy = jssm.ssm_mixer(jp, jnp.asarray(x), jcfg)
    jg = jax.grad(lambda p: jssm.ssm_mixer(p, jnp.asarray(x), jcfg).sum())(
        jp)
    tp = tree_map(lambda a: a.requires_grad_(), tp)
    ty = tssm.ssm_mixer(tp, _t(x), tssm.SSMConfig(**jcfg.__dict__))
    ty.sum().backward()
    return jy, jg, ty.detach(), {k: v.grad for k, v in tp.items()}


@pytest.mark.parametrize("chunk", [128, 8])
def test_c6_published_chunk_overflows_in_both_packages(chunk):
    """C6, a fault of the reference kept by the port: at the published
    chunk of 128 the forward is finite and equal, and the gradients of
    ``a_log``, ``dt_bias`` and ``w_in`` are not finite (``exp`` of the
    masked upper triangle overflows, 0 x inf), element for element where
    the reference's are; at chunk 8 every gradient is finite and equal."""
    jy, jg, ty, tg = _ssm_grads(chunk, 128)
    assert np.isfinite(np.asarray(jy)).all()
    close_scaled(ty.numpy(), jy)
    bad = sorted(k for k, v in jg.items()
                 if not np.isfinite(np.asarray(v)).all())
    assert bad == (["a_log", "dt_bias", "w_in"] if chunk == 128 else [])
    for k, want in jg.items():
        want, got = np.asarray(want), tg[k].numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want),
                                      err_msg=k)
        if k not in bad:
            close_scaled(got, want)


# ---------------------------------------------------------------------------
# The LM: reduced zamba2-2.7b
# ---------------------------------------------------------------------------

def test_init_lm_tree_has_the_reference_keys_shapes_and_specs():
    init_tree_matches(ARCH)


def test_lm_from_jax_carries_the_hybrid_leaves():
    keys = converted_leaves_match(ARCH)
    assert {"blocks/ssm/a_log", "blocks/ssm/conv_w", "blocks/ln/scale",
            "shared/attn/wq", "shared/ffn/w_gate", "shared/ln1/scale"} <= keys


@pytest.mark.parametrize("spiking", [False, True])
def test_reset_cache_slots_matches_init(spiking):
    """Reset = init on both layouts: the Mamba2 states' slot axis is 2,
    the shared block's KV's 1."""
    reset_equals_init(ARCH, spiking)


def test_hybrid_cache_layout_is_grouped_like_the_reference():
    jcfg, tcfg = lm_cfgs(ARCH, "jnp")
    jc = jlm.init_cache(jcfg, 3, 16, jnp.float32)
    tc = tlm.init_cache(tcfg, 3, 16, torch.float32, "cpu")
    trees_close(tc, jc)
    assert tuple(tc["mamba"]["h"].shape) == (2, 2, 3, 8, 16, 16)
    assert tuple(tc["mamba"]["lif"]["u"].shape) == (2, 2, 3, 64)
    assert tuple(tc["shared"]["k"].shape)[:2] == (2, 3)
    assert tree_leaves(tlm.cache_batch_axes(tcfg, tc)) == tree_leaves(
        jlm.cache_batch_axes(jcfg, jc))
    one = tlm.cache_slot_state(tc, 1, tcfg)
    assert tuple(one["mamba"]["conv"].shape) == (2, 2, 3, 160)
    assert tuple(one["shared"]["v"].shape)[0] == 2


@pytest.mark.parametrize("jax_policy", [None, "jnp", "pallas"])
def test_lm_decode_step_matches_reference(jax_policy):
    """Thirteen steps, two rows at different positions: logits and every
    cache leaf (SSD state, conv window, LIF, the shared block's KV)."""
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
def test_engine_tokens_equal_the_reference_engine(spiking):
    """The tokens equal the reference engine's, and each request's are a
    greedy trajectory of the reference's own solo decode
    (``_serving_parity``'s teacher-forced oracle)."""
    jp, jcfg, done = engine_tokens_match(ARCH, spiking, recurrent_params)
    for req in done:
        assert_greedy_parity(jp, jcfg, req)


def test_a_checkpoint_carries_the_shared_block_bit_equal(tmp_path):
    """The hybrid's tree, ``"shared"`` included: the port writes the
    reference's index and bytes, and each package restores the other's."""
    jcfg, tcfg = lm_cfgs(ARCH, "jnp")
    jp, jspecs = jcommon.split_tree(jlm.init_lm(KEY, jcfg))
    tp = lm_from_jax(np_tree(jp), device="cpu")
    tspecs = tcommon.split_tree(
        tlm.init_lm(torch.Generator().manual_seed(0), tcfg, "cpu"))[1]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_checkpoint(jdir, 3, jp, jspecs)
    tck.save_checkpoint(tdir, 3, tp, tspecs)
    jstep, tstep = (os.path.join(d, "step_00000003") for d in (jdir, tdir))
    jindex, tindex = (json.load(open(os.path.join(d, "index.json")))
                      for d in (jstep, tstep))
    assert tindex == jindex
    assert any("shared" in k for k in json.dumps(jindex).split('"'))
    for f in sorted(os.listdir(jstep)):
        assert open(os.path.join(tstep, f), "rb").read() == \
            open(os.path.join(jstep, f), "rb").read()
    restored = tck.restore_checkpoint(jdir, 3, tp)
    for a, b in zip(tree_leaves(restored), jax.tree.leaves(jp)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


def test_the_driver_resolves_and_trains_the_reduced_family(capsys):
    """``--arch zamba2-2.7b --reduced`` resolves as the reference's
    ``_resolve_config`` does, and two steps train on the CPU."""
    args = argparse.Namespace(arch=ARCH, reduced=True, data_vocab=None,
                              seq=None, policy=None, time_chunk=None)
    cfg = ttrain._resolve_config(args)
    assert cfg == treg.reduced(treg.get_config(ARCH))
    assert cfg.name == jtrain._resolve_config(args).name
    ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                 "2", "--batch", "2", "--seq", "16"])
    assert "final loss" in capsys.readouterr().out
