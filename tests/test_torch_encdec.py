"""The encoder-decoder (audio) family of the port, ``repro_torch.models.
encdec``, against the JAX package's ``repro.models.encdec``, both on the
CPU, at reduced ``whisper-large-v3`` (2 encoder + 2 decoder layers, d 64,
4 heads of 16, 32 frames; with 2 key/value heads where ``n_rep > 1`` is
checked).

Parameters are the reference's ``init_encdec`` converted by
``convert.lm_from_jax``, with every attention's query and key projections
scaled by ``_torch_port.QK_SCALE`` in numpy (the reference's init makes the
softmax sharp, see ``GRAD_REL_L2_AT_INIT``); inputs are numpy draws. Tolerance:
1e-5 scale-aware (``close_scaled``) in fp32; a bf16 cache leaf within
one bf16 rounding (2^-8 of its scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (FAMILY_TOKENS, close_scaled, encdec_cfgs,
                         encdec_params, single_thread, trees_close)

from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro_torch.core.spikingformer import tree_leaves
from repro_torch.models import common as tcommon
from repro_torch.models import encdec as tencdec

single_thread()


def _frames(batch: int = 2, seq: int = 32, d: int = 64, seed: int = 3):
    return np.random.default_rng(seed).normal(0.0, 1.0, (batch, seq, d)) \
        .astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seq,dim", [(32, 64), (1500, 1280)])
def test_sinusoid_pos_matches_reference(seq, dim):
    """The reduced and the published (1,500 frames, d 1280) tables. The
    two packages' fp32 ``exp`` differ by one ulp at some frequencies (54
    of the published 640: XLA's CPU ``exp`` is not correctly rounded), and
    position p multiplies that by p: the tolerance is ``seq`` ulps of a
    frequency <= 1, ``seq * 2^-23`` (1e-5 at the reduced size)."""
    got = tencdec.sinusoid_pos(seq, dim)
    assert got.shape == (seq, dim) and got.dtype == torch.float32
    close_scaled(got.numpy(), jencdec.sinusoid_pos(seq, dim),
                 atol=max(1e-5, seq * 2.0 ** -23))


@pytest.mark.parametrize("n_kv", [None, 2])
def test_cross_memory_and_cross_attention_match_reference(n_kv):
    """The decoder layer 0's cross attention over an encoder output: the
    memory's keys and values (B, Se, HK, dh) and the attended output."""
    jcfg, tcfg = encdec_cfgs(n_kv)
    jp, tp = encdec_params(jcfg)
    jx = jax.tree.map(lambda a: a[0], jp["dec_blocks"]["cross"])
    tx = tcommon.layer(tp["dec_blocks"]["cross"], 0)
    enc = _frames()
    x = _frames(seq=8, seed=4)
    jk, jv = jencdec.cross_memory(jx, jnp.asarray(enc))
    tk, tv = tencdec.cross_memory(tx, _t(enc))
    assert tuple(tk.shape) == jk.shape == (2, 32, n_kv or 4, 16)
    close_scaled(tk.numpy(), jk)
    close_scaled(tv.numpy(), jv)
    close_scaled(tencdec.cross_attention(tx, _t(x), tk, tv, tcfg).numpy(),
                 jencdec.cross_attention(jx, jnp.asarray(x), jk, jv, jcfg))


@pytest.mark.parametrize("n_kv", [None, 2])
def test_encode_matches_reference(n_kv):
    jcfg, tcfg = encdec_cfgs(n_kv)
    jp, tp = encdec_params(jcfg)
    close_scaled(tencdec.encode(tp, _t(_frames()), tcfg).numpy(),
                 jencdec.encode(jp, jnp.asarray(_frames()), jcfg))


@pytest.mark.parametrize("use_flash", [None, False, True])
def test_decode_train_matches_reference(use_flash):
    """Teacher-forced decoder hidden states over the same encoder output,
    with the full and the chunked self-attention (``None``: the length
    rule, full at 8 tokens)."""
    jcfg, tcfg = encdec_cfgs()
    jp, tp = encdec_params(jcfg)
    enc = jencdec.encode(jp, jnp.asarray(_frames()), jcfg)
    want = jencdec.decode_train(jp, jnp.asarray(FAMILY_TOKENS), enc, jcfg,
                                use_flash=use_flash)
    got = tencdec.decode_train(tp, _t(FAMILY_TOKENS), _t(np.asarray(enc)),
                               tcfg, use_flash=use_flash)
    close_scaled(got.numpy(), want)


def test_init_tree_matches_reference():
    """``init_encdec``'s tree: the reference's keys, shapes, dtypes and
    partition specs, leaf for leaf."""
    jcfg, tcfg = encdec_cfgs()
    jp, jspecs = jcommon.split_tree(jencdec.init_encdec(
        jax.random.PRNGKey(0), jcfg))
    tp, tspecs = tcommon.split_tree(tencdec.init_encdec(
        torch.Generator().manual_seed(0), tcfg, "cpu"))
    assert sorted(tp) == sorted(jp) == ["dec_blocks", "embed", "enc_blocks",
                                        "ln_dec", "ln_enc"]
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(tree_leaves(tp)) == len(jleaves)
    for path, leaf in jleaves:
        node, spec, jspec = tp, tspecs, jspecs
        for k in path:
            node, spec, jspec = node[k.key], spec[k.key], jspec[k.key]
        assert tuple(node.shape) == leaf.shape, path
        assert node.dtype == torch.float32 and leaf.dtype == jnp.float32
        assert spec == tuple(jspec), path


def test_converted_leaves_match():
    """``lm_from_jax`` carries every leaf of the reference's tree with its
    key, shape, dtype and bytes."""
    jcfg, _ = encdec_cfgs()
    jp, tp = encdec_params(jcfg, qk_scale=1.0)
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    for (path, want), got in zip(jleaves, tree_leaves(tp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=str(path))


@pytest.mark.parametrize("dtype", ["float32", "default"])
def test_init_encdec_cache_matches_reference(dtype):
    """The self-attention cache (zeros, (L, B, max_seq, HK, dh)) and the
    cross memory of each decoder layer, in fp32 and at the bf16 default."""
    jcfg, tcfg = encdec_cfgs()
    jp, tp = encdec_params(jcfg)
    kw = ({}, {}) if dtype == "default" else (
        {"dtype": jnp.float32}, {"dtype": torch.float32})
    jc = jencdec.init_encdec_cache(jp, jnp.asarray(_frames()), jcfg, 2, 16,
                                   **kw[0])
    tc = tencdec.init_encdec_cache(tp, _t(_frames()), tcfg, 2, 16, **kw[1])
    want_dtype = torch.bfloat16 if dtype == "default" else torch.float32
    jleaves = jax.tree_util.tree_flatten_with_path(jc)[0]
    tleaves = tree_leaves(tc)
    assert len(tleaves) == len(jleaves) == 4
    for (path, want), got in zip(jleaves, tleaves):
        assert tuple(got.shape) == want.shape, path
        assert got.dtype == want_dtype
        close_scaled(got.float().numpy(), np.asarray(want, np.float32),
                     atol=2.0 ** -8 if dtype == "default" else 1e-5)
    assert not tc["self"]["k"].any() and tc["cross"]["mk"].any()


def test_eight_decode_steps_match_reference():
    """Eight ``encdec_decode_step``s of two rows at different positions
    from the same fp32 cache: logits and every cache leaf."""
    jcfg, tcfg = encdec_cfgs()
    jp, tp = encdec_params(jcfg)
    jc = jencdec.init_encdec_cache(jp, jnp.asarray(_frames()), jcfg, 2, 16,
                                   jnp.float32)
    tc = tencdec.init_encdec_cache(tp, _t(_frames()), tcfg, 2, 16,
                                   torch.float32)
    pos = np.array([0, 5], np.int32)
    for t in range(8):
        tok = FAMILY_TOKENS[:, t:t + 1]
        jl, jc = jencdec.encdec_decode_step(jp, jc, jnp.asarray(tok),
                                            jnp.asarray(pos), jcfg)
        tl, tc = tencdec.encdec_decode_step(tp, tc, _t(tok), _t(pos), tcfg)
        close_scaled(tl.numpy(), jl)
        trees_close(tc, jc)
        pos = pos + 1


def test_decode_equals_the_teacher_forced_forward():
    """The reference's own check on the port (``test_archs_smoke.py``):
    token-by-token decode from the cache equals ``decode_train`` +
    ``unembed`` over the whole sequence, at 1e-4 (the reference holds 2e-2)."""
    jcfg, tcfg = encdec_cfgs()
    _, tp = encdec_params(jcfg)
    toks = _t(FAMILY_TOKENS)
    frames = _t(_frames())
    enc = tencdec.encode(tp, frames, tcfg)
    want = tcommon.unembed(tp["embed"],
                           tencdec.decode_train(tp, toks, enc, tcfg))
    cache = tencdec.init_encdec_cache(tp, frames, tcfg, 2, 16, torch.float32)
    for t in range(toks.shape[1]):
        lg, cache = tencdec.encdec_decode_step(
            tp, cache, toks[:, t:t + 1], torch.full((2,), t), tcfg)
        np.testing.assert_allclose(lg.numpy(), want[:, t].numpy(),
                                   atol=1e-4, rtol=1e-4)


def test_the_cache_passed_in_is_not_modified():
    jcfg, tcfg = encdec_cfgs()
    _, tp = encdec_params(jcfg)
    cache = tencdec.init_encdec_cache(tp, _t(_frames()), tcfg, 2, 16,
                                      torch.float32)
    before = [a.clone() for a in tree_leaves(cache)]
    _, new = tencdec.encdec_decode_step(tp, cache, _t(FAMILY_TOKENS[:, :1]),
                                        _t(np.zeros(2, np.int32)), tcfg)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cache), before))
    assert not torch.equal(new["self"]["k"], cache["self"]["k"])
    assert new["cross"] is cache["cross"]

