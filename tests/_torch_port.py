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
from repro.models import mla as jmla
from repro.models import mlp as jmlp
from repro.models import moe as jmoe
from repro_torch.configs import registry as treg
from repro_torch.convert import from_jax, lm_from_jax
from repro_torch.core.lif import LIFConfig
from repro_torch.core.policy import IMPL_FROM_JAX, POLICY_FROM_JAX, \
    named_policy
from repro_torch.core.spikingformer import tree_leaves, tree_map, \
    value_and_grad
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import mla as tmla
from repro_torch.models import mlp as tmlp
from repro_torch.models import moe as tmoe
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


def _jax_branches(p, cfg):
    """The reference block's attention and FFN branch functions."""
    if cfg.mla is not None:
        attn = lambda h: jmla.mla_attention(p["attn"], h, cfg.mla)  # noqa: E731
    else:
        attn = lambda h: jattn.attention(p["attn"], h, cfg.attn)  # noqa: E731
    if cfg.moe is not None:
        ffn = lambda h: jmoe.moe_apply(p["ffn"], h, cfg.moe)[0]  # noqa: E731
    else:
        ffn = lambda h: jmlp.swiglu(p["ffn"], h)  # noqa: E731
    return attn, ffn


def _torch_branches(p, cfg):
    """The port block's attention and FFN branch functions."""
    if cfg.mla is not None:
        attn = lambda h: tmla.mla_attention(p["attn"], h, cfg.mla)  # noqa: E731
    else:
        attn = lambda h: tattn.attention(p["attn"], h, cfg.attn)  # noqa: E731
    if cfg.moe is not None:
        ffn = lambda h: tmoe.moe_apply(p["ffn"], h, cfg.moe)[0]  # noqa: E731
    else:
        ffn = lambda h: tmlp.swiglu(p["ffn"], h)  # noqa: E731
    return attn, ffn


def jax_branch_spikes(params, toks, cfg):
    """The reference's ``_dense_block``, taken apart to keep each layer's
    branch spikes (the reference's ``lm_forward`` returns none)."""
    x = jcommon.embed(params["embed"], toks, cfg.dtype)
    spikes = []
    for i in range(cfg.num_layers):
        p = jax.tree.map(lambda a: a[i], params["blocks"])
        attn, ffn = _jax_branches(p, cfg)
        x = x + attn(jcommon.rmsnorm(p["ln1"], x, cfg.norm_eps))
        f = jlm._seq_lif(ffn(jcommon.rmsnorm(p["ln2"], x, cfg.norm_eps)),
                         cfg)
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
            attn, ffn = _torch_branches(p, cfg)
            x = x + attn(tcommon.rmsnorm(p["ln1"], x, cfg.norm_eps))
            f = tlm._seq_lif(ffn(tcommon.rmsnorm(p["ln2"], x, cfg.norm_eps)),
                             cfg)
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


def lm_loss_and_grads_match(jcfg, tcfg, batch, params=None,
                            rel_l2: float | None = None):
    """``lm_loss`` and its gradient in both packages on one numpy batch,
    from the reference's ``init_lm`` (or ``params``, a (reference, port)
    pair): the loss and the three metrics at 1e-5 scale-aware, every
    gradient leaf as :func:`_lm_grads_close`, or, given ``rel_l2``, each
    leaf within that relative L2 error."""
    jp, tp = params if params is not None else lm_params(jcfg)
    (jl, jm), jg = jax.value_and_grad(jlm.lm_loss, has_aux=True)(
        jp, as_jax(batch), jcfg)
    (tl, tm), tg = value_and_grad(tlm.lm_loss, tp, as_torch(batch), tcfg)
    close_scaled(tl, jl)
    assert sorted(tm) == sorted(jm) == ["aux_loss", "logits_mean_abs",
                                        "loss"]
    for k in jm:
        close_scaled(tm[k], jm[k])
    if rel_l2 is not None:
        for a, b in zip(tree_leaves(tg), jax.tree.leaves(jg)):
            b = np.asarray(b)
            assert np.linalg.norm(a.numpy() - b) <= rel_l2 * np.linalg.norm(b)
        return
    _lm_grads_close(tg, jg, _lm_spike_mismatch(jp, tp, batch["tokens"],
                                               jcfg, tcfg))


# ---------------------------------------------------------------------------
# The LM families beside dense (moe, MLA): checks shared by their test files
# ---------------------------------------------------------------------------

#: (B, S) tokens of the family checks, reduced vocabulary (512).
FAMILY_TOKENS = np.array([[3, 7, 11, 2, 5, 9, 300, 41],
                          [8, 8, 1, 0, 511, 17, 5, 6]], np.int32)


def init_tree_matches(name: str):
    """The port's ``init_lm`` tree at ``reduced(name)``: the reference's
    keys, shapes and specs leaf for leaf, fp32."""
    jcfg, tcfg = lm_cfgs(name, "jnp")
    jp, jspecs = jcommon.split_tree(jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    tp, tspecs = tcommon.split_tree(
        tlm.init_lm(torch.Generator().manual_seed(0), tcfg, "cpu"))
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(tree_leaves(tp)) == len(jleaves)
    for path, leaf in jleaves:
        node, spec, jspec = tp, tspecs, jspecs
        for k in path:
            node, spec, jspec = node[k.key], spec[k.key], jspec[k.key]
        assert tuple(node.shape) == leaf.shape, path
        assert node.dtype == torch.float32
        assert spec == tuple(jspec), path


def converted_leaves_match(name: str):
    """``lm_from_jax`` carries every leaf of the reference's tree (the
    4-D experts, the 3-D MLA projections, ``shared``, the fp32 router)
    with its key, shape, dtype and bytes."""
    jcfg, _ = lm_cfgs(name, None)
    jp, tp = lm_params(jcfg)
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    tleaves = tree_leaves(tp)
    assert len(tleaves) == len(jleaves)
    for (path, want), got in zip(jleaves, tleaves):
        want = np.asarray(want)
        assert got.dtype == torch.float32 and want.dtype == np.float32, path
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(path))
    return {"/".join(k.key for k in p) for p, _ in jleaves}


#: The LM-family gradient checks' two regimes. At the reference's init the
#: query and key projections are drawn at fan-in ``h^-1/2`` (``normal_leaf``
#: takes ``shape[-2]``, the heads), so the reduced configs' attention logits
#: have a std of about 23: the softmax is that sharp, and the last-bit
#: differences of two fp32 sum orders grow through the layers (to 1.7e-4
#: relative L2 in reduced mixtral's gradients, 1.7e-5 in deepseek-v2's).
#: There the leaves are held at GRAD_REL_L2_AT_INIT; with the query and key
#: projections scaled by QK_SCALE in numpy, before either package sees
#: them, the logits' std is about 1.5 and every leaf is held at 1e-5
#: scale-aware (measured: 1e-6 relative L2).
GRAD_REL_L2_AT_INIT = 1e-3
QK_SCALE = 0.25


def qk_scaled_params(jcfg):
    """(reference, port) parameters of ``init_lm`` with the query and key
    projections (``wq``/``wk``, or MLA's ``w_uq``/``w_uk``) times
    ``QK_SCALE``."""
    jp = np_tree(lm_params(jcfg)[0])
    for k in (("w_uq", "w_uk") if jcfg.mla is not None else ("wq", "wk")):
        jp["blocks"]["attn"][k] = jp["blocks"]["attn"][k] * np.float32(
            QK_SCALE)
    return as_jax(jp), lm_from_jax(jp, device="cpu")


def family_loss_and_grads_match(name: str, jax_policy: str | None,
                                at_init: bool):
    """``lm_loss`` and every gradient leaf (the experts', the router's and
    MLA's included) on ``lm_batch()``, in one of the two regimes above."""
    jcfg, tcfg = lm_cfgs(name, jax_policy)
    if at_init:
        lm_loss_and_grads_match(jcfg, tcfg, lm_batch(),
                                rel_l2=GRAD_REL_L2_AT_INIT)
    else:
        lm_loss_and_grads_match(jcfg, tcfg, lm_batch(),
                                params=qk_scaled_params(jcfg))


def forward_matches(name: str, jax_policy: str | None):
    """``lm_forward`` (hidden states, aux loss), ``lm_prefill`` and the
    flash forward at 1e-5 scale-aware, branch spikes equal layer by layer."""
    jcfg, tcfg = lm_cfgs(name, jax_policy)
    jp, tp = lm_params(jcfg)
    toks = FAMILY_TOKENS
    jh, jaux = jlm.lm_forward(jp, {"tokens": toks}, jcfg)
    th, taux = tlm.lm_forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    if jax_policy is not None:
        mism = [mismatch_fraction(t, j) for t, j in zip(
            torch_branch_spikes(tp, torch.from_numpy(toks), tcfg),
            jax_branch_spikes(jp, toks, jcfg))]
        assert len(mism) == jcfg.num_layers and not any(mism), mism
    close_scaled(th.numpy(), jh)
    assert float(jaux) > 0.0
    close_scaled(taux.numpy(), jaux)
    close_scaled(tlm.lm_prefill(tp, {"tokens": torch.from_numpy(toks)},
                                tcfg).numpy(),
                 jlm.lm_prefill(jp, {"tokens": toks}, jcfg))
    close_scaled(tlm.lm_forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                                use_flash=True)[0].numpy(), jh)


def decode_matches(name: str, jax_policy: str | None, steps: int = 6):
    """``steps`` decode steps of two rows at different positions from the
    same cache: logits and every cache leaf at 1e-5 scale-aware."""
    jcfg, tcfg = lm_cfgs(name, jax_policy)
    jp, tp = lm_params(jcfg)
    jc = jlm.init_cache(jcfg, 2, 16, jnp.float32)
    tc = tlm.init_cache(tcfg, 2, 16, torch.float32, "cpu")
    assert [tuple(a.shape) for a in tree_leaves(tc)] == \
        [a.shape for a in jax.tree.leaves(jc)]
    pos = np.array([0, 2], np.int32)
    for t in range(steps):
        tok = FAMILY_TOKENS[:, t:t + 1]
        jl, jc = jlm.lm_decode_step(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(pos), jcfg)
        tl, tc = tlm.lm_decode_step(tp, tc, torch.from_numpy(tok),
                                    torch.from_numpy(pos), tcfg)
        close_scaled(tl.numpy(), jl)
        trees_close(tc, jc)
        pos = pos + 1


def decode_equals_forward(name: str, policy: str, tol: float = 1e-4):
    """The reference's own check on the port (``test_archs_smoke.py:92``):
    token-by-token decode (the cache, the (U, S) carry) equals the
    full-sequence forward, at ``tol`` absolute and relative (the
    reference's own is 2e-2; a reduced mixtral's sharp attention, see
    GRAD_REL_L2_AT_INIT, parts the two orders of the sums by 1.4e-5)."""
    jcfg, tcfg = lm_cfgs(name, "jnp")
    tcfg = tcfg.replace(lif=LIFConfig(policy=named_policy(policy)))
    _, tp = lm_params(jcfg)
    toks = torch.from_numpy(FAMILY_TOKENS[:1])
    x, _ = tlm.lm_forward(tp, {"tokens": toks}, tcfg)
    want = tcommon.unembed(tp["embed"], x)[0]
    cache = tlm.init_cache(tcfg, 1, 32, torch.float32, "cpu")
    for t in range(toks.shape[1]):
        lg, cache = tlm.lm_decode_step(tp, cache, toks[:, t:t + 1],
                                       torch.tensor([t]), tcfg)
        np.testing.assert_allclose(lg[0].numpy(), want[t].numpy(),
                                   atol=tol, rtol=tol)


def reset_equals_init(name: str, spiking: bool):
    """``reset_cache_slots`` of a dirty cache: no slot, every slot (equal
    to ``init_cache``) and one slot (its neighbours untouched)."""
    _, cfg = lm_cfgs(name, "jnp" if spiking else None)
    init = tlm.init_cache(cfg, 3, 16, torch.float32, "cpu")
    dirty = tree_map(lambda a: torch.full_like(a, 7.0), init)
    none = tlm.reset_cache_slots(dirty, torch.zeros(3, dtype=torch.bool), cfg)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(none),
                                                 tree_leaves(dirty)))
    full = tlm.reset_cache_slots(dirty, torch.ones(3, dtype=torch.bool), cfg)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(full),
                                                 tree_leaves(init)))
    part = tlm.reset_cache_slots(dirty, torch.tensor([False, True, False]),
                                 cfg)
    for a, ax in zip(tree_leaves(part),
                     tree_leaves(tlm.cache_batch_axes(cfg, part))):
        a = a.movedim(ax, 0)
        assert (a[1] == 0).all() and (a[0] == 7).all() and (a[2] == 7).all()


#: (prompt, new tokens) of the engine check: 5 requests through 2 slots.
ENGINE_REQUESTS = [([3, 17, 42], 5), ([5, 9], 4), ([100, 7, 3], 6), ([8], 3),
                   ([12, 13, 14, 15], 4)]


def engine_tokens_match(name: str, spiking: bool):
    """The port's ``ServingEngine`` and the reference's, the same requests
    through 2 slots, the same converted weights: every request's tokens
    equal."""
    from repro.serving.engine import ServingEngine as JEngine
    from repro.serving.scheduler import Request as JRequest
    from repro_torch.serving import Request, ServingEngine
    jcfg, tcfg = lm_cfgs(name, "jnp" if spiking else None)
    jp, tp = lm_params(jcfg)
    jeng = JEngine(jp, jcfg, slots=2, max_seq=32)
    teng = ServingEngine(tp, tcfg, slots=2, max_seq=32, device="cpu")
    for uid, (prompt, new) in enumerate(ENGINE_REQUESTS):
        assert jeng.submit(JRequest(uid=uid, prompt=prompt,
                                    max_new_tokens=new))
        assert teng.submit(Request(uid=uid, prompt=prompt,
                                   max_new_tokens=new))
    want = {r.uid: r.output for r in jeng.run_to_completion()}
    got = {r.uid: r.output for r in teng.run_to_completion()}
    assert sorted(got) == sorted(want) == list(range(len(ENGINE_REQUESTS)))
    assert got == want
    assert teng.step_count == jeng.step_count
