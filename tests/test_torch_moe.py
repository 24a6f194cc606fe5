"""The port's mixture of experts (``repro_torch.models.moe``) and the moe
family of the LM (``reduced(mixtral-8x7b)``) against the JAX package, both
on the CPU, and the MoE checkpoint relay (``reshape_moe_layout``).

The same numpy inputs and the reference's own parameters (converted by
``lm_from_jax``) go through both packages; fp32, tolerance 1e-5
scale-aware (max|a - b| <= 1e-5 * max(1, max|b|)) unless stated. Routing
is held exactly (experts, positions, drops): the router weights are scaled
in numpy before either package sees them so that no two logits of a token
lie within 1e-4 of each other (asserted), far above the fp32 rounding of
either package's logits, so the top-k order cannot depend on it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_shim import given, settings, strategies as st

from _torch_port import (close_scaled, converted_leaves_match,
                         decode_equals_forward, decode_matches,
                         engine_tokens_match, family_loss_and_grads_match,
                         forward_matches, init_tree_matches, np_tree,
                         reset_equals_init, single_thread)

from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.train import checkpoint as jckpt
from repro_torch.convert import lm_from_jax
from repro_torch.core.spikingformer import tree_leaves
from repro_torch.models import moe as tmoe
from repro_torch.train import checkpoint as tckpt

single_thread()
KEY = jax.random.PRNGKey(0)
ARCH = "mixtral-8x7b"

#: deepseek-v2-236b's routing at a narrow width: 160 experts, top-6, the
#: published capacity factor 1.25.
PUBLISHED = dict(d_model=32, num_experts=160, top_k=6, d_ff_expert=16)
#: Router weights scaled to logits of std 12: seed 20's 48 tokens keep every
#: pair of a token's logits at least 1.5e-4 apart.
ROUTER_STD, ROUTER_SEED, TOKENS = 12.0, 20, (2, 24)


def _cfgs(**kw):
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


def _inputs(cfg, seed=ROUTER_SEED, shape=TOKENS):
    """(numpy params of the reference's ``init_moe`` with the router
    replaced, port params, x (B, S, D))."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (*shape, cfg.d_model)).astype(np.float32)
    jp = np_tree(jcommon.split_tree(jmoe.init_moe(KEY, cfg))[0])
    jp["router"] = (rng.normal(0, 1, jp["router"].shape) * ROUTER_STD
                    / np.sqrt(cfg.d_model)).astype(np.float32)
    return jp, lm_from_jax(jp, device="cpu"), x


def _min_logit_gap(jp, x) -> float:
    logits = np.sort(x.reshape(-1, x.shape[-1]).astype(np.float64)
                     @ jp["router"].astype(np.float64), axis=-1)
    return float(np.diff(logits, axis=-1).min())


def _drops(experts, cfg, n) -> int:
    pos = np.asarray(jmoe._expert_positions(jnp.asarray(experts).reshape(-1),
                                            cfg.num_experts))
    return int((pos >= cfg.capacity(n)).sum())


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def test_route_matches_reference_at_the_published_capacity():
    jcfg, tcfg = _cfgs(**PUBLISHED)
    jp, tp, x = _inputs(jcfg)
    assert _min_logit_gap(jp, x) > 1e-4
    xf = x.reshape(-1, jcfg.d_model)
    jg, je, jaux = jmoe._route(jp["router"], xf, jcfg)
    tg, te, taux = tmoe._route(tp["router"], _t(xf), tcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    close_scaled(tg.numpy(), jg)
    close_scaled(taux.numpy(), jaux)
    assert tg.dtype == torch.float32 and te.shape == (48, 6)
    # the published capacity drops tokens here: 48 * 6 / 160 * 1.25 -> 4
    assert jcfg.capacity(48) == 4 and _drops(je, jcfg, 48) > 0


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 1000), n=st.integers(2, 64),
       e=st.sampled_from([2, 4, 8, 16]))
def test_expert_positions_property_and_reference(seed, n, e):
    """The reference's property (positions are a within-expert enumeration,
    unique per expert, contiguous from 0) on the port, and the port's
    positions equal to the reference's: both enumerate in token order."""
    flat_e = np.random.default_rng(seed).integers(0, e, n)
    pos = tmoe._expert_positions(torch.from_numpy(flat_e), e).numpy()
    for ex in range(e):
        assert sorted(pos[flat_e == ex]) == list(range(int((flat_e == ex)
                                                           .sum())))
    np.testing.assert_array_equal(
        pos, np.asarray(jmoe._expert_positions(jnp.asarray(flat_e), e)))
    assert pos.dtype == np.int32


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------

MOE_CASES = {
    # name: (config, token shape)
    "published-160x6": (dict(PUBLISHED), TOKENS),
    "published-shared": (dict(PUBLISHED, n_shared=2), TOKENS),
    "capacity-floor": (dict(d_model=32, num_experts=8, top_k=2,
                            d_ff_expert=16, capacity_factor=1e-9), TOKENS),
    "no-drops-8x2": (dict(d_model=32, num_experts=8, top_k=2, d_ff_expert=16,
                          capacity_factor=8.0), (2, 5)),
    # the reference's E < M layout test, at M = 1 (test_moe.py:102)
    "tp-layout-m1": (dict(d_model=16, num_experts=4, top_k=1, d_ff_expert=8,
                          capacity_factor=8.0), (1, 4)),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_reference(case):
    """y and the aux loss at 1e-5. The published capacity factor drops
    (token, choice) pairs; a capacity factor of 1e-9 puts every expert at
    the floor of 4 slots (``MoEConfig.capacity``), so most pairs drop."""
    kw, shape = MOE_CASES[case]
    jcfg, tcfg = _cfgs(**kw)
    jp, tp, x = _inputs(jcfg, shape=shape)
    assert _min_logit_gap(jp, x) > 1e-4
    jy, jaux = jmoe.moe_apply(jp, x, jcfg)
    ty, taux = tmoe.moe_apply(tp, _t(x), tcfg)
    close_scaled(ty.numpy(), jy)
    close_scaled(taux.numpy(), jaux)
    n = shape[0] * shape[1]
    drops = _drops(jmoe._route(jp["router"], x.reshape(n, -1), jcfg)[1],
                   jcfg, n)
    if case.startswith("published") or case == "capacity-floor":
        assert drops > 0
    else:
        assert drops == 0
    if case == "capacity-floor":
        assert jcfg.capacity(n) == 4 and drops > n * jcfg.top_k // 2
    if case == "tp-layout-m1":
        assert tuple(tp["w_gate"].shape) == (1, 4, 16, 8)


@pytest.mark.parametrize("case", ["published-shared", "capacity-floor"])
def test_moe_apply_gradients_match_reference(case):
    """d(sum(y * r) + aux) for every parameter leaf and for x at 1e-5,
    drops included (a dropped pair gets no gradient in either package)."""
    kw, shape = MOE_CASES[case]
    jcfg, tcfg = _cfgs(**kw)
    jp, tp, x = _inputs(jcfg, shape=shape)
    r = np.random.default_rng(1).normal(0, 1, x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_apply(p, x, jcfg)
        return jnp.sum(y * r) + aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, x)
    leaves = [a.requires_grad_(True) for a in tree_leaves(tp)]
    xt = _t(x).requires_grad_(True)
    y, aux = tmoe.moe_apply(tp, xt, tcfg)
    grads = torch.autograd.grad((y * _t(r)).sum() + aux, [*leaves, xt])
    for g, want in zip(grads[:-1], jax.tree.leaves(jgp)):
        close_scaled(g.numpy(), want)
    close_scaled(grads[-1].numpy(), jgx)


LOCAL_CASES = {
    # name: (config, shards' weights); the body runs with model_axis=None
    "ep-m1": dict(PUBLISHED, n_shared=0),
    "ep-m2": dict(d_model=32, num_experts=8, top_k=2, d_ff_expert=16,
                  capacity_factor=1.25, model_shards=2),
    "tp-m4": dict(d_model=32, num_experts=2, top_k=1, d_ff_expert=16,
                  capacity_factor=1.25, model_shards=4),
}


@pytest.mark.parametrize("body", ["_local_moe", "_local_moe_replicated"])
@pytest.mark.parametrize("case", sorted(LOCAL_CASES))
def test_local_bodies_match_reference(case, body):
    """The reference's per-shard bodies with ``model_axis=None`` against
    the port's (which have no mesh axis), in both layouts (E >= M, and E < M's tensor-parallel
    F-slices): the local slice of shard 0, the dispatch, the drop row and
    the combine at 1e-5."""
    jcfg, tcfg = _cfgs(**LOCAL_CASES[case])
    jp, tp, x = _inputs(jcfg)
    assert _min_logit_gap(jp, x) > 1e-4
    args = ("router", "w_gate", "w_up", "w_down")
    jy, jaux = getattr(jmoe, body)(x, *(jp[k] for k in args), jcfg, None)
    ty, taux = getattr(tmoe, body)(_t(x), *(tp[k] for k in args), tcfg)
    close_scaled(ty.numpy(), jy)
    close_scaled(taux.numpy(), jaux)


@pytest.mark.parametrize("case", ["ep-m2", "tp-m4"])
def test_moe_apply_refuses_a_mesh_layout(case):
    """``model_shards > 1`` needs the mesh's all-to-all: the port raises
    naming ROADMAP A11 where the reference asserts without a mesh."""
    _, tp, x = _inputs(jmoe.MoEConfig(**LOCAL_CASES[case]))
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        tmoe.moe_apply(tp, _t(x), tmoe.MoEConfig(**LOCAL_CASES[case]))


def test_combine_is_the_reference_scatter_add_in_order():
    """``_combine`` adds a token's k rows one choice at a time from zero,
    the order of the reference's ``y.at[tok].add`` on the CPU: bit-equal
    to it on these inputs."""
    rng = np.random.default_rng(3)
    n, k, d = 7, 6, 5
    contrib = (rng.normal(0, 1, (n * k, d)) * 10.0 ** rng.integers(
        -4, 4, (n * k, 1))).astype(np.float32)
    want = jnp.zeros((n, d)).at[jnp.arange(n).repeat(k)].add(contrib)
    got = tmoe._combine(torch.zeros(n, d), _t(contrib), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The moe family of the LM: reduced mixtral-8x7b
# ---------------------------------------------------------------------------

def test_init_lm_tree_has_the_reference_keys_shapes_and_specs():
    init_tree_matches(ARCH)


def test_lm_from_jax_carries_the_moe_leaves():
    keys = converted_leaves_match(ARCH)
    assert {"blocks/ffn/router", "blocks/ffn/w_gate",
            "blocks/ffn/w_down"} <= keys


@pytest.mark.parametrize("jax_policy", [None, "jnp", "pallas"])
def test_lm_forward_matches_reference(jax_policy):
    forward_matches(ARCH, jax_policy)


@pytest.mark.parametrize("jax_policy,at_init", [(None, False),
                                                ("jnp", False), (None, True)])
def test_lm_loss_and_gradients_match_reference(jax_policy, at_init):
    """``lm_loss`` (the MoE aux loss weighted in) and every gradient leaf,
    the experts' and the router's included, at the tolerances that
    ``_torch_port.GRAD_REL_L2_AT_INIT`` explains."""
    family_loss_and_grads_match(ARCH, jax_policy, at_init)


@pytest.mark.parametrize("jax_policy", [None, "jnp"])
def test_lm_decode_step_matches_reference(jax_policy):
    decode_matches(ARCH, jax_policy)


@pytest.mark.parametrize("policy", ["eager", "cuda"])
def test_spiking_decode_matches_forward(policy):
    decode_equals_forward(ARCH, policy)


@pytest.mark.parametrize("spiking", [False, True])
def test_reset_cache_slots_matches_init(spiking):
    reset_equals_init(ARCH, spiking)


@pytest.mark.parametrize("spiking", [False, True])
def test_engine_tokens_equal_the_reference_engine(spiking):
    engine_tokens_match(ARCH, spiking)


# ---------------------------------------------------------------------------
# Checkpoints: the MoE layout relay
# ---------------------------------------------------------------------------

RELAYS = {
    # name: (shape, old M, new M, E) in both regimes, both directions
    "ep-4to2": ((4, 2, 6, 10), 4, 2, 8),
    "ep-2to4": ((2, 4, 6, 10), 2, 4, 8),
    "tp-4to2": ((4, 1, 6, 5), 4, 2, 2),
    "tp-2to4": ((2, 1, 6, 10), 2, 4, 2),
    "tp-to-ep": ((4, 1, 6, 5), 4, 1, 2),
}


@pytest.mark.parametrize("case", sorted(RELAYS))
def test_reshape_moe_layout_matches_reference_byte_for_byte(case):
    shape, old, new, e = RELAYS[case]
    w = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    got = tckpt.reshape_moe_layout(w, old, new, num_experts=e)
    want = jckpt.reshape_moe_layout(w, old, new, num_experts=e)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    back = tckpt.reshape_moe_layout(got, new, old, num_experts=e)
    np.testing.assert_array_equal(back, w)
    with pytest.raises(ValueError, match="model shards"):
        tckpt.reshape_moe_layout(w, old + 1, new, num_experts=e)


def test_reshape_moe_layout_w_down_at_e_below_m_joins_along_d():
    """A fault of the reference that the port keeps (ROADMAP C5): the relay
    takes F as the last axis, but ``w_down`` is (M, E_loc, F_loc, D). At
    E = 2 from 4 shards (tp 2) to 2 (tp 1) the two F-slices of an expert
    must join along F, giving (2, 1, 2 F_loc, D) = (2, 1, 10, 6); both
    packages give (2, 1, 5, 12), the slices joined along D."""
    w = np.random.default_rng(5).normal(size=(4, 1, 5, 6)).astype(np.float32)
    right = w.reshape(2, 2, 5, 6).reshape(2, 1, 10, 6)    # slices along F
    for ckpt in (jckpt, tckpt):
        got = ckpt.reshape_moe_layout(w, 4, 2, num_experts=2)
        assert got.shape == (2, 1, 5, 12) != right.shape
    np.testing.assert_array_equal(
        tckpt.reshape_moe_layout(w, 4, 2, num_experts=2),
        np.concatenate([w[0::2, 0], w[1::2, 0]], axis=-1)[:, None])
