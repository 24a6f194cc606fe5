"""The LIF kernels' layouts and carried state, against the JAX package on
the CPU.

The port's SOMA kernel starts from a carried state (u0, s0) itself (step 0
as alpha * u0 * (1 - s0) + x_0, ``lif_step``'s order) and writes the final
state, and both LIF kernels take a (T, M, D) operand in any layout with unit
stride on D, so the spiking LM's (S, B, D) view of its (B, S, D) branch
output reaches them without a copy. Here the plain versions (which the
wrappers take for CPU tensors, with the kernels' interface and output
layouts) and the ``cuda`` arms of ``lif_scan`` / ``lif_scan_with_state`` /
``lif_decode_step`` are held against the reference: its ``jnp`` scans and
``lif_step``, its Pallas SOMA kernel in interpret mode on the folded input,
and ``jax.grad`` of its ``lif_scan``.

Tolerances: spikes and masks bitwise; U bitwise against the ``jnp`` path
(the same operations in the same order) and up to the sign of a zero
against the reference's kernel path, which folds the carried term into x[0]
and walks from rest (0 + (-0) = +0); gradients within 1e-6 absolute (XLA on
the CPU fuses ``g - alpha * U * gu`` into one FMA, ``test_torch_grads.py``).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import single_thread

from repro.core import lif as jlif_core
from repro.core.policy import named_policy as jax_named_policy
from repro.kernels import lif_soma as jlif
from repro_torch.core import lif as tlif
from repro_torch.core.policy import named_policy
from repro_torch.kernels import lif_soma, ops

single_thread()

LIFS = [dict(alpha=0.5, th_fire=1.0, th_lo=0.0, th_hi=2.0, grad_scale=1.0),
        dict(alpha=0.3, th_fire=0.7, th_lo=-0.2, th_hi=1.1, grad_scale=0.5)]


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _state(rng, shape):
    """A carried (u0, s0) with the corners that make signed zeros: where
    s0 = 1 and u0 < 0, alpha * u0 * (1 - s0) is -0."""
    u0 = rng.normal(0.4, 0.8, shape).astype(np.float32)
    s0 = (rng.random(shape) < 0.4).astype(np.float32)
    u0.flat[:3], s0.flat[:3] = -0.5, 1.0
    return u0, s0


def _inputs(rng, shape):
    x = rng.normal(0.3, 1.2, shape).astype(np.float32)
    x[0].flat[:3] = [-0.0, 0.0, -0.0]
    return x


def _bits(a):
    return torch.from_numpy(np.array(a, dtype=np.float32)).view(torch.int32)


@pytest.mark.parametrize("shape", [(1, 8, 16), (5, 3, 7), (12, 2, 33)])
@pytest.mark.parametrize("lif", LIFS)
def test_plain_forward_from_a_carried_state_matches_the_reference(shape,
                                                                  lif):
    """``lif_soma_fwd_plain`` with (u0, s0) against the reference's ``jnp``
    stateful scan (spikes and final state bitwise, signed zeros included)
    and against its Pallas SOMA kernel on the folded input (S and mask
    bitwise, U up to the sign of a zero)."""
    rng = np.random.default_rng(sum(shape))
    x = _inputs(rng, shape)
    u0, s0 = _state(rng, shape[1:])
    kw = {k: lif[k] for k in ("alpha", "th_fire", "th_lo", "th_hi")}
    s, u, mask, u_last, s_last = lif_soma.lif_soma_fwd(_t(x), _t(u0),
                                                       _t(s0), **kw)
    jcfg = jlif_core.LIFConfig(**lif, policy=jax_named_policy("jnp"))
    js, (ju, jsl) = jlif_core.lif_scan_with_state(
        jnp.asarray(x), jnp.asarray(u0), jnp.asarray(s0), jcfg)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert torch.equal(_bits(u_last.numpy()), _bits(ju))
    assert torch.equal(_bits(s_last.numpy()), _bits(jsl))
    folded = jnp.asarray(x).at[0].add(lif["alpha"] * jnp.asarray(u0)
                                      * (1.0 - jnp.asarray(s0)))
    ks, ku, km = jlif.lif_soma_fwd(folded, interpret=True, **kw)
    np.testing.assert_array_equal(s.numpy(), np.asarray(ks))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(km))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ku))  # -0 == +0
    np.testing.assert_array_equal(u_last.numpy(), u.numpy()[-1])
    np.testing.assert_array_equal(s_last.numpy(), s.numpy()[-1])


@pytest.mark.parametrize("lif", LIFS)
def test_decode_step_is_one_fused_call_equal_to_lif_step(lif):
    """The ``cuda`` arm of ``lif_decode_step`` (the stateful op, one SOMA
    call from the carried state) against the reference's ``jnp``
    ``lif_decode_step`` and the port's ``lif_step``, bit for bit, signed
    zeros included."""
    rng = np.random.default_rng(5)
    x = _inputs(rng, (1, 4, 16))[0]
    u0, s0 = _state(rng, (4, 16))
    cfg = tlif.LIFConfig(**lif, policy=named_policy("cuda-full"))
    s, (u, sn) = tlif.lif_decode_step(_t(x), _t(u0), _t(s0), cfg)
    js, (ju, jsn) = jlif_core.lif_decode_step(
        jnp.asarray(x), jnp.asarray(u0), jnp.asarray(s0),
        jlif_core.LIFConfig(**lif, policy=jax_named_policy("jnp")))
    eu, es = tlif.lif_step(_t(u0), _t(s0), _t(x), tlif.LIFConfig(**lif))
    for got, want in ((s, js), (u, ju), (sn, jsn), (u, eu.detach()),
                      (sn, es.detach())):
        assert torch.equal(_bits(got.detach().numpy()),
                           _bits(np.asarray(want)))


@pytest.mark.parametrize("lif", LIFS)
def test_lif_scan_on_the_swapped_view_matches_the_reference(lif):
    """``lif_scan`` under ``cuda-full`` on the (S, B, D) view of a (B, S, D)
    branch output, as the LM calls it, against the reference's ``lif_scan``
    under ``pallas-full`` on ``jnp.swapaxes``: spikes bitwise, the gradient
    to the (B, S, D) input within 1e-6."""
    rng = np.random.default_rng(7)
    f = rng.normal(0.3, 1.2, (3, 11, 16)).astype(np.float32)
    g = rng.normal(0, 1, f.shape).astype(np.float32)
    jcfg = jlif_core.LIFConfig(**lif, policy=jax_named_policy("pallas-full"))

    def jloss(a):
        s = jnp.swapaxes(jlif_core.lif_scan(jnp.swapaxes(a, 0, 1), jcfg),
                         0, 1)
        return jnp.sum(s * g), s

    (_, want_s), want_g = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(f))
    ft = _t(f, grad=True)
    s = tlif.lif_scan(ft.transpose(0, 1), tlif.LIFConfig(
        **lif, policy=named_policy("cuda-full"))).transpose(0, 1)
    assert s.is_contiguous()               # the view's own layout, unswapped
    np.testing.assert_array_equal(s.detach().numpy(), np.asarray(want_s))
    (got_g,) = torch.autograd.grad(s, ft, _t(g))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-6,
                               rtol=0)
    assert float(np.abs(np.asarray(want_g)).max()) > 0.1


def _recording(monkeypatch):
    """Wraps the two kernel wrappers to keep what the ops hand them."""
    seen = {"fwd": [], "bwd": []}
    fwd, bwd = lif_soma.lif_soma_fwd, lif_soma.lif_soma_bwd

    def rec_fwd(x, *a, **k):
        seen["fwd"].append(x)
        return fwd(x, *a, **k)

    def rec_bwd(g, *a, **k):
        seen["bwd"].append(g)
        return bwd(g, *a, **k)
    monkeypatch.setattr(lif_soma, "lif_soma_fwd", rec_fwd)
    monkeypatch.setattr(lif_soma, "lif_soma_bwd", rec_bwd)
    return seen


@pytest.mark.parametrize("stateful", [False, True])
def test_the_cuda_arm_hands_the_lm_view_to_the_kernels_without_a_copy(
        monkeypatch, stateful):
    """The (S, B, D) view of a (B, S, D) tensor reaches the SOMA kernel as
    it is (same storage, same strides), the spikes come back in its layout,
    and the model's (B, S, D) cotangent, swapped the same way, reaches GRAD
    as it is: no copy of the input or the cotangent."""
    seen = _recording(monkeypatch)
    rng = np.random.default_rng(9)
    f = _t(rng.normal(0.3, 1.2, (2, 9, 8)).astype(np.float32), grad=True)
    gy = _t(rng.normal(0, 1, (2, 9, 8)).astype(np.float32))
    view = f.transpose(0, 1)
    cfg = tlif.LIFConfig(policy=named_policy("cuda-full"))
    if stateful:
        z = torch.zeros(2, 8)
        s, _ = tlif.lif_scan_with_state(view, z, z, cfg)
    else:
        s = tlif.lif_scan(view, cfg)
    (x,) = seen["fwd"]
    assert x.data_ptr() == f.data_ptr() and x.stride() == view.stride()
    assert s.stride() == view.stride()
    torch.autograd.grad(s.transpose(0, 1), f, gy)
    (g,) = seen["bwd"]
    assert g.data_ptr() == gy.data_ptr() and g.stride() == view.stride()


def test_a_cotangent_of_another_layout_is_copied_into_us_layout(monkeypatch):
    """Where autograd hands GRAD a cotangent of another layout (here an
    expanded one, stride 0), ``ops`` copies it, explicitly, into U's."""
    seen = _recording(monkeypatch)
    x = _t(np.random.default_rng(2).normal(0.3, 1.2, (4, 3, 8)).astype(
        np.float32), grad=True)
    s = ops.lif_soma_op(x.transpose(0, 1))
    s.sum().backward()
    (g,) = seen["bwd"]
    assert g.stride() == s.stride() and lif_soma.same_layout(g, s)


def test_time_major_3d_folds_and_copies_only_what_it_must():
    x3 = torch.zeros(4, 6, 8).transpose(1, 2)       # D strided: copied
    got, shape = tlif._time_major_3d(x3)
    assert got.is_contiguous() and shape == (4, 8, 6)
    view = torch.zeros(6, 4, 8).transpose(0, 1)     # the LM's view: as is
    got, _ = tlif._time_major_3d(view)
    assert got.data_ptr() == view.data_ptr() and got.stride() == view.stride()
    x4 = torch.zeros(4, 2, 3, 8)                    # folded
    got, shape = tlif._time_major_3d(x4)
    assert got.shape == (4, 6, 8) and shape == (4, 2, 3, 8)


def test_plain_versions_keep_the_layout_and_check_the_state():
    view = torch.randn(5, 3, 8).transpose(0, 1)
    s, u, mask = lif_soma.lif_soma_fwd(view)
    assert s.stride() == u.stride() == mask.stride() == view.stride()
    g = torch.randn(5, 3, 8).transpose(0, 1)
    assert lif_soma.lif_soma_bwd(g, u, s, mask).stride() == g.stride()
    with pytest.raises(ValueError, match="both u0 and s0"):
        lif_soma.lif_soma_fwd(view, torch.zeros(5, 8))
    with pytest.raises(ValueError, match="u0 shape"):
        lif_soma.lif_soma_fwd(view, torch.zeros(4, 8), torch.zeros(4, 8))


def test_the_arm_rule_and_its_crossover():
    n, t = lif_soma.FLAT_MIN_N, lif_soma.FLAT_MAX_T
    assert lif_soma.choose_arm(t + 1, n, contiguous=True) == "flat"
    assert lif_soma.choose_arm(t + 1, n - 1, contiguous=True) == "ring"
    assert lif_soma.choose_arm(t, 8, contiguous=True) == "flat"
    assert lif_soma.choose_arm(256, 8 * 1024, contiguous=True) == "ring"
    assert lif_soma.choose_arm(t, n, contiguous=False) == "ring"
    assert lif_soma.choose_arm(t, n, contiguous=True, carry=True) == "ring"
    view = torch.zeros(4, 8, 16).transpose(0, 1)
    assert lif_soma.strides(view) == (16, 128)
    assert lif_soma.strides(torch.zeros(4, 1, 16)) == (16, 0)
    assert lif_soma.same_layout(view, torch.empty_like(view))
    assert not lif_soma.same_layout(view, view.contiguous())


def _sass(lines):
    return "\n".join(["\t\tFunction : _Z12lif_fwd_ringv"] + [
        f"        /*{16 * i:04x}*/                   {op} ;"
        f"   /* 0x000 */" for i, op in enumerate(lines)])


def test_sass_chain_counts_the_recursion_of_an_unrolled_walk():
    """``chip_smoke.sass_chain`` (the chain bound of the LIF cases): the
    longest path of dependent fp32 instructions in the block with the most
    stores, over the steps those stores make: 4 a SOMA step (FSET -> FADD
    -> FMUL -> FADD; the alpha * u product beside it)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    step = ["FSET.BF.GE.AND R5, R2, UR4, PT", "FADD R6, -R5, 1",
            "FMUL R7, R2.reuse, UR5", "FSETP.GEU.AND P0, PT, R2, UR6, PT",
            "FMUL R8, R7, R6", "FSEL R11, RZ, 1, !P0", "FADD R2, R8, R9",
            "STG.E desc[UR8][R12.64], R5", "STG.E desc[UR8][R14.64], R2",
            "IADD3 R12, P1, R12, UR9, RZ", "STG.E desc[UR8][R16.64], R11"]
    text = _sass(["MOV R2, RZ", "@!P2 BRA 0x40", "EXIT", "NOP"]
                 + step * 3 + ["BRA 0x0"] + step)
    (instrs,) = chip_smoke.sass_functions(text).values()
    got = chip_smoke.sass_chain(instrs, stores_per_step=3)
    assert got == {"steps": 3, "chain": 12, "per_step": 4}


def test_l2_cold_cycles_copies_of_the_operands_in_their_layout():
    """``chip_smoke.l2_cold`` (the LIF cases' cold device time): each call
    takes the next of ``ceil(4 * L2 / moved)`` copies, equal to the operands
    and in their layout (None stays None), and keeps its outputs until the
    copy comes round again."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    x = torch.randn(16, 5, 8).transpose(0, 1)
    u0 = torch.randn(16, 8)
    seen = []

    def call(a, b, c):
        seen.append((a, b, c))
        return torch.empty_like(a)
    fn = chip_smoke.l2_cold(call, (x, u0, None), chip_smoke.L2_BYTES // 3)
    for _ in range(2 * 13):
        fn()
    assert len({id(a) for a, _, _ in seen}) == 13     # just over 4 * 3
    assert seen[0][0] is x and seen[13][0] is x
    for a, b, c in seen:
        assert a.stride() == x.stride() and torch.equal(a, x)
        assert torch.equal(b, u0) and c is None
    kept = fn.__closure__[[v for v in fn.__code__.co_freevars].index(
        "kept")].cell_contents
    assert len(kept) == 13 and all(o.shape == x.shape for o in kept)
