"""The bf16 eval-mode neuron layer on the wgmma mainloop, on the CPU: the
rule that sends a packed bf16 eval call to the wgmma kernel
(``neuron_layer.eval_kernel``, the spike matmul's rule on the rows of one
time step), the calls it leaves on the ``mma.sync`` arm, the ``meta``
branch, and the bf16 plain version against the reference's Pallas kernel in
interpret mode at T = 1, 4 and 8 with more than 512 rows a step.

The kernel runs only on the card: ``tests/test_torch_cuda.py`` holds it
against its plain version there, and ``chip_smoke.py`` at the model's
shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import single_thread
from repro.kernels import neuron_layer as jnl
from repro_torch.analysis import contracts
from repro_torch.kernels import neuron_layer as nl
from repro_torch.kernels import ref
from repro_torch.kernels import spike_matmul as sm

single_thread()
BF16 = torch.bfloat16

#: The packed eval sites of ``spikingformer-8-512`` at a batch of 16:
#: (T, M rows a step, C, K).
PACKED_SITES = {
    "pssa.qkv": (4, 3136, 512, 512),
    "smlp.a": (4, 3136, 512, 2048),
    "tokenizer.conv.1": (4, 50176, 576, 128),
    "tokenizer.conv.2": (4, 12544, 1152, 256),
    "tokenizer.conv.3": (4, 3136, 2304, 512),
}


def _w(c, k, dtype=BF16, device="cpu"):
    return torch.zeros((c, k), dtype=dtype, device=device)


# --- the rule ---------------------------------------------------------------

@pytest.mark.parametrize("site", sorted(PACKED_SITES))
@pytest.mark.parametrize("dtype,want", [(BF16, nl.EVAL_TILE_WGMMA),
                                        (torch.float32, 0)])
def test_the_packed_sites_take_the_wgmma_kernel_at_bf16(site, dtype, want):
    """At every packed eval site of the preset a bf16 weight takes the
    wgmma kernel (tile code 3), exactly where the spike matmul's rule sends
    the step's product to its own; an fp32 weight never does."""
    t, m, c, k = PACKED_SITES[site]
    w = _w(c, k, dtype)
    assert nl.eval_kernel(m, w) == want
    assert (sm.resolve_tile(m, w[None, None]) == sm.WGMMA) == bool(want)


@pytest.mark.parametrize("m,c,k,want", [
    (513, 64, 64, nl.EVAL_TILE_WGMMA),
    (512, 512, 512, 0),           # 512 rows a step or fewer
    (196, 512, 512, 0),
    (3136, 512, 100, 0),          # K % 8 != 0: no TMA box for the weight
    (1200, 256, 200, nl.EVAL_TILE_WGMMA),   # K % 128 != 0
    (700, 520, 136, nl.EVAL_TILE_WGMMA),    # rows of 65 bytes: byte copies
])
def test_the_rule_counts_the_rows_of_one_step(m, c, k, want):
    """The rule reads M, the rows of one time step (the kernel's unit walks
    the T steps of its rows), not T * M: 512 rows a step keep the
    one-plane arm whatever T is."""
    assert nl.eval_kernel(m, _w(c, k)) == want


def test_a_weight_off_16_byte_alignment_keeps_the_one_plane_arm():
    w = torch.zeros(512 * 512 + 1, dtype=BF16)[1:].view(512, 512)
    assert w.data_ptr() % 16 != 0
    assert nl.eval_kernel(3136, w) == 0
    assert nl.eval_kernel(3136, w.clone()) == nl.EVAL_TILE_WGMMA


def test_the_plan_kernel_codes_mirror_the_cuda_enum():
    """``EVAL_WGMMA`` is the index of its name in ``enum Kernel`` of
    ``csrc/neuron_layer.cu``, appended after ``Z_WGMMA``; the entry point
    takes tile codes 0 to 3, 3 the wgmma kernel."""
    import re

    from repro_torch.kernels import build
    src = (build.CSRC / "neuron_layer.cu").read_text()
    names = [n.strip() for n in re.search(r"enum Kernel \{([^}]*)\}",
                                          src).group(1).split(",")]
    assert names.index("EVAL_WGMMA") == nl.EVAL_WGMMA == len(names) - 1
    assert names.index("Z_WGMMA") == nl.Z_WGMMA == nl.EVAL_WGMMA - 1
    assert "tile < 0 || tile > 3" in src
    assert f"if (tile == {nl.EVAL_TILE_WGMMA}) {{" in src


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("packed", [True, False])
def test_the_meta_branch_is_unchanged(monkeypatch, dtype, packed):
    """On ``meta`` the wrapper allocates the spikes (T, M, K) in x's dtype
    and reports the site, as before: it consults no rule and launches
    nothing."""
    def refuse(*args, **kw):
        raise AssertionError("the meta branch consulted the rule")
    monkeypatch.setattr(nl, "eval_kernel", refuse)
    x = torch.empty((4, 3136, 512), dtype=dtype, device="meta")
    s = nl.neuron_layer_eval(x, _w(512, 2048, dtype, "meta"),
                             torch.empty(2048, device="meta"), packed=packed)
    assert s.is_meta and s.shape == (4, 3136, 2048) and s.dtype == dtype


# --- the plain version against the reference at bf16 -----------------------

def _t16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(BF16)


def _operands(t, m, c, k, seed, exact):
    rng = np.random.default_rng(seed)
    x = (rng.random((t, m, c)) < 0.25).astype(np.float32)
    if exact:   # k / 64, |k| <= 4: every fp32 sum exact
        w = rng.integers(-4, 5, (c, k)) / 64.0
    else:
        w = rng.normal(size=(c, k)) * 2.0 / c ** 0.5
    bias = (rng.normal(size=k) * 0.1 + 0.9).astype(np.float32)
    return (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
            jnp.asarray(bias))


def _targs(x, w, bias):
    return (_t16(x), _t16(w), torch.from_numpy(np.array(bias)))


@pytest.mark.parametrize("t,m,c,k", [(1, 600, 64, 48), (4, 520, 128, 136),
                                     (8, 513, 64, 24)])
def test_the_bf16_plain_version_against_the_reference(t, m, c, k):
    """At more than 512 rows a step (where the card runs the wgmma kernel)
    and T = 1, 4, 8: on exact operands the plain version's spikes (and the
    oracle's) are the reference Pallas kernel's (interpret mode) bit for
    bit, packed and dense; on Gaussian weights the plain version's spikes
    are the oracle's outside the band around the threshold
    (``spike_verdict``, the product's tolerance carried to the threshold),
    and the reference's are too."""
    assert nl.eval_kernel(m, _w(c, k)) == nl.EVAL_TILE_WGMMA
    x, w, bias = _operands(t, m, c, k, 36 + t, exact=True)
    targs = _targs(x, w, bias)
    for packed in (True, False):
        want = jnl.neuron_layer_eval(x, w, bias, packed=packed)
        assert want.dtype == jnp.bfloat16
        want = np.asarray(want).astype(np.float32)
        for got in (nl.neuron_layer_eval(*targs, packed=packed),
                    nl.neuron_layer_eval_plain(*targs),
                    ref.neuron_layer_eval_ref(*targs)):
            assert got.dtype == BF16
            np.testing.assert_array_equal(got.float().numpy(), want)
    assert 0.01 < float(want.mean()) < 0.99
    x, w, bias = _operands(t, m, c, k, 52 + t, exact=False)
    targs = _targs(x, w, bias)
    y, tol = contracts._nl_current("neuron_layer_eval", targs)
    jax_s = torch.from_numpy(np.asarray(jnl.neuron_layer_eval(
        x, w, bias, packed=True)).astype(np.float32))
    for got in (nl.neuron_layer_eval_plain(*targs), jax_s):
        v = contracts.spike_verdict(got, y, tol)
        assert v["wrong"] == 0, v
