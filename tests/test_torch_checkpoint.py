"""The port's checkpoints against the JAX package's format, on the CPU.

A checkpoint written by either package restores bit-equal in the other:
the LM's parameters with their partition specs, and the Spikingformer's
parameters, BN state and AdamW state (list nodes, an int32 step). Both
writers produce the same ``index.json`` and the same ``.npy`` bytes. A
bfloat16 leaf is written as the reference writes it (``<V2`` raw bytes,
``"bfloat16"`` in the index); the port restores such a leaf, which the
reference's own restore refuses (``jnp.asarray`` of a void array).

Then the integrity and publication machinery: a flipped byte is caught by
``verify_checkpoint`` and ``restore_checkpoint`` and skipped by
``restore_latest_good``, retention keeps three steps, dead ``.tmp``
directories are swept, and an asynchronous save writes the host copy it
took before its thread started.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import lm_cfgs, np_tree, single_thread

from repro.configs.spikingformer import SPIKINGFORMER_PRESETS as JAX_PRESETS
from repro.core.spikingformer import init_spikingformer as jinit_sf
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro_torch.convert import from_jax, lm_from_jax, opt_state_from_jax
from repro_torch.core.spikingformer import tree_leaves
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.train import checkpoint as tck

single_thread()


def _lm_trees():
    """(reference params, reference specs, port params, port specs) of
    reduced qwen3-0.6b with the LIF, the port's from the same numbers."""
    jcfg, tcfg = lm_cfgs("qwen3-0.6b", "jnp")
    jp, jspecs = jcommon.split_tree(jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    tspecs = tcommon.split_tree(
        tlm.init_lm(torch.Generator().manual_seed(0), tcfg, "cpu"))[1]
    return jp, jspecs, lm_from_jax(np_tree(jp), device="cpu"), tspecs


def _vision_trees():
    """The vision driver's tree {"params", "state", "opt"} in each package
    (the reference's AdamW state carries "err": None, which flattens to
    nothing), with a step counter that is not 0."""
    jp, js = jinit_sf(jax.random.PRNGKey(1), JAX_PRESETS["spikingformer-smoke"])
    jo = dict(jopt.init_opt_state(jp), step=jnp.asarray(7, jnp.int32))
    jo["m"] = jax.tree.map(lambda a: a + 0.25, jo["m"])
    tp, ts = from_jax(np_tree(jp), np_tree(js), device="cpu")
    to = opt_state_from_jax(np_tree(jo), device="cpu")
    return ({"params": jp, "state": js, "opt": jo}, None,
            {"params": tp, "state": ts, "opt": to}, None)


TREES = {"lm": _lm_trees, "vision": _vision_trees}


def _bits_equal(got, want):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype
        assert a.numpy().tobytes() == b.tobytes()


def _dir_bytes(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("kind", sorted(TREES))
def test_a_checkpoint_of_either_package_restores_bit_equal_in_the_other(
        kind, tmp_path):
    jtree, jspecs, ttree, tspecs = TREES[kind]()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_checkpoint(jdir, 12, jtree, jspecs)
    tck.save_checkpoint(tdir, 12, ttree, tspecs)
    # one format: the same index (leaves, CRCs, specs) and the same bytes
    jstep, tstep = (os.path.join(d, "step_00000012") for d in (jdir, tdir))
    jindex, tindex = (json.load(open(os.path.join(d, "index.json")))
                      for d in (jstep, tstep))
    assert tindex == jindex
    assert jindex["specs"] or kind == "vision"
    assert _dir_bytes(tstep) == _dir_bytes(jstep)
    assert tck.latest_step(jdir) == tck.retained_steps(jdir)[-1] == 12
    assert tck.verify_checkpoint(jdir, 12) == []
    # the reference's checkpoint restores in the port ...
    restored = tck.restore_checkpoint(jdir, 12, ttree)
    _bits_equal(restored, jtree)
    assert all(a.device == torch.device("cpu")
               for a in tree_leaves(restored))
    # ... and the port's in the reference
    _bits_equal(ttree, jck.restore_checkpoint(tdir, 12, jtree))


def test_bfloat16_leaves_are_written_as_the_reference_writes_them(tmp_path):
    rng = np.random.default_rng(0)
    vals = rng.normal(0, 3, (5, 7)).astype(np.float32)
    jtree = {"w": jnp.asarray(vals, jnp.bfloat16), "n": jnp.asarray([1, 2])}
    ttree = {"w": torch.from_numpy(vals).to(torch.bfloat16),
             "n": torch.tensor([1, 2], dtype=torch.int32)}
    jck.save_checkpoint(str(tmp_path / "jax"), 1, jtree)
    tck.save_checkpoint(str(tmp_path / "port"), 1, ttree)
    jstep, tstep = (str(tmp_path / d / "step_00000001")
                    for d in ("jax", "port"))
    assert _dir_bytes(tstep) == _dir_bytes(jstep)
    assert json.load(open(os.path.join(tstep, "index.json")))[
        "leaves"]["w"]["dtype"] == "bfloat16"
    for d in ("jax", "port"):
        got = tck.restore_checkpoint(str(tmp_path / d), 1, ttree)
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16),
                           ttree["w"].view(torch.int16))
        assert torch.equal(got["n"], ttree["n"])


def _small_tree(v: float):
    return {"a": torch.full((3, 4), v), "b": [torch.arange(5) + int(v)],
            "step": torch.tensor(int(v), dtype=torch.int32)}


def test_a_flipped_byte_is_caught_and_skipped(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3):
        tck.save_checkpoint(d, step, _small_tree(float(step)))
    leaf = os.path.join(d, "step_00000003", "a.npy")
    raw = bytearray(open(leaf, "rb").read())
    raw[-1] ^= 0x01
    open(leaf, "wb").write(bytes(raw))
    assert tck.verify_checkpoint(d, 3) == ["a"]
    assert tck.verify_checkpoint(d, 2) == []
    with pytest.raises(tck.CheckpointCorruptError, match="CRC mismatch"):
        tck.restore_checkpoint(d, 3, _small_tree(0.0))
    with pytest.warns(RuntimeWarning, match="step 3"):
        step, tree = tck.restore_latest_good(d, _small_tree(0.0))
    assert step == 2
    assert torch.equal(tree["a"], _small_tree(2.0)["a"])
    assert torch.equal(tree["b"][0], _small_tree(2.0)["b"][0])
    # a step without its index verifies bad and is skipped too
    os.remove(os.path.join(d, "step_00000002", "index.json"))
    assert tck.verify_checkpoint(d, 2) == ["index.json"]
    with pytest.warns(RuntimeWarning):
        assert tck.restore_latest_good(d, _small_tree(0.0))[0] == 1


def test_retention_keeps_three_and_tmp_directories_are_swept(tmp_path):
    d = str(tmp_path)
    assert tck.latest_step(d + "/none") is None
    assert tck.restore_latest_good(d + "/none", _small_tree(0.0)) == \
        (None, None)
    for step in range(1, 6):
        tck.save_checkpoint(d, step, _small_tree(float(step)))
    assert tck.retained_steps(d) == [3, 4, 5]
    os.makedirs(os.path.join(d, "step_00000009.tmp"))      # a dead writer
    assert tck.latest_step(d) == 5
    step, tree = tck.restore_latest_good(d, _small_tree(0.0))
    assert step == 5 and int(tree["step"]) == 5
    assert not os.path.exists(os.path.join(d, "step_00000009.tmp"))
    assert sorted(os.listdir(d)) == [f"step_{s:08d}" for s in (3, 4, 5)]


def test_an_async_save_writes_the_copy_taken_before_it_returned(tmp_path):
    d = str(tmp_path)
    tree = _small_tree(1.0)
    writer = tck.save_checkpoint(d, 4, tree, async_save=True)
    tree["a"].add_(100.0)                # the caller's next step, in place
    writer.join(timeout=30)
    assert not writer.is_alive()
    got = tck.restore_checkpoint(d, 4, tree)
    assert torch.equal(got["a"], _small_tree(1.0)["a"])
    assert tck.save_checkpoint(d, 5, tree) is None       # synchronous
    assert tck.retained_steps(d) == [4, 5]
