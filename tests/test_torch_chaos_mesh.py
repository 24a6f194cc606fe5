"""The ``chaos.ckpt`` read fault on a mesh: gloo ranks on the CPU, spawned
once for the module (``_torch_dist_worker.py``, a world of 2).

Under a launcher every rank activates the same schedule and restores the
same shared checkpoint. The read hook must damage the file once (rank 0
alone), and the ranks must agree on each step's outcome, so that every
rank resumes the same step. Three steps are retained; a ``corrupt`` and a
``truncate`` read fault each hit the newest. Each must leave both ranks on
the previous step with its leaves bit-equal to what that step saved, and
the victim file one byte off its pristine copy (corrupt) or half its size
(truncate).
"""
import os
import pickle

import pytest

import _torch_dist_worker as W

WORLD = 2
JOBS = ["ckpt_read_corrupt", "ckpt_read_truncate"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("chaos_mesh"))
    path = os.path.join(out, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump({}, f)
    W.spawn(WORLD, out, JOBS, path, timeout=120.0)
    return out


def _result(runs, action):
    return W.result(runs, f"ckpt_read_{action}", WORLD)


@pytest.mark.parametrize("action", ["corrupt", "truncate"])
def test_every_rank_resumes_the_previous_step_with_its_leaves(runs, action):
    res = _result(runs, action)
    previous = W.READ_FAULT_STEPS[-2]
    assert [r["step"] for r in res["ranks"]] == [previous] * WORLD, res
    assert all(r["equal"] for r in res["ranks"]), res


@pytest.mark.parametrize("action", ["corrupt", "truncate"])
def test_the_fault_fires_once_on_rank_0(runs, action):
    res = _result(runs, action)
    newest = W.READ_FAULT_STEPS[-1]
    events = [r["events"] for r in res["ranks"]]
    assert len(events[0]) == 1 and events[0][0].startswith(
        f"chaos.ckpt@{newest}:{action} file="), events
    assert all(e == [] for e in events[1:]), events


def test_a_corrupt_read_flips_one_byte_of_the_victim(runs):
    res = _result(runs, "corrupt")
    assert res["size"] == res["pristine_size"]
    assert res["bytes_differing"] == 1, res


def test_a_truncate_read_halves_the_victim(runs):
    res = _result(runs, "truncate")
    assert res["size"] == res["pristine_size"] // 2, res
