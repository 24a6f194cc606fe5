"""Tests for the port's signature guards (``repro_torch.analysis.tracing``),
the counterparts of ``test_analysis_tracing.py``: the guard itself (per
callable and process-wide) and the two hot paths it protects, the vision
train step and the serving engine's step, each seeing one input signature
over several steps."""
import pytest
import torch

from _torch_port import single_thread

from repro_torch.analysis.tracing import (assert_signature_count,
                                          build_counter, signature_count,
                                          signature_of, track_signatures)

single_thread()


def test_signature_count_counts_distinct_input_signatures():
    f = track_signatures(lambda x: x * 2)
    assert signature_count(f) == 0
    f(torch.ones(2))
    f(torch.ones(2))
    assert signature_count(f) == 1
    f(torch.ones(3))
    assert signature_count(f) == 2
    f(torch.ones(3, dtype=torch.float64))
    assert signature_count(f) == 3
    f(torch.ones(3, 2).t())          # same shape as (2, 3), other strides
    f(torch.ones(2, 3))
    assert signature_count(f) == 5
    assert signature_count(lambda x: x) is None


def test_signature_covers_every_tensor_leaf_of_nested_args():
    a = {"w": torch.ones(2, 3), "b": [torch.zeros(4), 7]}
    sig = signature_of(a, torch.ones(5))
    assert len(sig) == 3
    assert sig[0] == ((4,), torch.float32, torch.device("cpu"), (1,))
    assert signature_of({"b": [torch.zeros(4)], "w": torch.ones(2, 3)},
                        torch.ones(5)) == \
        signature_of({"w": torch.ones(2, 3), "b": [torch.zeros(4)]},
                     torch.ones(5))


def test_guard_passes_on_a_single_signature():
    f = track_signatures(lambda x: x + 1)
    with assert_signature_count(1, f):
        for _ in range(3):
            f(torch.ones(4))


def test_guard_fails_on_a_varying_shape():
    f = track_signatures(lambda x: x + 1)
    with pytest.raises(AssertionError, match="vary per call"):
        with assert_signature_count(1, f):
            f(torch.ones(4))
            f(torch.ones(5))   # a new shape: a second signature


def test_guard_at_most_allows_fewer():
    f = track_signatures(lambda x: x - 1)
    with assert_signature_count(2, f, exact=False):
        f(torch.ones(4))


def test_guard_refuses_an_untracked_callable():
    with pytest.raises(TypeError, match="track_signatures"):
        with assert_signature_count(1, lambda x: x):
            pass


def test_process_wide_form_counts_kernel_library_builds(monkeypatch):
    """With no callables the guard counts ``build.load`` compiles; none
    happen on the CPU, and a compile in the block is counted."""
    from repro_torch.kernels import build

    with assert_signature_count(0):
        torch.ones(3) * 2
    with pytest.raises(AssertionError, match="kernel-library build"):
        with assert_signature_count(0):
            monkeypatch.setattr(build, "compiles", build.compiles + 1)
    with build_counter() as count:
        monkeypatch.setattr(build, "compiles", build.compiles + 2)
        assert count() == 2


def test_train_step_sees_one_signature():
    """``make_train_step``'s product sees one input signature across
    same-shape steps (the weights, state and optimizer state keep their
    shapes and layouts), and builds nothing."""
    from repro_torch.configs.spikingformer import get_spikingformer_config
    from repro_torch.core.policy import named_policy
    from repro_torch.core.spikingformer import init_spikingformer
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

    cfg = get_spikingformer_config("spikingformer-smoke",
                                   policy=named_policy("eager"))
    params, state = init_spikingformer(torch.Generator().manual_seed(0),
                                       cfg, device="cpu")
    step = track_signatures(make_train_step(
        cfg, OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=4)))
    opt_state = init_opt_state(params)
    images = torch.zeros((2, cfg.image_size, cfg.image_size, 3))
    labels = torch.arange(2) % cfg.num_classes
    with assert_signature_count(1, step), assert_signature_count(0):
        for _ in range(2):
            params, state, opt_state, _ = step(params, state, opt_state,
                                               images, labels)


def test_serving_engine_step_sees_one_signature():
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.models.common import split_tree
    from repro_torch.models.lm import init_lm
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = reduced(get_config("qwen3-0.6b"))
    params = split_tree(init_lm(torch.Generator().manual_seed(0), cfg,
                                device="cpu"))[0]
    engine = ServingEngine(params, cfg, slots=2, max_seq=32, device="cpu")
    engine._step = track_signatures(engine._step)
    assert engine.submit(Request(uid=0, prompt=[3, 1, 2], max_new_tokens=4))
    assert engine.submit(Request(uid=1, prompt=[5], max_new_tokens=3))
    with assert_signature_count(1, engine._step), assert_signature_count(0):
        done = engine.run_to_completion()
    assert sorted(r.uid for r in done) == [0, 1]
    assert engine.step_count > 1
    assert engine.step_signature is not None
