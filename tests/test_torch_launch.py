"""The port's training driver (``repro_torch.launch.train``) and its
resilience helpers, on the CPU.

The LM path through ``main`` (the reference's flags plus ``--device cpu``)
and, for the spiking LM, through ``train``: finite losses that fall. A run
stopped by SIGTERM saves and exits; restarted, it resumes at the saved
step with bit-equal parameters (the LM path saves the parameters only, as
the reference does); the vision path saves parameters, BN state and
optimizer state, so a stopped and resumed run ends bit-equal to one that
ran through. ``_resolve_config`` refuses what the reference refuses, with
its messages. The non-finite budget, the final-save timeout, the
preemption guard's handler and the straggler monitor (on an injected
clock, never wall time) behave as the reference's.
"""
import argparse
import os
import signal
import threading

import numpy as np
import pytest
import torch

from _torch_port import single_thread

from repro.launch import train as jtrain
from repro_torch.configs import get_spikingformer_config
from repro_torch.configs.registry import get_config, reduced
from repro_torch.core.lif import LIFConfig
from repro_torch.core.policy import named_policy
from repro_torch.core.spikingformer import tree_leaves
from repro_torch.launch import train as ttrain
from repro_torch.train import checkpoint as tck
from repro_torch.train.resilience import (NonFiniteBudgetExceeded,
                                          NonFiniteGuard, PreemptionGuard,
                                          StragglerMonitor)

single_thread()
LM = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu"]


def _losses(out: str) -> list[float]:
    return [float(line.split()[3]) for line in out.splitlines()
            if line.startswith("step ")]


@pytest.mark.parametrize("microbatches", ["1", "2"])
def test_main_trains_the_reduced_lm_on_the_cpu(microbatches, capsys):
    """The reference's defaults (batch 8 x seq 128, lr 3e-4, warm-up 5):
    twenty steps, every loss finite, the last below the first."""
    ttrain.main(LM + ["--steps", "20", "--microbatches", microbatches])
    out = capsys.readouterr().out
    losses = _losses(out)
    assert len(losses) == 3                    # steps 0, 10 and 19 logged
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert "final loss" in out and "[guard]" not in out


@pytest.mark.parametrize("policy", ["eager", "cuda"])
def test_train_takes_spiking_lm_steps(policy):
    """The spiking LM (the LIF on every FFN branch) through ``train``: the
    kernels' plain versions under ``cuda``, the eager scan under ``eager``,
    the same losses bit for bit."""
    cfg = reduced(get_config("qwen3-0.6b")).replace(
        lif=LIFConfig(policy=named_policy(policy)), remat=True)
    _, history = ttrain.train(cfg, steps=12, global_batch=4, seq_len=32,
                              device="cpu", log_every=100)
    assert len(history) == 12 and all(np.isfinite(history))
    assert np.mean(history[-4:]) < np.mean(history[:4])
    want = ttrain.train(cfg.replace(lif=LIFConfig()), steps=2,
                        global_batch=4, seq_len=32, device="cpu",
                        log_every=100)[1]
    assert history[:2] == want


def _sigterm_at(step_to_stop: int):
    def on_step(step, metrics):
        if step == step_to_stop:
            os.kill(os.getpid(), signal.SIGTERM)
    return on_step


def test_a_stopped_lm_run_resumes_at_the_saved_step(tmp_path, capsys):
    """SIGTERM during step 2: the driver saves step 3 and exits. A restart
    finds it, resumes at step 3 with the saved parameters bit for bit, and
    takes the remaining steps. SIGTERM's handler is back afterwards."""
    cfg = reduced(get_config("qwen3-0.6b"))
    d = str(tmp_path)
    before = signal.getsignal(signal.SIGTERM)
    stopped, history = ttrain.train(cfg, steps=6, global_batch=4,
                                    seq_len=16, ckpt_dir=d, device="cpu",
                                    on_step=_sigterm_at(2))
    assert signal.getsignal(signal.SIGTERM) == before
    assert len(history) == 3 and tck.retained_steps(d) == [3]
    assert "[preempt] checkpoint saved" in capsys.readouterr().out
    resumed, none = ttrain.train(cfg, steps=3, global_batch=4, seq_len=16,
                                 ckpt_dir=d, device="cpu")
    assert none == []
    assert "[restore] step 3" in capsys.readouterr().out
    for a, b in zip(tree_leaves(resumed), tree_leaves(stopped)):
        assert torch.equal(a, b)
    _, rest = ttrain.train(cfg, steps=5, global_batch=4, seq_len=16,
                           ckpt_dir=d, device="cpu")
    assert len(rest) == 2 and all(np.isfinite(rest))


def test_a_stopped_vision_run_ends_where_an_unbroken_one_does(tmp_path):
    """The vision path checkpoints parameters, BN state and optimizer
    state: stopped after step 1 and resumed, three steps end bit-equal to
    three steps run through."""
    cfg = get_spikingformer_config("spikingformer-smoke@cuda-full")
    kw = dict(steps=3, global_batch=2, device="cpu", log_every=100)
    whole, _ = ttrain.train(cfg, ckpt_dir=None, **kw)
    d = str(tmp_path)
    ttrain.train(cfg, ckpt_dir=d, on_step=_sigterm_at(1), **kw)
    assert tck.retained_steps(d) == [2]
    resumed, history = ttrain.train(cfg, ckpt_dir=d, **kw)
    assert len(history) == 1
    for a, b in zip(tree_leaves(resumed), tree_leaves(whole)):
        assert torch.equal(a, b)


def _args(**kw):
    base = dict(arch="qwen3-0.6b", reduced=False, data_vocab=None, seq=None,
                policy=None, time_chunk=None)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("kw", [
    dict(arch="no-such-arch"),
    dict(arch="spikingformer-smoke", reduced=True),
    dict(arch="spikingformer-smoke", seq=64),
    dict(arch="spikingformer-smoke", data_vocab=100),
    dict(policy="eager"),
    dict(time_chunk=2),
])
def test_resolve_config_refuses_what_the_reference_refuses(kw):
    with pytest.raises(SystemExit) as got:
        ttrain._resolve_config(_args(**kw))
    with pytest.raises(SystemExit) as want:
        jtrain._resolve_config(_args(**kw))
    assert str(got.value) == str(want.value)


def test_resolve_config_routes_lm_and_vision_names():
    cfg = ttrain._resolve_config(_args(reduced=True))
    assert cfg == reduced(get_config("qwen3-0.6b"))
    vis = ttrain._resolve_config(_args(arch="spikingformer-smoke@cuda-full",
                                       time_chunk=2))
    assert vis.family == "vision" and vis.time_chunk == 2
    assert vis.policy == named_policy("cuda-full")
    vis = ttrain._resolve_config(_args(arch="spikingformer-smoke",
                                       policy="cuda"))
    assert vis.policy == named_policy("cuda")


def test_fault_injection_is_refused(monkeypatch):
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        ttrain.main(LM + ["--chaos-schedule", "{}"])
    monkeypatch.setenv("CHAOS_SCHEDULE", "{}")
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        ttrain.main(LM)


def test_nonfinite_guard_budget():
    guard = NonFiniteGuard(budget=2)
    assert guard.observe(True, 0) and guard.observe(True, 1)
    assert not guard.observe(False, 2)          # a finite step resets it
    assert guard.observe(True, 3) and guard.observe(True, 4)
    with pytest.raises(NonFiniteBudgetExceeded, match="budget 2"):
        guard.observe(True, 5)
    assert guard.total == 5 and guard.skipped_steps == [0, 1, 3, 4, 5]


def test_the_driver_stops_a_run_whose_every_step_is_skipped(capsys):
    seen = []

    def step_once(step):
        seen.append(step)
        return {"loss": torch.tensor(float("nan")), "nonfinite": 1.0}
    with pytest.raises(NonFiniteBudgetExceeded):
        ttrain._drive(start=0, steps=10, step_once=step_once, save=None,
                      log_line=lambda s, m: f"step {s}", log_every=1,
                      ckpt_every=100, ckpt_dir=None, nonfinite_budget=3)
    assert seen == [0, 1, 2, 3]
    assert capsys.readouterr().out.count("[guard]") == 3


def test_a_final_save_that_does_not_finish_raises():
    release = threading.Event()

    def save(step):
        t = threading.Thread(target=release.wait, args=(30,), daemon=True)
        t.start()
        return t
    try:
        with pytest.raises(tck.CheckpointWriteTimeout):
            ttrain._drive(start=0, steps=2, step_once=lambda s: {
                "loss": torch.tensor(1.0)}, save=save,
                log_line=lambda s, m: "", log_every=1, ckpt_every=1,
                ckpt_dir="unused", final_join_timeout=0.01)
    finally:
        release.set()


def test_preemption_guard_sets_its_flag_and_puts_the_handler_back():
    before = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard().install()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before


def test_straggler_monitor_on_an_injected_clock():
    """Eight one-second steps fill the window; a three-second step is then
    flagged against their median, a 1.5-second one is not."""
    now = [0.0]
    calls = []
    mon = StragglerMonitor(threshold=2.0, clock=lambda: now[0],
                           on_straggler=lambda dt, med: calls.append(
                               (dt, med)))

    def step(seconds):
        mon.step_start()
        now[0] += seconds
        return mon.step_end()
    assert not any(step(1.0) for _ in range(8))
    assert step(3.0) and calls == [(3.0, 1.0)]
    assert not step(1.5)
    assert mon.flagged == [9] and mon.durations[-2:] == [3.0, 1.5]
    assert mon.median == 1.0
