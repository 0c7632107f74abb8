"""The port's fault-tolerant loop: the reference's
``tests/test_train_loop.py`` on ``repro_torch.train`` (reduced
qwen3-4b, CPU): an interrupted run resumes exactly, preemption saves and
stops (a SIGINT too, the handlers put back after the run), the NaN
guard aborts after the writer has landed, the loss falls
over 30 steps, and a slow step is logged as a straggler."""

import signal
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.models.model import build
from repro_torch.optim.adamw import AdamWConfig, leaves
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.step import init_train_state, make_train_step


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small ops: with torch's intra-op threads one per core
    in every test worker, they wait on each other's spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(tmp_path, total_steps=6, save_every=2, arch="qwen3-4b"):
    cfg = reduced(get_config(arch))
    model = build(cfg)
    step = make_train_step(model, AdamWConfig(lr=1e-3, total_steps=100))
    ds = SyntheticDataset(cfg, 16, 4, seed=0, n_shards=2)
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    loop = TrainLoop(step, ds, ckpt,
                     LoopConfig(total_steps=total_steps,
                                save_every=save_every))
    return model, loop, ckpt


def _state(model, seed):
    return init_train_state(model, torch.Generator().manual_seed(seed),
                            device="cpu")


def test_restart_resumes_exactly(tmp_path):
    """Train 6 straight vs train 4 + crash + resume: identical losses
    AND identical final params (counter-based data + checkpointed
    state)."""
    model, loop, _ = _setup(tmp_path / "a", total_steps=6)
    final_a, res_a = loop.run(_state(model, 0))

    model, loop1, _ = _setup(tmp_path / "b", total_steps=4)
    _, res_b1 = loop1.run(_state(model, 0))
    model, loop2, _ = _setup(tmp_path / "b", total_steps=6)
    # fresh (different) init: must be overwritten by the checkpoint
    final_b, res_b2 = loop2.run(_state(model, 9))

    np.testing.assert_allclose(res_a.losses[:4], res_b1.losses, rtol=1e-6)
    np.testing.assert_allclose(res_a.losses[4:], res_b2.losses, rtol=1e-6)
    for la, lb in zip(leaves(final_a["params"]), leaves(final_b["params"])):
        np.testing.assert_allclose(la.float().numpy(), lb.float().numpy(),
                                   atol=1e-6)
    assert int(final_b["opt"]["step"]) == 6


def test_preemption_saves_and_stops(tmp_path):
    model, loop, ckpt = _setup(tmp_path, total_steps=50, save_every=100)
    loop.on_step = lambda step, loss: (
        loop.request_preempt() if step == 3 else None)
    _, res = loop.run(_state(model, 0))
    assert res.preempted and res.final_step == 3
    assert ckpt.latest_step() == 3


def test_signal_preempts_and_handlers_come_back(tmp_path):
    """With ``handle_signals`` a SIGINT saves and stops at the step's
    end, and the handlers the run replaced are back after it."""
    model, loop, ckpt = _setup(tmp_path, total_steps=50, save_every=100)
    loop.cfg.handle_signals = True
    before = signal.getsignal(signal.SIGINT), signal.getsignal(
        signal.SIGTERM)
    loop.on_step = lambda step, loss: (
        signal.raise_signal(signal.SIGINT) if step == 2 else None)
    _, res = loop.run(_state(model, 0))
    assert res.preempted and res.final_step == 2
    assert ckpt.latest_step() == 2
    assert (signal.getsignal(signal.SIGINT),
            signal.getsignal(signal.SIGTERM)) == before


def test_nan_guard_aborts(tmp_path):
    model, loop, _ = _setup(tmp_path, total_steps=5)
    loop.step_fn = lambda state, batch: (
        state, {"loss": torch.tensor(float("nan")),
                "grad_norm": torch.tensor(0.0)})
    with pytest.raises(FloatingPointError):
        loop.run(_state(model, 0))


@pytest.mark.slow   # wall-clock-timing heuristic, not correctness
def test_straggler_detection(tmp_path):
    model, loop, _ = _setup(tmp_path, total_steps=8, save_every=100)
    loop.cfg.straggler_factor = 2.0
    real_step = loop.step_fn
    state0 = _state(model, 0)
    calls = {"n": 0}

    def slow_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 6:
            time.sleep(1.0)      # inject a straggler
        return real_step(state, batch)

    loop.step_fn = slow_step
    _, res = loop.run(state0)
    assert any(e["step"] == 5 for e in res.straggler_events), \
        res.straggler_events


def test_loss_decreases_over_training(tmp_path):
    model, loop, _ = _setup(tmp_path, total_steps=30, save_every=100)
    _, res = loop.run(_state(model, 0))
    first = np.mean(res.losses[:5])
    last = np.mean(res.losses[-5:])
    assert last < first, (first, last)
