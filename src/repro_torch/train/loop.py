"""Fault-tolerant training loop (the JAX package's ``train/loop.py``).

Responsibilities beyond "call train_step in a loop":

* **checkpoint/restart** — resumes from the newest checkpoint, restored
  onto the state's device; saves every ``save_every`` steps and at the
  end through the async CheckpointManager.
* **preemption handling** — SIGTERM/SIGINT installs a save-and-exit flag;
  the loop checkpoints at the next step boundary.
* **straggler/step-time monitoring** — EWMA of step wall time; a step
  slower than ``straggler_factor``× the EWMA is logged as a straggler
  event.
* **data determinism** — batches come from the counter-based synthetic
  pipeline keyed by (seed, step), so a restart replays the identical
  stream with no data-state in the checkpoint.
* **NaN guard** — a non-finite loss aborts with a diagnostic rather than
  silently corrupting later checkpoints.

The step's ``float(metrics["loss"])`` is the loop's one read from the
device a step.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.data.synthetic import SyntheticDataset


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    save_every: int = 50
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    handle_signals: bool = False   # opt-in (tests run in-process)


@dataclasses.dataclass
class LoopResult:
    final_step: int
    losses: list
    straggler_events: list
    preempted: bool


class TrainLoop:
    def __init__(self, step_fn: Callable, dataset: SyntheticDataset,
                 ckpt: CheckpointManager, cfg: LoopConfig,
                 put_batch: Optional[Callable] = None,
                 on_step: Optional[Callable] = None):
        """``step_fn(state, batch) -> (state, metrics)``.
        ``put_batch(host_batch) -> device_batch`` moves a batch to the
        device (the train step moves numpy arrays itself)."""
        self.step_fn = step_fn
        self.dataset = dataset
        self.ckpt = ckpt
        self.cfg = cfg
        self.put_batch = put_batch or (lambda b: b)
        self.on_step = on_step
        self._preempt = False

    def _install_signals(self) -> dict:
        """Install the preempt flag's handler; returns the handlers it
        replaced."""
        def handler(signum, frame):
            self._preempt = True
        return {s: signal.signal(s, handler)
                for s in (signal.SIGTERM, signal.SIGINT)}

    def request_preempt(self):
        """Programmatic preemption trigger (tests)."""
        self._preempt = True

    def run(self, state: Any, start_step: Optional[int] = None
            ) -> tuple[Any, LoopResult]:
        """Train from ``state`` (or the newest checkpoint) to
        ``total_steps``. With ``handle_signals`` the handlers the run
        replaced are put back when it returns or raises."""
        if not self.cfg.handle_signals:
            return self._run(state, start_step)
        replaced = self._install_signals()
        try:
            return self._run(state, start_step)
        finally:
            for s, h in replaced.items():
                signal.signal(s, h)

    def _run(self, state, start_step):
        cfg = self.cfg
        step = 0
        if start_step is not None:
            step = start_step
        else:
            latest = self.ckpt.latest_step()
            if latest is not None:
                state, step = self.ckpt.restore(state, latest)

        losses, stragglers = [], []
        ewma = None
        preempted = False
        while step < cfg.total_steps:
            t0 = time.monotonic()
            batch = self.put_batch(self.dataset.global_batch_at(step))
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0

            if not np.isfinite(loss):
                self.ckpt.wait()
                raise FloatingPointError(
                    f"non-finite loss {loss} at step {step}")
            losses.append(loss)
            if ewma is not None and dt > cfg.straggler_factor * ewma:
                stragglers.append({"step": step, "dt": dt, "ewma": ewma})
            ewma = dt if ewma is None else (
                cfg.ewma_alpha * dt + (1 - cfg.ewma_alpha) * ewma)

            step += 1
            if self.on_step is not None:
                self.on_step(step, loss)
            if step % cfg.save_every == 0 or step == cfg.total_steps:
                self.ckpt.save(step, state, note=f"loss={loss:.4f}")
            if self._preempt:
                self.ckpt.save(step, state, note="preempt")
                preempted = True
                break

        self.ckpt.wait()
        return state, LoopResult(step, losses, stragglers, preempted)
