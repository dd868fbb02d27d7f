"""Fault-tolerant trainer loop.

Counterpart of ``repro.train.trainer``:

* periodic async checkpoints; on a step failure (a ``RuntimeError``: a lost
  device or a failed launch surfaces as one) the trainer restores the last
  complete checkpoint and replays from it; the deterministic pipeline
  gives the replayed steps the same batches;
* ``StragglerMonitor`` keeps a step-time EWMA and flags outliers (the hook a
  fleet scheduler would use to evict or re-shard a slow host);
* ``failure_injector`` lets a test fail chosen steps to exercise recovery.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, tree_leaves)
from repro_torch.data.pipeline import TokenPipeline

log = logging.getLogger(__name__)


@dataclasses.dataclass
class StragglerMonitor:
    alpha: float = 0.2
    threshold: float = 2.5  # flag steps slower than threshold x EWMA
    ewma: Optional[float] = None
    flagged: List[int] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = self.ewma is not None and dt > self.threshold * self.ewma
        self.ewma = dt if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        if is_straggler:
            self.flagged.append(step)
        return is_straggler


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    max_restarts: int = 3
    log_every: int = 10


class Trainer:
    def __init__(self, cfg: TrainerConfig, step_fn: Callable, state,
                 pipeline: TokenPipeline,
                 failure_injector: Optional[Callable[[int], None]] = None,
                 to_device: Optional[Callable] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = state
        self.pipeline = pipeline
        self.failure_injector = failure_injector
        self.to_device = to_device or self._to_params_device
        self.ckpt = AsyncCheckpointer(cfg.checkpoint_dir)
        self.monitor = StragglerMonitor()
        self.history: List[Dict[str, float]] = []
        self.restarts = 0
        # one record per recovered failure: (step, repr(error)), so that
        # what killed which steps is visible after the run
        self.failures: List[tuple] = []

    def _to_params_device(self, batch):
        """A numpy batch as tensors on the device of the state's
        parameters."""
        dev = tree_leaves(self.state.params)[0].device
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def _restore_latest(self):
        step = latest_step(self.cfg.checkpoint_dir)
        if step is None:
            raise RuntimeError("no checkpoint to restore from")
        self.state = restore_checkpoint(self.cfg.checkpoint_dir, step,
                                        self.state)
        return step

    def run(self):
        step = int(self.state.step)
        while step < self.cfg.total_steps:
            try:
                batch = self.to_device(self.pipeline.batch_at(step))
                if self.failure_injector is not None:
                    self.failure_injector(step)
                t0 = time.monotonic()
                self.state, metrics = self.step_fn(self.state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.monotonic() - t0
                self.monitor.observe(step, dt)
                metrics["step_time_s"] = dt
                self.history.append(metrics)
                step += 1
                if step % self.cfg.checkpoint_every == 0:
                    self.ckpt.save(step, self.state)
            except RuntimeError as e:
                # failure path: restore and replay (deterministic pipeline).
                # Only a RuntimeError is taken as recoverable by a restart (a
                # lost device or failed launch surfaces as one); programming
                # errors (TypeError, ValueError, ...) propagate at once
                # instead of burning restarts.
                self.restarts += 1
                self.failures.append((step, repr(e)))
                log.warning(
                    "step %d failed (%s); restart %d/%d from last checkpoint",
                    step, e, self.restarts, self.cfg.max_restarts)
                if self.restarts > self.cfg.max_restarts:
                    raise
                self.ckpt.wait()
                step = self._restore_latest()
        self.ckpt.wait()
        # a final checkpoint, so that a restart after completion is a no-op
        self.ckpt.save(step, self.state)
        self.ckpt.wait()
        return self.state
