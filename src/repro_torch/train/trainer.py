"""Fault-tolerant training loop (port of ``repro.train.trainer``).

Responsibilities:
  * periodic async checkpoints (atomic, keep-k) + auto-resume from latest,
  * failure recovery: any exception in a step (device loss, preemption —
    simulated via ``runtime.failures`` in tests) triggers restore-from-last-
    checkpoint and continues, up to ``max_recoveries``,
  * data pipeline resumption (the step-seeded synthetic stream restarts
    exactly).

A step updates the state in place: the trainer owns it, and a failed
step's state is replaced by the restored one.  Over ranks (a process
group up) every rank runs the trainer on the same stream, rank 0 writes
the checkpoints, and a failed step is raised, not recovered: a rank
cannot restore alone while the others wait in the step's collectives.
Elastic restarts onto another mesh go through
``runtime.elastic.reshard_state`` or ``load_checkpoint(..., shardings=)``.
"""
from __future__ import annotations

import logging
from typing import Callable, Optional

import torch

from repro_torch import ranks as rank_mod
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.data.tokens import TokenStream, _batch_at
from repro_torch.train.train_step import (TrainState, init_train_state,
                                          make_train_step)

log = logging.getLogger("repro_torch.trainer")


class Trainer:
    """Trains ``model`` (built on its device: default CUDA) on ``stream``,
    with weights drawn from ``tcfg.seed``."""

    def __init__(self, model, tcfg: TrainConfig, stream: TokenStream,
                 train_step: Optional[Callable] = None,
                 max_recoveries: int = 3):
        rank_mod.refuse_counting("Trainer")
        self.model = model
        self.tcfg = tcfg
        self.stream = stream
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir,
                                      keep=tcfg.keep_checkpoints)
        self.train_step = train_step or make_train_step(model, tcfg)
        self.max_recoveries = max_recoveries
        self.metrics_log = []

    def _init(self) -> TrainState:
        gen = torch.Generator(device=self.model.device)
        return init_train_state(self.model, gen.manual_seed(self.tcfg.seed),
                                self.tcfg)

    def init_or_resume(self) -> tuple[TrainState, int]:
        state = self._init()
        restored, step = self.ckpt.restore_latest(state)
        if restored is not None:
            log.info("resumed from checkpoint step %d", step)
            return restored, step
        return state, 0

    def batch(self, step: int) -> dict:
        """The stream's batch of ``step`` on the model's device."""
        return {k: torch.from_numpy(v).to(self.model.device)
                for k, v in _batch_at(self.stream, step).items()}

    def run(self, steps: Optional[int] = None,
            fault_hook: Optional[Callable[[int], None]] = None
            ) -> TrainState:
        """Run to ``steps`` (default tcfg.total_steps) with auto-recovery.

        ``fault_hook(step)`` is called before each step; tests raise from it
        to simulate worker failures / preemptions.
        """
        steps = steps or self.tcfg.total_steps
        state, start = self.init_or_resume()
        step = start
        recoveries = 0
        while step < steps:
            try:
                if fault_hook is not None:
                    fault_hook(step)
                state, metrics = self.train_step(state, self.batch(step))
                self.metrics_log.append(
                    {k: float(v) for k, v in metrics.items()})
                step += 1
                if step % self.tcfg.checkpoint_every == 0 or step == steps:
                    self.ckpt.save(step, state)
            except Exception as e:  # noqa: BLE001 — recovery path
                if rank_mod.is_up():
                    # one rank cannot restore alone: the others wait in a
                    # collective of the step it left
                    raise
                recoveries += 1
                log.warning("step %d failed (%s); recovery %d/%d",
                            step, e, recoveries, self.max_recoveries)
                if recoveries > self.max_recoveries:
                    raise
                restored, ck_step = self.ckpt.restore_latest(state)
                if restored is None:
                    state, step = self.init_or_resume()
                else:
                    state, step = restored, ck_step
        self.ckpt.wait()
        return state
