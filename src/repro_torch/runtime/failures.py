"""Failure injection for fault-tolerance tests (port of
``repro.runtime.failures``).

On a real machine failures arrive as device errors or preemption signals;
here they are raised deterministically at chosen steps so the Trainer's
recovery path is exercised end-to-end (checkpoint -> crash -> restore ->
exact continuation)."""
from __future__ import annotations

from typing import Iterable, Set


class SimulatedWorkerFailure(RuntimeError):
    pass


class FailureInjector:
    def __init__(self, fail_at_steps: Iterable[int]):
        self.fail_at: Set[int] = set(fail_at_steps)
        self.fired: Set[int] = set()

    def __call__(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise SimulatedWorkerFailure(
                f"simulated device loss at step {step}")
