"""Admission control: queue-depth watermarks + two priority classes.

Port of ``repro.serve.admission`` (pure Python; the same decisions).

Deadline shedding (``repro_torch.serve.coalescer``) rejects requests that are
ALREADY late — it bounds wasted work, not the tail.  Under sustained
overload every request queues behind the backlog, so p99 blows up for
everyone.  The fix (cf. "Low Latency Without Throughput Loss", PAPERS.md)
is to decouple traffic classes BEFORE the queue fills:

* ``"critical"`` — latency-critical, interactive traffic.  Admitted until
  the queue reaches ``critical_watermark``.
* ``"throughput"`` — batch/offline traffic that tolerates rejection and
  retry.  Admitted only while the queue is below
  ``throughput_watermark``.

Because ``throughput_watermark <= critical_watermark`` is enforced at
construction, the throughput class is ALWAYS shed first: overload squeezes
batch traffic out while the critical class keeps a short queue — its p99
stays bounded by (watermark x service time) instead of growing with the
backlog.  Admission decisions are pure threshold comparisons, so they are
monotone in queue depth (admitted at depth d ⇒ admitted at every depth
< d) — both invariants are pinned by Hypothesis property tests in
``tests/test_serve_tier.py``.

The priority class also feeds EDF batch formation in the coalescer:
critical requests sort ahead of throughput requests, earliest deadline
first within each class.

Decisions are counted per ``(class, decision)`` locally (``stats()``) and,
with an :class:`~repro_torch.obs.Observability` bundle with ``metrics`` on,
mirrored into the registry as
``admission_decisions_total{priority=..., decision=...}``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.obs import NULL_OBS, Observability

__all__ = ["PRIORITIES", "AdmissionPolicy", "AdmissionRejected",
           "AdmissionController"]

#: The two traffic classes, in shed order: "throughput" is always shed
#: first, "critical" last.
PRIORITIES = ("critical", "throughput")


class AdmissionRejected(Exception):
    """The request was shed at admission (queue depth over its class's
    watermark); its future receives this exception instead of a result.
    Callers in the throughput class are expected to back off and retry."""


@dataclass(frozen=True)
class AdmissionPolicy:
    """Queue-depth watermarks per priority class.

    A request of class c is admitted iff the current queue depth is
    strictly below its class watermark.  ``throughput_watermark <=
    critical_watermark`` is enforced, so shedding always starts with the
    throughput class — the "critical is never shed before throughput"
    invariant holds by construction.
    """
    throughput_watermark: int = 32   # shed throughput-class at this depth
    critical_watermark: int = 128    # shed EVERYTHING at this depth

    def __post_init__(self):
        if self.throughput_watermark < 1:
            raise ValueError("throughput_watermark must be >= 1")
        if self.critical_watermark < self.throughput_watermark:
            raise ValueError(
                "critical_watermark must be >= throughput_watermark — the "
                "critical class is never shed before the throughput class")

    def watermark(self, priority: str) -> int:
        if priority not in PRIORITIES:
            raise ValueError(
                f"unknown priority {priority!r}; one of {PRIORITIES}")
        return (self.critical_watermark if priority == "critical"
                else self.throughput_watermark)

    def admits(self, queue_depth: int, priority: str) -> bool:
        """Pure decision: admit iff ``queue_depth`` is below the class
        watermark.  Monotone in depth by construction."""
        return queue_depth < self.watermark(priority)


class AdmissionController:
    """Stateful wrapper: applies an :class:`AdmissionPolicy` and counts the
    decisions (per class, admitted vs shed), optionally mirroring them into
    the obs registry.  ``clock`` is accepted for symmetry with the other
    serving-tier components (reserved for future rate-based policies)."""

    def __init__(self, policy: AdmissionPolicy = AdmissionPolicy(), *,
                 obs: Optional[Observability] = None, clock=None):
        self.policy = policy
        self.obs = obs if obs is not None else NULL_OBS
        self._clock = clock if clock is not None else time.perf_counter
        self._lock = threading.Lock()
        self.admitted: Dict[str, int] = {p: 0 for p in PRIORITIES}
        self.shed: Dict[str, int] = {p: 0 for p in PRIORITIES}

    def admit(self, queue_depth: int, priority: str) -> bool:
        """Decide and record: True = enqueue, False = shed now."""
        ok = self.policy.admits(queue_depth, priority)
        with self._lock:
            (self.admitted if ok else self.shed)[priority] += 1
        if self.obs.metrics:
            self.obs.registry.counter(
                "admission_decisions_total",
                "admission decisions by priority class and outcome",
            ).inc(1, priority=priority,
                  decision="admitted" if ok else "shed")
        return ok

    def stats(self) -> Dict[str, float]:
        """Per-class decision counters (exact)."""
        with self._lock:
            out: Dict[str, float] = {}
            for p in PRIORITIES:
                out[f"admitted_{p}"] = float(self.admitted[p])
                out[f"shed_{p}"] = float(self.shed[p])
            out["shed_total"] = float(sum(self.shed.values()))
            return out
