"""repro_torch.obs — observability for the port's serving stack.

Port of ``repro.obs`` (see ``docs/observability.md``):

* :mod:`~repro_torch.obs.histogram` — :class:`LogHistogram`, the
  bounded-memory mergeable sketch behind every latency/convergence
  distribution.
* :mod:`~repro_torch.obs.registry` — :class:`MetricsRegistry` of typed
  counters, gauges, and histograms with JSON + Prometheus exporters.
* :mod:`~repro_torch.obs.trace` — :class:`TraceRecorder`, request-scoped
  span trees exported as Chrome-trace/Perfetto JSON, plus the
  :func:`~repro_torch.obs.torchbridge.device_annotation` bridge to
  ``torch.profiler`` (and NVTX on a CUDA device).

:class:`Observability` bundles all three for threading through
``AnnIndex.serve(..., obs=...)`` / ``serve_async(..., obs=...)``.  The
shared :data:`NULL_OBS` singleton is the default: every probe point
degrades to a constant-time no-op, so an uninstrumented engine pays
nothing.
"""
from __future__ import annotations

from typing import Optional

from .histogram import LogHistogram
from .registry import Counter, Gauge, Histogram, MetricsRegistry
from .torchbridge import device_annotation, have_profiler
from .trace import NULL_TRACER, SpanHandle, TraceRecorder

__all__ = [
    "LogHistogram",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "TraceRecorder", "SpanHandle", "NULL_TRACER",
    "device_annotation", "have_profiler",
    "Observability", "NULL_OBS",
]


class Observability:
    """Tracer + metrics registry + profiler flag, as one handle.

    * ``tracing`` — record span trees (:class:`TraceRecorder`); off means
      the shared :data:`NULL_TRACER` (no-ops, no allocation).
    * ``metrics`` — write convergence/serving histograms into
      ``registry``.  The engines guard every registry write on this flag.
    * ``profile`` — additionally wrap device dispatches in
      ``torch.profiler.record_function`` ranges (and NVTX ranges on a CUDA
      index) so host spans line up with the kernels under
      ``torch.profiler.profile()``.
    """

    __slots__ = ("tracer", "registry", "metrics", "profile")

    def __init__(self, *, tracing: bool = True, metrics: bool = True,
                 profile: bool = False, max_trace_events: int = 200_000,
                 registry: Optional[MetricsRegistry] = None):
        self.tracer = (TraceRecorder(enabled=True,
                                     max_events=max_trace_events)
                       if tracing else NULL_TRACER)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.metrics = bool(metrics)
        self.profile = bool(profile)

    @property
    def enabled(self) -> bool:
        return self.tracer.enabled or self.metrics

    def write_trace(self, path: str) -> None:
        """Dump the Chrome-trace JSON collected so far to ``path``."""
        self.tracer.write(path)


#: Shared all-off bundle — the default ``obs`` everywhere.
NULL_OBS = Observability(tracing=False, metrics=False, profile=False)
