"""Typed metrics registry: counters, gauges, histograms; JSON + Prometheus.

The port's own copy of ``repro.obs.registry``: the same JSON and the same
Prometheus text, byte for byte.

One :class:`MetricsRegistry` holds every metric a process emits.  Metrics
are keyed by ``(name, labels)`` where labels is a sorted tuple of
``(key, value)`` string pairs — the Prometheus data model.  Three types:

* :class:`Counter` — monotone float/int accumulator (``inc``).
* :class:`Gauge` — last-write-wins value (``set``, ``inc``/``dec``).
* :class:`Histogram` — a :class:`~repro_torch.obs.histogram.LogHistogram` per
  label set (``observe``); quantiles carry the sketch's documented
  relative-error bound.

Registries are mergeable (:meth:`MetricsRegistry.merge`) and round-trip
through JSON (:meth:`to_json` / :meth:`from_json`), so per-replica
registries aggregate into fleet-wide views.  :meth:`to_prometheus` emits
the text exposition format (HELP/TYPE lines, label escaping, cumulative
``_bucket``/``_sum``/``_count`` series for histograms).
"""
from __future__ import annotations

import json
import threading
from typing import Dict, Iterable, Mapping, Optional, Tuple

from .histogram import LogHistogram

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

LabelPairs = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Mapping[str, str]]) -> LabelPairs:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline must be escaped (in that order)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(pairs: LabelPairs, extra: Iterable[Tuple[str, str]] = ()) -> str:
    items = list(pairs) + list(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in items)
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    # Prometheus wants plain decimal or scientific; repr of a float is fine,
    # but integral values read better without the trailing ".0"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Base: name, help text, per-label-set child values."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._children: Dict[LabelPairs, object] = {}
        self._lock = threading.Lock()

    def labels(self, **labels: str):
        """Child for a label set (created on first use)."""
        key = _label_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                self._children[key] = child
            return child

    def _new_child(self):
        raise NotImplementedError

    def items(self):
        with self._lock:
            return list(self._children.items())


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        self.value += amount


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        self.labels(**labels).inc(amount)


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float, **labels: str) -> None:
        self.labels(**labels).set(value)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "", rel_err: float = 0.01,
                 max_buckets: int = 1024):
        super().__init__(name, help)
        self.rel_err = rel_err
        self.max_buckets = max_buckets

    def _new_child(self):
        return LogHistogram(rel_err=self.rel_err, max_buckets=self.max_buckets)

    def observe(self, value: float, **labels: str) -> None:
        self.labels(**labels).observe(value)


class MetricsRegistry:
    """Process-wide metric index.  ``counter``/``gauge``/``histogram`` are
    get-or-create by name (re-registering an existing name with a different
    type raises)."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "", rel_err: float = 0.01,
                  max_buckets: int = 1024) -> Histogram:
        return self._get_or_create(Histogram, name, help,
                                   rel_err=rel_err, max_buckets=max_buckets)

    def metrics(self):
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    # -- merging -----------------------------------------------------------

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold another registry in: counters add, gauges take the other's
        value (last-write-wins), histograms merge sketches.  Returns self."""
        for m in other.metrics():
            if isinstance(m, Counter):
                mine = self.counter(m.name, m.help)
                for key, child in m.items():
                    mine.labels(**dict(key)).inc(child.value)
            elif isinstance(m, Gauge):
                mine = self.gauge(m.name, m.help)
                for key, child in m.items():
                    mine.labels(**dict(key)).set(child.value)
            elif isinstance(m, Histogram):
                mine = self.histogram(m.name, m.help, rel_err=m.rel_err,
                                      max_buckets=m.max_buckets)
                for key, child in m.items():
                    mine.labels(**dict(key)).merge(child)
        return self

    # -- JSON --------------------------------------------------------------

    def to_dict(self) -> dict:
        out = {}
        for m in self.metrics():
            series = []
            for key, child in sorted(m.items()):
                entry: dict = {"labels": dict(key)}
                if isinstance(m, Histogram):
                    h: LogHistogram = child  # type: ignore[assignment]
                    entry["histogram"] = h.to_dict()
                    entry["quantiles"] = {
                        "p50": h.quantile(0.50), "p95": h.quantile(0.95),
                        "p99": h.quantile(0.99)}
                else:
                    entry["value"] = child.value  # type: ignore[union-attr]
                series.append(entry)
            out[m.name] = {"type": m.kind, "help": m.help, "series": series}
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "MetricsRegistry":
        reg = cls()
        for name, meta in d.items():
            kind = meta.get("type", "gauge")
            for entry in meta.get("series", []):
                labels = entry.get("labels", {})
                if kind == "counter":
                    reg.counter(name, meta.get("help", "")) \
                        .labels(**labels).inc(float(entry["value"]))
                elif kind == "gauge":
                    reg.gauge(name, meta.get("help", "")) \
                        .labels(**labels).set(float(entry["value"]))
                elif kind == "histogram":
                    h = LogHistogram.from_dict(entry["histogram"])
                    m = reg.histogram(name, meta.get("help", ""),
                                      rel_err=h.rel_err,
                                      max_buckets=h.max_buckets)
                    m.labels(**labels).merge(h)
        return reg

    @classmethod
    def from_json(cls, s: str) -> "MetricsRegistry":
        return cls.from_dict(json.loads(s))

    # -- Prometheus text exposition ---------------------------------------

    def to_prometheus(self) -> str:
        """Text exposition format (version 0.0.4).  Histograms emit
        cumulative ``_bucket{le=...}`` series from the sketch's occupied
        bucket upper bounds, plus exact ``_sum`` and ``_count``."""
        lines = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, child in sorted(m.items()):
                if isinstance(m, Histogram):
                    h: LogHistogram = child  # type: ignore[assignment]
                    cum = h.zero_count
                    for ub, c in h.bucket_bounds():
                        cum += c
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_fmt_labels(key, [('le', f'{ub:.6g}')])}"
                            f" {cum}")
                    lines.append(
                        f"{m.name}_bucket{_fmt_labels(key, [('le', '+Inf')])}"
                        f" {h.count}")
                    lines.append(
                        f"{m.name}_sum{_fmt_labels(key)} {_fmt_value(h.total)}")
                    lines.append(f"{m.name}_count{_fmt_labels(key)} {h.count}")
                else:
                    v = child.value  # type: ignore[union-attr]
                    lines.append(f"{m.name}{_fmt_labels(key)} {_fmt_value(v)}")
        return "\n".join(lines) + "\n"
