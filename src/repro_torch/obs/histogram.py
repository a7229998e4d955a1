"""Streaming log-bucketed histogram: bounded memory, mergeable, accurate.

The port's own copy of ``repro.obs.histogram`` (pure Python; the same
buckets, quantiles, merges and JSON, so sketches from either package merge).

The serving stack needs latency *distributions* (p50/p95/p99), not totals —
but a Python list of floats grows without bound under sustained traffic and
cannot be merged across replicas.  :class:`LogHistogram` is the replacement:
a DDSketch-style sketch over geometrically-spaced buckets.

* **Relative-error guarantee.**  Bucket boundaries grow by a factor
  ``gamma = (1 + rel_err) / (1 - rel_err)``; a value ``v`` landing in bucket
  ``i`` is reported as the bucket's mid value ``2 * gamma**i / (gamma + 1)``,
  which is within ``rel_err`` of ``v``.  Quantile estimates therefore carry
  the same bound: ``|quantile(q) - exact| <= rel_err * exact`` (plus at most
  one rank of discreteness).  The default ``rel_err=0.01`` makes every
  reported percentile exact to within ±1%.
* **Bounded memory.**  Buckets are stored sparsely (index -> count) and
  capped at ``max_buckets``; on overflow the LOWEST buckets are collapsed
  into one (the standard DDSketch policy: tail percentiles — the ones that
  matter for latency — keep full resolution, only the far-low tail coarsens).
  At the default resolution 1024 buckets span more than eight decades, so
  collapse never triggers for realistic latency streams.
* **Mergeable.**  Two sketches with the same ``rel_err`` merge by adding
  bucket counts — exact, commutative, and associative (below the bucket
  cap), so per-replica histograms aggregate into fleet-wide percentiles
  without approximation beyond the per-sketch bound.

``count``/``sum``/``min``/``max`` (and therefore ``mean``) are tracked
exactly; only the quantiles are bucket-resolved.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, Optional

__all__ = ["LogHistogram"]

# values at or below this land in the dedicated zero bucket: they carry no
# meaningful relative precision and would need unbounded negative indices
_MIN_TRACKABLE = 1e-9


class LogHistogram:
    """Log-bucketed streaming histogram (see module docstring).

    Thread-safe: ``observe`` / ``merge`` / ``quantile`` take an internal
    lock (observation cost is one ``math.log`` + one dict update).
    """

    __slots__ = ("rel_err", "max_buckets", "_gamma", "_log_gamma", "_counts",
                 "count", "total", "zero_count", "_min", "_max", "_lock")

    def __init__(self, rel_err: float = 0.01, max_buckets: int = 1024):
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
        if max_buckets < 2:
            raise ValueError("max_buckets must be >= 2")
        self.rel_err = float(rel_err)
        self.max_buckets = int(max_buckets)
        self._gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._log_gamma = math.log(self._gamma)
        self._counts: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.zero_count = 0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------

    def _index(self, value: float) -> int:
        return math.ceil(math.log(value) / self._log_gamma)

    def _value(self, index: int) -> float:
        """Mid value of bucket ``index`` — within ``rel_err`` of every value
        the bucket holds."""
        return 2.0 * self._gamma ** index / (self._gamma + 1.0)

    def observe(self, value: float, n: int = 1) -> None:
        """Record ``value`` (``n`` times).  Non-finite values are dropped;
        values <= ~0 go to the exact zero bucket."""
        value = float(value)
        if not math.isfinite(value) or n <= 0:
            return
        with self._lock:
            self.count += n
            self.total += value * n
            self._min = value if self._min is None else min(self._min, value)
            self._max = value if self._max is None else max(self._max, value)
            if value <= _MIN_TRACKABLE:
                self.zero_count += n
            else:
                i = self._index(value)
                self._counts[i] = self._counts.get(i, 0) + n
                if len(self._counts) > self.max_buckets:
                    self._collapse_lowest()

    def observe_many(self, values: Iterable[float]) -> None:
        for v in values:
            self.observe(v)

    def _collapse_lowest(self) -> None:
        """Fold the lowest bucket(s) into the next-lowest kept bucket —
        called under the lock when the sparse map exceeds ``max_buckets``."""
        keys = sorted(self._counts)
        spill = 0
        while len(keys) - (1 if spill else 0) >= self.max_buckets:
            spill += self._counts.pop(keys.pop(0))
        if spill:
            self._counts[keys[0]] = self._counts.get(keys[0], 0) + spill

    # -- merging -----------------------------------------------------------

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Fold ``other`` into this sketch (exact bucket-count addition;
        both sketches must share ``rel_err``).  Returns ``self``."""
        if abs(other.rel_err - self.rel_err) > 1e-12:
            raise ValueError(
                f"cannot merge histograms with different resolutions "
                f"({self.rel_err} vs {other.rel_err})")
        with other._lock:
            o_counts = dict(other._counts)
            o_count, o_total = other.count, other.total
            o_zero, o_min, o_max = other.zero_count, other._min, other._max
        with self._lock:
            for i, c in o_counts.items():
                self._counts[i] = self._counts.get(i, 0) + c
            self.count += o_count
            self.total += o_total
            self.zero_count += o_zero
            if o_min is not None:
                self._min = o_min if self._min is None \
                    else min(self._min, o_min)
            if o_max is not None:
                self._max = o_max if self._max is None \
                    else max(self._max, o_max)
            if len(self._counts) > self.max_buckets:
                self._collapse_lowest()
        return self

    # -- reading -----------------------------------------------------------

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def min(self) -> float:
        return self._min if self._min is not None else 0.0

    @property
    def max(self) -> float:
        return self._max if self._max is not None else 0.0

    def quantile(self, q: float) -> float:
        """The ``q`` in [0, 1] quantile, within ``rel_err`` relative error
        of the exact (nearest-rank) value.  Clamped to the exact observed
        [min, max] envelope, so ``quantile(0)``/``quantile(1)`` are exact."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            if not self.count:
                return 0.0
            if q == 0.0:
                return self._min if self._min is not None else 0.0
            if q == 1.0:
                return self._max if self._max is not None else 0.0
            rank = q * (self.count - 1)
            seen = self.zero_count
            if rank < seen:
                out = 0.0
            else:
                out = self._value(max(self._counts))   # fallback: top bucket
                for i in sorted(self._counts):
                    seen += self._counts[i]
                    if rank < seen:
                        out = self._value(i)
                        break
            lo = self._min if self._min is not None else out
            hi = self._max if self._max is not None else out
            return min(max(out, lo), hi)

    def percentile(self, p: float) -> float:
        """``quantile(p / 100)`` — the numpy-style spelling."""
        return self.quantile(p / 100.0)

    @property
    def n_buckets(self) -> int:
        """Distinct occupied buckets — bounded by ``max_buckets``."""
        return len(self._counts)

    def bucket_bounds(self):
        """Sorted ``(upper_bound, count)`` pairs of the occupied buckets
        (``gamma**i`` is bucket ``i``'s inclusive upper bound) — the
        Prometheus-exporter view.  The zero bucket is not included."""
        with self._lock:
            return [(self._gamma ** i, c)
                    for i, c in sorted(self._counts.items())]

    # -- (de)serialization -------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-safe full state — enough to reconstruct and merge on
        another host (bucket keys become strings; JSON objects only have
        string keys)."""
        with self._lock:
            return {
                "rel_err": self.rel_err,
                "max_buckets": self.max_buckets,
                "count": self.count,
                "sum": self.total,
                "zero_count": self.zero_count,
                "min": self._min,
                "max": self._max,
                "buckets": {str(i): c for i, c in
                            sorted(self._counts.items())},
            }

    @classmethod
    def from_dict(cls, d: dict) -> "LogHistogram":
        h = cls(rel_err=float(d["rel_err"]),
                max_buckets=int(d.get("max_buckets", 1024)))
        h.count = int(d["count"])
        h.total = float(d["sum"])
        h.zero_count = int(d.get("zero_count", 0))
        h._min = None if d.get("min") is None else float(d["min"])
        h._max = None if d.get("max") is None else float(d["max"])
        h._counts = {int(i): int(c) for i, c in d.get("buckets", {}).items()}
        return h

    def __repr__(self) -> str:
        return (f"LogHistogram(count={self.count}, mean={self.mean:.4g}, "
                f"p50={self.quantile(0.5):.4g}, p99={self.quantile(0.99):.4g}, "
                f"rel_err={self.rel_err})")
