"""Result cache keyed on the query's int8 quantization codes.

Port of ``repro.serve.cache``.  The key comes from the port's own codec
(``repro_torch.quant.codec.cache_codes``/``code_key``), which gives the
reference's key bytes for the same query.

Real online traffic is SKEWED: popular items are queried again and again,
and a graph traversal costs the same whether or not the answer was computed
two milliseconds ago.  This module short-circuits repeats before they ever
reach the coalescing queue.

The cache key is the query's symmetric int8 quantization codes plus the
float32 scale bit pattern (``repro_torch.quant.codec.query_cache_key``) — the
same codes AQR-HNSW-style quantized search already materializes at query
time, reused as an EXACT-MATCH key:

* **no false hits by construction** — the key IS the (codes, scale) pair,
  byte for byte; key equality implies quantized-code equality (pinned by a
  Hypothesis property test), so a hit can only come from a query whose
  quantized reconstruction is identical;
* **collision-bounded** — two distinct queries sharing a key differ by at
  most half a quantization step per element; the optional per-entry
  **recall guard** (``guard_eps``) tightens this further by comparing the
  incoming query against the exact query the entry was computed for and
  demoting the lookup to a miss when they differ by more than ``guard_eps``
  in L2 (``guard_eps=0.0``, the default, admits exact repeats only);
* **bit-identical fall-through** — the cache only ever REPLAYS results the
  engine produced; a miss goes through the normal serving path unchanged,
  so cached and uncached serving return identical answers (pinned by
  ``tests/test_serve_tier.py``).

Semantics: exact-key LRU with capacity eviction and optional TTL expiry.
Hit / miss / eviction / expiry / guard-miss counters are kept locally
(``stats()``) and, when an :class:`~repro_torch.obs.Observability` bundle with
``metrics`` enabled is attached, mirrored into the registry as
``serve_cache_events_total{event=...}``.

Typical use is through the coalescer::

    srv = index.serve_async(params, cache=CachePolicy(capacity=4096,
                                                      ttl_s=30.0))
    fut = srv.submit(q)        # hit: resolved immediately; miss: queued

but the cache is also usable standalone around any ``ids/dists`` producer.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.obs import NULL_OBS, Observability
from repro_torch.quant.codec import cache_codes, code_key

__all__ = ["CachePolicy", "CacheEntry", "ResultCache"]


class CachePolicy(NamedTuple):
    """Result-cache configuration.

    * ``capacity`` — max entries; least-recently-USED entry evicted first.
    * ``ttl_s`` — entries older than this are expired at lookup time
      (None: entries never age out).
    * ``guard_eps`` — the per-entry recall guard: a hit is served only if
      the incoming query is within this L2 distance of the exact query the
      entry was computed for.  ``0.0`` admits exact repeats only; raise it
      to trade a bounded recall risk for a higher hit rate (the quantized
      key already bounds the gap to half a code step per element).
    """
    capacity: int = 4096
    ttl_s: Optional[float] = None
    guard_eps: float = 0.0


class CacheEntry(NamedTuple):
    """One cached result: the exact query it was computed for (the recall
    guard's reference), the engine's answer, and the insertion time."""
    query: np.ndarray        # (d,) float32 — guard reference
    ids: np.ndarray          # (k,) int32
    dists: np.ndarray        # (k,) float32
    insert_t: float          # clock seconds at insertion (TTL reference)


class ResultCache:
    """Exact-key LRU over quantized-code keys, with TTL and recall guard.

    Thread-safe (one lock around the map — lookups are O(1) plus one
    (d,)-vector guard comparison).  ``clock`` is injectable for the
    deterministic serving test harness; it defaults to
    ``time.perf_counter`` and only relative differences are used.
    """

    def __init__(self, policy: CachePolicy = CachePolicy(), *,
                 clock=None, obs: Optional[Observability] = None):
        if policy.capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        if policy.ttl_s is not None and policy.ttl_s <= 0:
            raise ValueError("ttl_s must be > 0 (or None to disable)")
        if policy.guard_eps < 0:
            raise ValueError("guard_eps must be >= 0")
        self.policy = policy
        self.obs = obs if obs is not None else NULL_OBS
        self._clock = clock if clock is not None else time.perf_counter
        self._lock = threading.Lock()
        self._entries: "OrderedDict[bytes, CacheEntry]" = OrderedDict()
        # event counters (exact; mirrored into the obs registry when on)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expirations = 0
        self.guard_misses = 0
        self.insertions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- keys ----------------------------------------------------------------

    @staticmethod
    def key_for(query) -> bytes:
        """The stable quantized-code key for one (d,) query (see
        ``repro_torch.quant.codec.query_cache_key``)."""
        return code_key(*cache_codes(query))

    # -- events --------------------------------------------------------------

    def _count(self, event: str) -> None:
        # caller holds the lock for the local counter; the registry child
        # has its own locking
        if self.obs.metrics:
            self.obs.registry.counter(
                "serve_cache_events_total",
                "result-cache events by kind (hit/miss/eviction/...)",
            ).inc(1, event=event)

    # -- lookup / insert -----------------------------------------------------

    def lookup(self, query, *, key: Optional[bytes] = None,
               now: Optional[float] = None
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Probe the cache for ``query``; returns ``(ids, dists)`` on a hit,
        None on a miss (including TTL expiry and recall-guard rejection).

        A hit REPLAYS the stored engine result bit for bit.  ``key`` skips
        recomputing the quantized codes when the caller already has them.
        """
        q = np.asarray(query, np.float32).reshape(-1)
        if key is None:
            key = self.key_for(q)
        if now is None:
            now = self._clock()
        ttl = self.policy.ttl_s
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                self._count("miss")
                return None
            if ttl is not None and now - entry.insert_t > ttl:
                del self._entries[key]
                self.expirations += 1
                self.misses += 1
                self._count("expired")
                self._count("miss")
                return None
            if float(np.linalg.norm(q - entry.query)) > self.policy.guard_eps:
                # recall guard: same quantized codes, but the exact query
                # drifted past the configured bound — do not replay
                self.guard_misses += 1
                self.misses += 1
                self._count("guard_miss")
                self._count("miss")
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            self._count("hit")
            return entry.ids, entry.dists

    def insert(self, query, ids, dists, *, key: Optional[bytes] = None,
               now: Optional[float] = None) -> None:
        """Store one served result under the query's quantized-code key.

        Arrays are copied so cached results are immune to caller-side
        mutation; re-inserting an existing key refreshes entry, guard
        reference, and TTL.
        """
        q = np.asarray(query, np.float32).reshape(-1)
        if key is None:
            key = self.key_for(q)
        if now is None:
            now = self._clock()
        entry = CacheEntry(
            query=np.array(q, np.float32),
            ids=np.array(ids),
            dists=np.array(dists),
            insert_t=now)
        with self._lock:
            if key in self._entries:
                del self._entries[key]
            elif len(self._entries) >= self.policy.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
                self._count("eviction")
            self._entries[key] = entry
            self.insertions += 1
            self._count("insertion")

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    # -- observability -------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """Exact event counters + current size and hit rate."""
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "size": float(len(self._entries)),
                "capacity": float(self.policy.capacity),
                "hits": float(self.hits),
                "misses": float(self.misses),
                "hit_rate": self.hits / lookups if lookups else 0.0,
                "evictions": float(self.evictions),
                "expirations": float(self.expirations),
                "guard_misses": float(self.guard_misses),
                "insertions": float(self.insertions),
            }
