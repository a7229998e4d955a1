"""Replica routing: spread queries over N engines, hedge the stragglers.

Port of ``repro.serve.router`` (host-side Python; the same routing,
hedging, health and merge).

One engine is one host's worth of serving.  Millions of users need N of
them, and the tier that picks which replica answers which request decides
the fleet's tail latency.  Two layouts, one ``search()`` API:

* ``mode="replicated"`` (data-parallel) — every replica serves the FULL
  index (e.g. ``[index.serve(params) for _ in range(n)]``).  Each request
  is routed to ONE replica chosen from per-replica latency sketches
  (``repro_torch.obs.LogHistogram`` — the same bounded ±1% sketches the
  engines keep) and health state; results are bit-identical to a single engine
  because every replica runs the same search.
* ``mode="sharded"`` (corpus-parallel) — each replica serves one corpus
  shard; a request fans out to ALL shards and the per-shard top-k lists
  merge into a global top-k (deterministic: distance then id order).
  ``shard_offsets`` maps shard-local result ids back to global ids.

**Hedged retry** (replicated mode): when the chosen replica has not
answered within ``hedge_after_ms`` — the deadline-risk signal — the same
request is dispatched to the next-best replica and the FIRST successful
answer wins.  The duplicate answer is deduplicated: the request resolves
exactly once, the loser's (still useful) latency sample is recorded when
it lands, and ``hedge_discarded`` counts the redundant work.  A replica
that fails fast fails over to the hedge immediately.

**Health**: ``max_failures`` consecutive errors mark a replica unhealthy
for ``cooldown_s`` (clock-injectable); unhealthy replicas are skipped by
selection until the cooldown lapses, then re-probed.  With every replica
unhealthy the router degrades to best-effort (least-recently-failed).

The router quacks like an engine (``search(queries)`` returning an object
with ``ids`` / ``dists`` / ``latency_ms``), so the coalescer composes with
it unchanged: ``AsyncAnnEngine(ReplicaRouter([...]), policy)`` gives
coalescing + admission + caching over a replica fleet.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from concurrent.futures import wait as futures_wait
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import NULL_OBS, LogHistogram, Observability

__all__ = ["RouterPolicy", "RouterResult", "ReplicaRouter"]

ROUTER_MODES = ("replicated", "sharded")
STRATEGIES = ("latency", "round_robin")


class RouterPolicy(NamedTuple):
    """Routing configuration.

    * ``strategy`` — ``"latency"`` picks the healthy replica with the
      lowest sketched p50 (cold replicas score 0, so they get probed
      first); ``"round_robin"`` rotates over healthy replicas.
    * ``hedge_after_ms`` — deadline-risk threshold: if the primary has not
      answered in this long, dispatch a hedge to the next-best replica
      (None disables hedging).
    * ``max_failures`` — consecutive errors before a replica is marked
      unhealthy.
    * ``cooldown_s`` — how long an unhealthy replica is skipped before
      being re-probed.
    """
    strategy: str = "latency"
    hedge_after_ms: Optional[float] = None
    max_failures: int = 3
    cooldown_s: float = 5.0


class RouterResult(NamedTuple):
    """One routed request (engine-shaped: the coalescer slices ids/dists)."""
    ids: np.ndarray          # (B, k) int32
    dists: np.ndarray        # (B, k) float32
    latency_ms: float        # router wall clock (incl. hedge wait)
    replica: int             # replica that produced the answer (-1: merged)
    hedged: bool             # True if a hedge request was dispatched


class _ReplicaState:
    """Per-replica serving state: latency sketch + health + counters."""

    __slots__ = ("engine", "sketch", "served", "errors",
                 "consecutive_failures", "unhealthy_until", "last_failure_t")

    def __init__(self, engine):
        self.engine = engine
        self.sketch = LogHistogram()
        self.served = 0
        self.errors = 0
        self.consecutive_failures = 0
        self.unhealthy_until = -float("inf")
        self.last_failure_t = -float("inf")

    def healthy(self, now: float) -> bool:
        return now >= self.unhealthy_until

    def score(self) -> float:
        """Routing score (lower = better): sketched p50 latency; a replica
        with no samples yet scores 0 so it gets probed first."""
        return self.sketch.quantile(0.5) if self.sketch.count else 0.0


def merge_topk(ids: np.ndarray, dists: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge concatenated per-shard candidate lists into a global top-k.

    ids/dists: (B, S*k).  Deterministic: ascending distance, ties broken
    on id — the same order ``exact_rerank`` uses, so shard layout never
    changes result order.
    """
    order = np.lexsort((ids, dists), axis=-1)
    ids = np.take_along_axis(ids, order, axis=-1)[:, :k]
    dists = np.take_along_axis(dists, order, axis=-1)[:, :k]
    return ids, dists


class ReplicaRouter:
    """Latency/health-aware routing over N engine replicas or shards."""

    def __init__(self, replicas: Sequence, *,
                 policy: RouterPolicy = RouterPolicy(),
                 mode: str = "replicated",
                 shard_offsets: Optional[Sequence[int]] = None,
                 obs: Optional[Observability] = None, clock=None):
        if not replicas:
            raise ValueError("need at least one replica")
        if mode not in ROUTER_MODES:
            raise ValueError(
                f"unknown router mode {mode!r}; one of {ROUTER_MODES}")
        if policy.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {policy.strategy!r}; one of {STRATEGIES}")
        if policy.hedge_after_ms is not None and policy.hedge_after_ms < 0:
            raise ValueError("hedge_after_ms must be >= 0")
        if mode == "replicated" and shard_offsets is not None:
            raise ValueError("shard_offsets applies to mode='sharded' only")
        if shard_offsets is not None and len(shard_offsets) != len(replicas):
            raise ValueError("need one shard offset per replica")
        self.mode = mode
        self.policy = policy
        self.obs = obs if obs is not None else NULL_OBS
        self._clock = clock if clock is not None else time.perf_counter
        self._replicas = [_ReplicaState(r) for r in replicas]
        self._shard_offsets = (None if shard_offsets is None
                               else [int(o) for o in shard_offsets])
        self._lock = threading.Lock()
        self._rr = 0                      # round-robin cursor
        self._pool: Optional[ThreadPoolExecutor] = None
        self._outstanding: set = set()    # hedge losers still in flight
        # router-level counters
        self.requests = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.hedge_discarded = 0
        self.failovers = 0

    def __len__(self) -> int:
        return len(self._replicas)

    # -- replica selection ---------------------------------------------------

    def _ensure_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=max(2, 2 * len(self._replicas)),
                    thread_name_prefix="ann-router")
            return self._pool

    def _pick(self, now: float) -> Tuple[int, Optional[int]]:
        """(primary, hedge) replica indices.  Healthy replicas ranked by
        strategy; hedge is the next-best healthy replica (None when only
        one candidate).  All-unhealthy degrades to least-recently-failed."""
        with self._lock:
            healthy = [i for i, r in enumerate(self._replicas)
                       if r.healthy(now)]
            if not healthy:
                healthy = sorted(
                    range(len(self._replicas)),
                    key=lambda i: self._replicas[i].last_failure_t)
            elif self.policy.strategy == "round_robin":
                rot = self._rr % len(healthy)
                healthy = healthy[rot:] + healthy[:rot]
                self._rr += 1
            else:
                healthy.sort(key=lambda i: (self._replicas[i].score(), i))
            primary = healthy[0]
            hedge = healthy[1] if len(healthy) > 1 else None
            return primary, hedge

    # -- per-replica execution (runs on pool threads) -------------------------

    def _run_replica(self, idx: int, queries):
        rep = self._replicas[idx]
        t0 = self._clock()
        try:
            res = rep.engine.search(queries)
        except Exception:
            now = self._clock()
            with self._lock:
                rep.errors += 1
                rep.consecutive_failures += 1
                rep.last_failure_t = now
                if rep.consecutive_failures >= self.policy.max_failures:
                    rep.unhealthy_until = now + self.policy.cooldown_s
            if self.obs.metrics:
                self.obs.registry.counter(
                    "router_requests_total",
                    "routed dispatches by replica and outcome",
                ).inc(1, replica=str(idx), outcome="error")
            raise
        ms = (self._clock() - t0) * 1e3
        with self._lock:
            rep.served += 1
            rep.consecutive_failures = 0
            rep.sketch.observe(ms)
        if self.obs.metrics:
            reg = self.obs.registry
            reg.histogram(
                "router_replica_latency_ms",
                "per-replica engine latency as routed",
            ).labels(replica=str(idx)).observe(ms)
            reg.counter(
                "router_requests_total",
                "routed dispatches by replica and outcome",
            ).inc(1, replica=str(idx), outcome="served")
        return res

    # -- hedging --------------------------------------------------------------

    def _discard_loser(self, fut: Future, idx: int) -> None:
        """Dedup the redundant answer of a hedged pair: count it, drop it.
        The loser's latency/health was already recorded by _run_replica."""
        def _done(f: Future, idx=idx):
            with self._lock:
                self.hedge_discarded += 1
                self._outstanding.discard(f)
            if self.obs.metrics:
                self.obs.registry.counter(
                    "router_hedges_total", "hedge lifecycle events",
                ).inc(1, event="discarded")
            f.exception()        # consume, never propagate to a caller
        with self._lock:
            self._outstanding.add(fut)
        fut.add_done_callback(_done)

    def _race(self, pairs: List[Tuple[int, Future]]):
        """First SUCCESSFUL completion wins; the other future is
        deduplicated via :meth:`_discard_loser`.  Raises the primary's
        error only if every leg fails."""
        pending = {f: i for i, f in pairs}  # future -> replica idx
        errors: List[BaseException] = []
        futs = [f for _, f in pairs]
        while pending:
            done, _ = futures_wait(list(pending), return_when=FIRST_COMPLETED)
            for f in done:
                idx = pending.pop(f)
                err = f.exception()
                if err is None:
                    for loser in pending:
                        self._discard_loser(loser, pending[loser])
                    if f is not futs[0]:
                        with self._lock:
                            self.hedge_wins += 1
                        if self.obs.metrics:
                            self.obs.registry.counter(
                                "router_hedges_total",
                                "hedge lifecycle events",
                            ).inc(1, event="won")
                    return idx, f.result()
                errors.append(err)
        raise errors[0]

    def drain_hedges(self, timeout: Optional[float] = 10.0) -> None:
        """Block until every discarded hedge leg has landed (tests and
        clean shutdown — a live router never needs to call this)."""
        with self._lock:
            outstanding = list(self._outstanding)
        if outstanding:
            futures_wait(outstanding, timeout=timeout)

    # -- serving ---------------------------------------------------------------

    def search(self, queries) -> RouterResult:
        """Route one (B, d) request; returns the winning replica's answer
        (replicated) or the merged global top-k (sharded)."""
        if self.mode == "sharded":
            return self._search_sharded(queries)
        t0 = self._clock()
        self.requests += 1
        primary, hedge = self._pick(t0)
        hedge_s = (None if self.policy.hedge_after_ms is None
                   else self.policy.hedge_after_ms / 1e3)
        if hedge_s is None or hedge is None:
            # no hedging possible: run inline, skip the pool entirely
            res = self._run_replica(primary, queries)
            return RouterResult(np.asarray(res.ids), np.asarray(res.dists),
                                (self._clock() - t0) * 1e3, primary, False)
        pool = self._ensure_pool()
        fut = pool.submit(self._run_replica, primary, queries)
        hedged = False
        try:
            res, winner = fut.result(timeout=hedge_s), primary
        except FuturesTimeout:
            # deadline risk: race the primary against the next-best replica,
            # first successful answer wins, the loser is deduplicated
            hedged = True
            with self._lock:
                self.hedges += 1
            if self.obs.metrics:
                self.obs.registry.counter(
                    "router_hedges_total", "hedge lifecycle events",
                ).inc(1, event="fired")
            hfut = pool.submit(self._run_replica, hedge, queries)
            winner, res = self._race([(primary, fut), (hedge, hfut)])
        except Exception:
            # primary failed fast: fail over to the hedge immediately
            hedged = True
            with self._lock:
                self.failovers += 1
            res, winner = self._run_replica(hedge, queries), hedge
        return RouterResult(np.asarray(res.ids), np.asarray(res.dists),
                            (self._clock() - t0) * 1e3, winner, hedged)

    def _search_sharded(self, queries) -> RouterResult:
        t0 = self._clock()
        self.requests += 1
        n = len(self._replicas)
        if n == 1:
            res = self._run_replica(0, queries)
            ids = np.asarray(res.ids)
            if self._shard_offsets:
                ids = ids + self._shard_offsets[0]
            return RouterResult(ids, np.asarray(res.dists),
                                (self._clock() - t0) * 1e3, -1, False)
        pool = self._ensure_pool()
        futs = [pool.submit(self._run_replica, i, queries) for i in range(n)]
        results = [f.result() for f in futs]     # every shard is required
        k = np.asarray(results[0].ids).shape[1]
        all_ids, all_dists = [], []
        for i, res in enumerate(results):
            ids = np.asarray(res.ids)
            if self._shard_offsets:
                ids = ids + self._shard_offsets[i]
            all_ids.append(ids)
            all_dists.append(np.asarray(res.dists))
        ids, dists = merge_topk(np.concatenate(all_ids, axis=1),
                                np.concatenate(all_dists, axis=1), k)
        return RouterResult(ids, dists, (self._clock() - t0) * 1e3, -1,
                            False)

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> None:
        self.drain_hedges()
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- observability ---------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """Router counters + per-replica health/latency summaries (sketch
        percentiles within ±1%, counters exact)."""
        now = self._clock()
        with self._lock:
            out: Dict[str, float] = {
                "replicas": float(len(self._replicas)),
                "requests": float(self.requests),
                "hedges": float(self.hedges),
                "hedge_wins": float(self.hedge_wins),
                "hedge_discarded": float(self.hedge_discarded),
                "failovers": float(self.failovers),
            }
            for i, r in enumerate(self._replicas):
                out[f"replica{i}_served"] = float(r.served)
                out[f"replica{i}_errors"] = float(r.errors)
                out[f"replica{i}_healthy"] = float(r.healthy(now))
                if r.sketch.count:
                    out[f"replica{i}_p50_ms"] = r.sketch.quantile(0.5)
                    out[f"replica{i}_p99_ms"] = r.sketch.quantile(0.99)
            return out
