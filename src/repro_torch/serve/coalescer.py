"""Async request coalescing for ANN serving: single queries in, buckets out.

Port of ``repro.serve.coalescer``.  A query may come as numpy or as a
tensor on any device; the coalescer holds it on the host and the engine
moves each coalesced batch to the index's device.

The batched :class:`~repro_torch.serve.ann_engine.AnnEngine` already serves
fluctuating *batch* traffic through a bounded bucket ladder; real online
traffic, though, arrives as SINGLE queries, each with its own latency
budget.  This module is the layer between the two: an async request queue
that

* accepts one query at a time (``submit`` returns a
  :class:`concurrent.futures.Future` immediately — callers never block the
  dispatcher),
* coalesces pending requests into batches under a **max-batch / max-wait**
  policy (:class:`CoalescePolicy`): a batch is flushed as soon as
  ``max_batch`` requests are pending OR the oldest pending request has
  waited ``max_wait_ms``, whichever comes first,
* forms batches in **earliest-deadline-first** order and rejects requests
  whose deadline has already expired at dispatch time
  (:class:`DeadlineExceeded` — cheaper than serving an answer nobody is
  waiting for),
* dispatches through the engine's bucket ladder (``AnnEngine.search``),
  so a coalesced batch of any size runs through a warmed searcher, and
* slices the batched result back into per-request futures.

Coalescing is *transparent*: the per-query lanes of the batched searcher are
independent (every op of the traversal is per lane), so a query served in a
coalesced batch returns results bit-identical to the same query through
``AnnIndex.search`` — pinned by ``tests/test_torch_coalescer.py``.

Typical use::

    engine = index.serve(params)                 # batched AnnEngine
    with AsyncAnnEngine(engine, CoalescePolicy(max_batch=16,
                                               max_wait_ms=2.0)) as srv:
        futs = [srv.submit(q, deadline_ms=50.0) for q in queries]
        for f in futs:
            res = f.result()                     # AsyncServeResult
            print(res.ids, res.queue_wait_ms, res.batch_size)
    print(srv.stats())                           # coalescing observability

Or in one step from the facade: ``index.serve_async(params, max_batch=16)``.

The serving tier composes here.  ``cache=`` probes a
:class:`~repro_torch.serve.cache.ResultCache` BEFORE anything queues (a
hit resolves the future immediately, for free); ``admission=`` applies
:class:`~repro_torch.serve.admission.AdmissionPolicy` queue-depth watermarks
per priority class (a shed request's future gets
:class:`~repro_torch.serve.admission.AdmissionRejected`); ``submit(...,
priority=...)`` ranks the two classes in batch formation — critical before
throughput, earliest deadline first within each class.  ``clock=`` injects
a virtual clock (with ``start=False`` plus :meth:`due_at`/:meth:`pump`)
so every timing test in ``tests/serving_harness.py`` runs without sleeping.
"""
from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.obs import NULL_OBS, LogHistogram, Observability
from repro_torch.serve.admission import (PRIORITIES, AdmissionController,
                                   AdmissionPolicy, AdmissionRejected)
from repro_torch.serve.cache import CachePolicy, ResultCache

__all__ = ["CoalescePolicy", "DeadlineExceeded", "AsyncServeResult",
           "AsyncAnnEngine"]


class CoalescePolicy(NamedTuple):
    """Batch-formation policy: flush on size OR age, whichever first.

    * ``max_batch`` — flush as soon as this many requests are pending.
      Usually set to the engine's top bucket so a full flush fills the
      biggest bucket exactly.
    * ``max_wait_ms`` — flush when the OLDEST pending request has waited
      this long, even if the batch is not full.  This bounds the queueing
      delay added by coalescing: a lone request is served at most
      ``max_wait_ms`` after arrival.
    * ``default_deadline_ms`` — deadline applied to requests submitted
      without one (None = no deadline: the request never expires).
    """
    max_batch: int = 32
    max_wait_ms: float = 2.0
    default_deadline_ms: Optional[float] = None


class DeadlineExceeded(Exception):
    """The request's deadline expired before dispatch; its future receives
    this exception instead of a result."""


class AsyncServeResult(NamedTuple):
    """Per-request result, sliced out of the coalesced batch."""
    ids: np.ndarray          # (k,) int32
    dists: np.ndarray        # (k,) float32
    queue_wait_ms: float     # time spent queued before dispatch
    batch_size: float        # true size of the coalesced batch served with
    latency_ms: float        # engine wall clock for the whole batch
    done_t: float            # perf_counter seconds when the result was
    #                          resolved — client-observed latency is
    #                          ``done_t - submit-side perf_counter`` (do NOT
    #                          clock future callbacks: waiters wake BEFORE
    #                          done-callbacks run)


class _Pending(NamedTuple):
    """One queued request.  Sort key = (priority, deadline, seq): critical
    class before throughput class, earliest deadline first within a class,
    FIFO among equal deadlines (seq is the admission counter).  With a
    single traffic class (priority defaults to 0) this is pure EDF."""
    seq: int
    query: np.ndarray        # (d,)
    enqueue_t: float         # clock seconds
    deadline_t: Optional[float]   # absolute clock seconds, or None
    future: Future
    priority: int = 0        # PRIORITIES rank: 0 = critical, 1 = throughput
    cache_key: Optional[bytes] = None   # set when a result cache is attached

    @property
    def sort_key(self):
        d = self.deadline_t if self.deadline_t is not None else float("inf")
        return (self.priority, d, self.seq)


def select_batch(pending: List[_Pending], now: float, max_batch: int
                 ) -> tuple:
    """Pure batch-formation step (unit-testable without threads).

    Splits ``pending`` into (batch, expired, rest): the up-to-``max_batch``
    most urgent live requests in (priority, deadline, arrival) order —
    critical class before throughput, earliest deadline first within a
    class — the requests whose deadline has already passed at ``now``, and
    the remainder (still queued, in arrival order).
    """
    expired = [p for p in pending
               if p.deadline_t is not None and p.deadline_t < now]
    live = sorted((p for p in pending
                   if p.deadline_t is None or p.deadline_t >= now),
                  key=lambda p: p.sort_key)
    batch, rest = live[:max_batch], live[max_batch:]
    rest.sort(key=lambda p: p.seq)
    return batch, expired, rest


class AsyncAnnEngine:
    """Async coalescing front-end over a batched serving engine.

    ``engine`` is anything with ``search(queries (B, d)) -> ServeResult``
    and a ``cfg.k`` — in practice an :class:`~repro_torch.serve.AnnEngine`
    (the port serves the single-device mode) or a
    :class:`~repro_torch.serve.ReplicaRouter` over several.

    With ``start=False`` no dispatcher thread runs and batches are formed
    only by explicit :meth:`flush` / :meth:`pump` calls — deterministic, for
    tests and for callers that drive their own event loop.

    ``cache`` / ``admission`` accept either a policy (a
    :class:`~repro_torch.serve.cache.CachePolicy` /
    :class:`~repro_torch.serve.admission.AdmissionPolicy`, wrapped here sharing
    this engine's obs and clock) or a ready-made
    :class:`~repro_torch.serve.cache.ResultCache` /
    :class:`~repro_torch.serve.admission.AdmissionController` (e.g. one cache
    shared across several engines).  ``clock`` is any zero-arg callable
    returning seconds; injecting a virtual clock is only deterministic with
    ``start=False`` (the dispatcher thread's condition waits are real time).
    """

    def __init__(self, engine, policy: CoalescePolicy = CoalescePolicy(), *,
                 start: bool = True, obs: Optional[Observability] = None,
                 cache: Optional[Union[CachePolicy, ResultCache]] = None,
                 admission: Optional[Union[AdmissionPolicy,
                                           AdmissionController]] = None,
                 clock=None):
        if policy.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if policy.max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        self.engine = engine
        self.policy = policy
        # the tracing/metrics bundle: explicit obs wins, else inherit the
        # engine's so one handle covers the whole serving stack
        self.obs = obs if obs is not None \
            else getattr(engine, "obs", None) or NULL_OBS
        self._clock = clock if clock is not None else time.perf_counter
        if isinstance(cache, CachePolicy):
            cache = ResultCache(cache, clock=self._clock, obs=self.obs)
        self.cache: Optional[ResultCache] = cache
        if isinstance(admission, AdmissionPolicy):
            admission = AdmissionController(admission, obs=self.obs,
                                            clock=self._clock)
        self.admission: Optional[AdmissionController] = admission
        self._pending: List[_Pending] = []
        self._lock = threading.Condition()
        self._seq = itertools.count()
        self._closed = False
        self._inflight = 0       # flushes past batch pick-up, pre-resolve
        # observability — distributions live in bounded log-bucketed
        # sketches (constant memory under sustained traffic, mergeable)
        self.submitted = 0
        self.served = 0
        self.served_cache = 0
        self.rejected_deadline = 0
        self.rejected_admission = 0
        self.cancelled = 0
        self.batches_dispatched = 0
        self._batch_size_hist = LogHistogram()
        self._queue_wait_hist = LogHistogram()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._dispatch_loop, name="ann-coalescer", daemon=True)
            self._thread.start()

    # -- client side ---------------------------------------------------------

    def submit(self, query, *, deadline_ms: Optional[float] = None,
               priority: str = "critical") -> Future:
        """Enqueue one query ``(d,)`` (or ``(1, d)``); returns a Future that
        resolves to an :class:`AsyncServeResult` — or raises
        :class:`DeadlineExceeded` if the deadline expires before dispatch,
        or :class:`~repro_torch.serve.admission.AdmissionRejected` if the
        request is shed at admission.  A tensor query is copied to the
        host.

        ``deadline_ms`` is relative to NOW (submission time); it bounds
        QUEUE time, not total time — a request dispatched just inside its
        deadline still runs to completion.  ``priority`` is one of
        ``repro_torch.serve.admission.PRIORITIES``; it selects the admission
        watermark and the request's rank in batch formation.  With a result
        cache attached, a hit resolves the future before any of that — a
        replay is never queued, never shed, and costs no engine work.
        """
        if isinstance(query, torch.Tensor):
            query = query.detach().cpu().numpy()
        q = np.asarray(query, np.float32)
        if q.ndim == 2 and q.shape[0] == 1:
            q = q[0]
        if q.ndim != 1:
            raise ValueError(
                f"submit takes ONE query (d,); got shape {q.shape} — "
                "for ready-made batches call engine.search directly")
        if priority not in PRIORITIES:
            raise ValueError(
                f"unknown priority {priority!r}; one of {PRIORITIES}")
        if deadline_ms is None:
            deadline_ms = self.policy.default_deadline_ms
        now = self._clock()
        fut: Future = Future()
        key: Optional[bytes] = None
        if self.cache is not None:
            key = self.cache.key_for(q)
            hit = self.cache.lookup(q, key=key, now=now)
            if hit is not None:
                seq = next(self._seq)
                with self._lock:
                    if self._closed:
                        raise RuntimeError("AsyncAnnEngine is closed")
                    self.submitted += 1
                    self.served_cache += 1
                # replay: zero queue time, no batch, no engine latency —
                # counted as served_cache, NOT served (engine batches only)
                self.obs.tracer.async_begin(
                    "request", seq, cat="request",
                    args={"deadline_ms": deadline_ms, "cache": "hit"})
                fut.set_result(AsyncServeResult(
                    ids=hit[0], dists=hit[1], queue_wait_ms=0.0,
                    batch_size=0.0, latency_ms=0.0, done_t=now))
                self.obs.tracer.async_end("request", seq,
                                          args={"outcome": "cache_hit"})
                if self.obs.metrics:
                    self.obs.registry.counter(
                        "coalescer_requests_total",
                        "requests by final outcome",
                    ).inc(1, outcome="cache_hit")
                return fut
        item = _Pending(
            seq=next(self._seq), query=q, enqueue_t=now,
            deadline_t=None if deadline_ms is None
            else now + deadline_ms / 1e3,
            future=fut, priority=PRIORITIES.index(priority), cache_key=key)
        with self._lock:
            if self._closed:
                raise RuntimeError("AsyncAnnEngine is closed")
            self.submitted += 1
            # admission looks at the queue depth under the SAME lock that
            # guards the queue, so the watermark comparison is exact
            if (self.admission is not None
                    and not self.admission.admit(len(self._pending),
                                                 priority)):
                self.rejected_admission += 1
                shed = True
            else:
                shed = False
                self._pending.append(item)
                # async ("b"/"e") request lifeline: opened here INSIDE the
                # lock — before notify_all can wake a dispatcher that would
                # otherwise resolve (async_end) the request first — closed
                # on the dispatcher thread at resolve time.  This is the
                # cross-thread view Perfetto draws above the span stacks.
                self.obs.tracer.async_begin(
                    "request", item.seq, cat="request",
                    args={"deadline_ms": deadline_ms, "priority": priority})
                self._lock.notify_all()
        if shed:
            if self.obs.metrics:
                self.obs.registry.counter(
                    "coalescer_requests_total", "requests by final outcome",
                ).inc(1, outcome="rejected_admission")
            fut.set_exception(AdmissionRejected(
                f"queue depth at {priority!r} watermark "
                f"({self.admission.policy.watermark(priority)}) — request "
                "shed at admission"))
        return fut

    # -- dispatch ------------------------------------------------------------

    def _oldest_age_s(self, now: float) -> float:
        return now - min(p.enqueue_t for p in self._pending)

    def _dispatch_loop(self):
        self.obs.tracer.name_thread("coalescer-dispatch")
        max_wait_s = self.policy.max_wait_ms / 1e3
        while True:
            with self._lock:
                while not self._pending and not self._closed:
                    self._lock.wait()
                if self._closed and not self._pending:
                    return
                # flush when full, else sleep out the oldest request's
                # remaining wait budget (new arrivals re-notify)
                now = self._clock()
                if (len(self._pending) < self.policy.max_batch
                        and self._oldest_age_s(now) < max_wait_s
                        and not self._closed):
                    self._lock.wait(max_wait_s - self._oldest_age_s(now))
                    continue
            self._flush_once()

    def flush(self) -> int:
        """Synchronously dispatch pending requests (one batch per call
        until the queue is empty); returns the number of requests resolved.
        The deterministic path for ``start=False`` engines and tests."""
        n = 0
        while True:
            served = self._flush_once()
            if served == 0:
                return n
            n += served

    def _due_locked(self, now: float) -> bool:
        """True when the policy calls for a flush at ``now`` (lock held):
        the queue is full, the oldest request has aged out its wait budget,
        or the engine is closing — EXACTLY the dispatcher thread's wake
        conditions, so a pump-driven test sees the same batch boundaries a
        live engine would.  (Expired deadlines are shed at the next policy
        flush, not eagerly: a deadline alone never forces a partial batch.)
        """
        if not self._pending:
            return False
        if self._closed or len(self._pending) >= self.policy.max_batch:
            return True
        return self._oldest_age_s(now) >= self.policy.max_wait_ms / 1e3

    def due_at(self) -> Optional[float]:
        """Earliest clock time at which a flush becomes due, or None with
        an empty queue.  Returns ``now`` when one is due already.  This is
        the scheduling signal the deterministic serving harness
        (``tests/serving_harness.py``) advances its virtual clock to —
        batch formation follows the policy exactly, without sleeping."""
        with self._lock:
            now = self._clock()
            if not self._pending:
                return None
            if self._due_locked(now):
                return now
            return (min(p.enqueue_t for p in self._pending)
                    + self.policy.max_wait_ms / 1e3)

    def pump(self, max_batches: Optional[int] = None) -> int:
        """Dispatch batches only while the policy says one is DUE (contrast
        :meth:`flush`, which force-drains).  Returns requests resolved.
        With ``start=False`` and an injected clock this is the event-loop
        step: advance the clock to :meth:`due_at`, then ``pump()``."""
        resolved = 0
        batches = 0
        while max_batches is None or batches < max_batches:
            with self._lock:
                if not self._due_locked(self._clock()):
                    break
            n = self._flush_once()
            if n == 0:      # drained by a concurrent flush
                break
            resolved += n
            batches += 1
        return resolved

    def _flush_once(self) -> int:
        with self._lock:
            if not self._pending:
                return 0
            # committed: from here until the finally, close(drain=True)
            # must wait — the batch leaves _pending BEFORE its futures
            # resolve, so "queue empty" alone does not mean "drained"
            self._inflight += 1
        try:
            return self._flush_committed()
        finally:
            with self._lock:
                self._inflight -= 1
                self._lock.notify_all()

    def _flush_committed(self) -> int:
        tracer = self.obs.tracer
        resolved = 0
        n_shed = n_cancelled = 0
        live: List[_Pending] = []
        with tracer.span("batch_formation", cat="coalescer") as sp:
            with self._lock:
                if not self._pending:
                    return 0   # drained by a concurrent flush
                now = self._clock()
                n_pending = len(self._pending)
                batch, expired, rest = select_batch(
                    self._pending, now, self.policy.max_batch)
                self._pending = rest
            # the EDF decision, as the trace records it: who was picked, in
            # what order, who was shed, who stays queued
            sp.add_args(pending=n_pending, batch=len(batch),
                        shed=len(expired), deferred=len(rest),
                        edf_order=[p.seq for p in batch])
            # set_running_or_notify_cancel guards every resolution: a future
            # the CLIENT cancelled while it was queued must be dropped, not
            # written to — set_result on a cancelled future raises
            # InvalidStateError, which would kill the dispatcher thread and
            # hang every later caller
            for p in expired:
                resolved += 1
                if p.future.set_running_or_notify_cancel():
                    with self._lock:
                        self.rejected_deadline += 1
                    n_shed += 1
                    late_ms = 1e3 * (now - p.deadline_t)
                    sp.event("deadline_shed",
                             {"req": p.seq, "late_ms": round(late_ms, 3)})
                    tracer.async_end("request", p.seq,
                                     args={"outcome": "shed"})
                    p.future.set_exception(DeadlineExceeded(
                        f"deadline expired {late_ms:.2f} ms before dispatch"))
                else:
                    with self._lock:
                        self.cancelled += 1
                    n_cancelled += 1
                    tracer.async_end("request", p.seq,
                                     args={"outcome": "cancelled"})
            for p in batch:
                if p.future.set_running_or_notify_cancel():
                    live.append(p)   # now RUNNING: cancel() can no longer win
                else:
                    resolved += 1
                    with self._lock:
                        self.cancelled += 1
                    n_cancelled += 1
                    tracer.async_end("request", p.seq,
                                     args={"outcome": "cancelled"})
        if self.obs.metrics and (n_shed or n_cancelled):
            out = self.obs.registry.counter(
                "coalescer_requests_total", "requests by final outcome")
            if n_shed:
                out.inc(n_shed, outcome="shed")
            if n_cancelled:
                out.inc(n_cancelled, outcome="cancelled")
        if not live:
            return resolved
        queries = np.stack([p.query for p in live])
        # engine.search runs inside this span on the same thread, so its
        # engine.search/device_compute spans nest under dispatch by
        # containment
        with tracer.span("dispatch", cat="coalescer",
                         args={"batch": len(live)}):
            try:
                res = self.engine.search(queries)
            except Exception as e:  # noqa: BLE001 - failure goes to callers
                for p in live:
                    tracer.async_end("request", p.seq,
                                     args={"outcome": "error"})
                    p.future.set_exception(e)
                return resolved + len(live)
        done_t = self._clock()
        with tracer.span("resolve", cat="coalescer",
                         args={"batch": len(live)}):
            with self._lock:
                self.batches_dispatched += 1
                self._batch_size_hist.observe(len(live))
                self.served += len(live)
                waits = [(now - p.enqueue_t) * 1e3 for p in live]
                for w in waits:
                    self._queue_wait_hist.observe(w)
            if self.obs.metrics:
                reg = self.obs.registry
                reg.counter("coalescer_requests_total",
                            "requests by final outcome"
                            ).inc(len(live), outcome="served")
                qw = reg.histogram("coalescer_queue_wait_ms",
                                   "queue time before dispatch")
                for w in waits:
                    qw.observe(w)
                reg.histogram("coalescer_batch_size",
                              "true size of dispatched batches"
                              ).observe(len(live))
            for i, p in enumerate(live):
                if self.cache is not None and p.cache_key is not None:
                    # populate BEFORE resolving so a client that re-submits
                    # the moment its future completes already hits
                    self.cache.insert(p.query, res.ids[i], res.dists[i],
                                      key=p.cache_key, now=done_t)
                p.future.set_result(AsyncServeResult(
                    ids=res.ids[i], dists=res.dists[i],
                    queue_wait_ms=waits[i], batch_size=float(len(live)),
                    latency_ms=res.latency_ms, done_t=done_t))
                tracer.async_end(
                    "request", p.seq,
                    args={"outcome": "served",
                          "queue_wait_ms": round(waits[i], 3)})
        return resolved + len(live)

    # -- lifecycle -----------------------------------------------------------

    def close(self, drain: bool = True):
        """Stop accepting requests; by default drain the queue first.  With
        ``drain=False`` still-queued futures are cancelled.

        Draining waits for IN-FLIGHT batches too: a flush that has popped
        its batch but not yet resolved the futures leaves the queue empty
        while work is outstanding, so close loops (flush + wait) until the
        queue is empty AND no flush is mid-dispatch — only then is every
        accepted future settled (the drain-under-load regression test in
        ``tests/test_serve_tier.py`` pins this)."""
        with self._lock:
            self._closed = True
            if not drain:
                for p in self._pending:
                    p.future.cancel()
                self._pending = []
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if drain:
            while True:
                self.flush()
                with self._lock:
                    if not self._pending and not self._inflight:
                        return
                    if self._inflight:
                        # the 1 s timeout only guards a lost wakeup; the
                        # finally-block notify fires as each flush lands
                        self._lock.wait(timeout=1.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- observability -------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """Coalescing-level counters + queue-wait distribution.  The wrapped
        engine's own ``stats()`` (per-bucket latency percentiles,
        searcher-cache counters) stays separate under ``self.engine.stats()``.

        Distributions come from bounded log-bucketed sketches
        (``repro_torch.obs.LogHistogram``): memory is constant under sustained
        traffic; ``*_mean``/``*_max`` are exact, percentile keys are
        bucket-resolved within ±1% (see docs/observability.md)."""
        with self._lock:
            out = {
                "submitted": float(self.submitted),
                "served": float(self.served),
                "served_cache": float(self.served_cache),
                "rejected_deadline": float(self.rejected_deadline),
                "rejected_admission": float(self.rejected_admission),
                "cancelled": float(self.cancelled),
                "pending": float(len(self._pending)),
                "batches_dispatched": float(self.batches_dispatched),
            }
        if self._batch_size_hist.count:
            out.update(batch_size_mean=self._batch_size_hist.mean,
                       batch_size_max=self._batch_size_hist.max)
        qw = self._queue_wait_hist
        if qw.count:
            out.update(
                queue_wait_mean_ms=qw.mean,
                queue_wait_p50_ms=qw.quantile(0.50),
                queue_wait_p95_ms=qw.quantile(0.95),
                queue_wait_p99_ms=qw.quantile(0.99),
            )
        return out
