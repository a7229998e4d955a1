"""The port's coalescer, cache and admission control against the reference's.

The same ``tests/serving_harness.py`` schedules (a ``VirtualClock``,
``start=False`` engines driven by ``due_at``/``pump``, modeled service
time) go through ``repro`` and ``repro_torch`` serving the same index file.
Time is virtual, so every decision is deterministic: per-future outcomes,
ids and dists, batch sizes, queue waits, deadline sheds, admission
decisions by priority class and cache hits and misses must all be the
reference's.  The dispatcher thread on the real clock is held against a
direct search.
"""
import numpy as np
import pytest
import torch

from repro.ann import AnnIndex as JIndex
from repro.ann import IndexSpec as JSpec
from repro.ann import SearchParams as JParams
from repro.serve import AdmissionPolicy as JAdmission
from repro.serve import CachePolicy as JCache
from repro.serve.coalescer import _Pending as JPending
from repro.serve.coalescer import select_batch as j_select_batch
from repro_torch.ann import AnnIndex as TIndex
from repro_torch.ann import SearchParams as TParams
from repro_torch.serve import AdmissionPolicy as TAdmission
from repro_torch.serve import CachePolicy as TCache
from repro_torch.serve import DeadlineExceeded
from repro_torch.serve.coalescer import _Pending as TPending
from repro_torch.serve.coalescer import select_batch as t_select_batch
from serving_harness import Arrival, ServingHarness, VirtualClock, \
    poisson_schedule

BUCKETS = (1, 2, 4, 8)
PARAMS = dict(k=10, queue_len=48, m_max=4, num_walkers=4, max_steps=128,
              local_steps=4)
# the coalescer counters, all decided on the virtual clock
COALESCER_KEYS = ("submitted", "served", "served_cache", "rejected_deadline",
                  "rejected_admission", "cancelled", "pending",
                  "batches_dispatched", "batch_size_mean", "batch_size_max",
                  "queue_wait_mean_ms", "queue_wait_p50_ms",
                  "queue_wait_p95_ms", "queue_wait_p99_ms")


@pytest.fixture(scope="module")
def indices(tmp_path_factory):
    rng = np.random.RandomState(5)
    x = rng.randint(-8, 9, size=(1200, 24)).astype(np.float32)
    q = rng.randint(-8, 9, size=(16, 24)).astype(np.float32)
    ref = JIndex.build(x, JSpec(degree=12, passes=1))
    path = ref.save(str(tmp_path_factory.mktemp("coalescer") / "l2"))
    return ref, TIndex.load(path, device="cpu"), q


def _schedule(name, q):
    rng = np.random.default_rng(11)
    if name == "poisson":
        return poisson_schedule(rng, q, qps=1500.0, duration_s=0.03), {}
    if name == "deadlines":
        # offered above the modeled service rate: a backlog builds and
        # late requests are shed at dispatch
        return poisson_schedule(rng, q, qps=4000.0, duration_s=0.02,
                                deadline_ms=5.0), {}
    if name == "admission":
        return (poisson_schedule(rng, q, qps=3000.0, duration_s=0.02,
                                 critical_fraction=0.5),
                {"admission": (JAdmission(throughput_watermark=2,
                                          critical_watermark=5),
                               TAdmission(throughput_watermark=2,
                                          critical_watermark=5))})
    # "cache": four queries in turn, each twice, the repeat 3 ms later; a
    # 3-entry LRU with a 6 ms TTL, so hits, evictions and expirations all
    # happen
    arrivals = []
    for i in range(8):
        arrivals.append(Arrival(t=0.002 * i, query=q[i % 4]))
        arrivals.append(Arrival(t=0.002 * i + 0.003, query=q[i % 4]))
    return arrivals, {"cache": (JCache(capacity=3, ttl_s=0.006),
                                TCache(capacity=3, ttl_s=0.006))}


def _replay(index, params, arrivals, extra):
    clock = VirtualClock()
    srv = index.serve_async(params, start=False, clock=clock,
                            bucket_sizes=BUCKETS, max_wait_ms=2.0, **extra)
    harness = ServingHarness(srv, clock, service_time_s=0.004)
    return srv, harness.run(arrivals)


@pytest.mark.parametrize("name", ["poisson", "deadlines", "admission",
                                  "cache"])
def test_harness_schedule_equals_reference(indices, name):
    ref_idx, port, q = indices
    arrivals, extra = _schedule(name, q)
    ref_srv, ref = _replay(ref_idx, JParams(**PARAMS), arrivals,
                           {k: v[0] for k, v in extra.items()})
    got_srv, got = _replay(port, TParams(**PARAMS), arrivals,
                           {k: v[1] for k, v in extra.items()})
    assert got.outcomes() == ref.outcomes()
    assert got.dispatched == ref.dispatched
    for fr, fg in zip(ref.futures, got.futures):
        if fr.exception(timeout=0) is not None:
            continue
        r, g = fr.result(timeout=0), fg.result(timeout=0)
        np.testing.assert_array_equal(g.ids, np.asarray(r.ids))
        np.testing.assert_array_equal(g.dists, np.asarray(r.dists))
        assert (g.batch_size, g.queue_wait_ms, g.done_t) == \
            (r.batch_size, r.queue_wait_ms, r.done_t)
    sr, sg = ref_srv.stats(), got_srv.stats()
    assert list(sg) == list(sr)
    assert {k: sg[k] for k in COALESCER_KEYS if k in sg} == \
        {k: sr[k] for k in COALESCER_KEYS if k in sr}
    outcomes = set(got.outcomes())
    if name == "deadlines":
        assert sg["rejected_deadline"] > 0 and "DeadlineExceeded" in outcomes
    if name == "admission":
        assert got_srv.admission.stats() == ref_srv.admission.stats()
        assert got_srv.admission.stats()["shed_throughput"] > 0
        assert "AdmissionRejected" in outcomes
    if name == "cache":
        cs = got_srv.cache.stats()
        assert cs == ref_srv.cache.stats()
        assert cs["hits"] > 0 and cs["evictions"] > 0
        assert cs["expirations"] > 0
    ref_srv.close(), got_srv.close()


def test_select_batch_equals_reference():
    rng = np.random.RandomState(6)
    for trial in range(20):
        n = rng.randint(1, 30)
        deadlines = [None if rng.rand() < 0.3 else float(rng.randint(0, 8))
                     for _ in range(n)]
        prios = rng.randint(0, 2, n)
        now, max_batch = float(rng.randint(0, 6)), int(rng.randint(1, 10))

        def pend(cls):
            return [cls(seq=i, query=np.zeros(2, np.float32), enqueue_t=0.0,
                        deadline_t=d, future=None, priority=int(p))
                    for i, (d, p) in enumerate(zip(deadlines, prios))]
        want = j_select_batch(pend(JPending), now, max_batch)
        got = t_select_batch(pend(TPending), now, max_batch)
        assert [[p.seq for p in part] for part in got] == \
            [[p.seq for p in part] for part in want], trial


def test_dispatcher_thread_equals_direct_search(indices):
    """The real clock and the dispatcher thread: every future equals a
    direct single-query search; tensor queries are taken as they are."""
    _, port, q = indices
    params = TParams(**PARAMS)
    with port.serve_async(params, bucket_sizes=BUCKETS,
                          max_wait_ms=1.0) as srv:
        futs = [srv.submit(torch.from_numpy(v) if i % 2 else v)
                for i, v in enumerate(q)]
        results = [f.result(timeout=60) for f in futs]
    for v, res in zip(q, results):
        want = port.search(v[None], params)
        np.testing.assert_array_equal(res.ids, want.ids[0].numpy())
        np.testing.assert_array_equal(res.dists, want.dists[0].numpy())
        assert 1 <= res.batch_size <= 8
    st = srv.stats()
    assert st["served"] == len(q) and st["pending"] == 0


def test_expired_deadline_and_cancel(indices):
    _, port, q = indices
    clock = VirtualClock()
    srv = port.serve_async(TParams(**PARAMS), start=False,
                           bucket_sizes=BUCKETS, clock=clock)
    dead = srv.submit(q[0], deadline_ms=1.0)
    gone = srv.submit(q[1])
    live = srv.submit(q[2], deadline_ms=10_000.0)
    assert gone.cancel()
    clock.advance(0.005)                         # the deadline lapses
    srv.flush()
    with pytest.raises(DeadlineExceeded):
        dead.result(timeout=0)
    assert gone.cancelled()
    assert live.result(timeout=0).ids.shape == (PARAMS["k"],)
    assert not live.cancel()
    st = srv.stats()
    assert (st["rejected_deadline"], st["cancelled"], st["served"]) == \
        (1.0, 1.0, 1.0)
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(q[0])
    with pytest.raises(ValueError, match="ONE query"):
        port.serve_async(TParams(**PARAMS), start=False).submit(q[:3])
