"""The port's replica router against the reference's.

Replicated routing over port engines must equal one engine bit for bit,
directly and under the coalescer, from several client threads and with
hedges firing; a hedged request resolves once; failover and recovery follow
an injected clock; the sharded fan-out and ``merge_topk`` equal the
reference's.  Test doubles stand in for replicas where timing or failure
must be forced.
"""
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from repro.ann import AnnIndex as JIndex
from repro.ann import IndexSpec as JSpec
from repro.ann import SearchParams as JParams
from repro.serve import ReplicaRouter as JRouter
from repro.serve import RouterPolicy as JPolicy
from repro.serve.router import merge_topk as j_merge_topk
from repro_torch.ann import AnnIndex as TIndex
from repro_torch.ann import SearchParams as TParams
from repro_torch.serve import AsyncAnnEngine, CoalescePolicy
from repro_torch.serve import ReplicaRouter as TRouter
from repro_torch.serve import RouterPolicy as TPolicy
from repro_torch.serve.router import merge_topk as t_merge_topk
from serving_harness import VirtualClock

BUCKETS = (1, 2, 4, 8)
PARAMS = dict(k=10, queue_len=48, m_max=4, num_walkers=4, max_steps=128,
              local_steps=4)


@pytest.fixture(scope="module")
def indices(tmp_path_factory):
    rng = np.random.RandomState(8)
    x = rng.randint(-8, 9, size=(1200, 24)).astype(np.float32)
    q = rng.randint(-8, 9, size=(16, 24)).astype(np.float32)
    ref = JIndex.build(x, JSpec(degree=12, passes=1))
    path = ref.save(str(tmp_path_factory.mktemp("router") / "l2"))
    return ref, TIndex.load(path, device="cpu"), q


class _Res:
    def __init__(self, ids, dists):
        self.ids, self.dists, self.latency_ms = ids, dists, 0.25


class FakeEngine:
    """Deterministic per-query answers derived from the query itself."""

    def search(self, queries):
        q = np.atleast_2d(np.asarray(queries, np.float32))
        return _Res(np.rint(q[:, :4] * 100).astype(np.int32),
                    q[:, :4] * np.float32(0.5))


def test_router_parity_with_single_engine(indices):
    ref_idx, port, q = indices
    params = TParams(**PARAMS)
    direct = port.search(q[:4], params)
    ref_router = JRouter([ref_idx.serve(JParams(**PARAMS),
                                        bucket_sizes=BUCKETS)
                          for _ in range(2)],
                         policy=JPolicy(strategy="round_robin"))
    router = TRouter([port.serve(params, bucket_sizes=BUCKETS)
                      for _ in range(2)],
                     policy=TPolicy(strategy="round_robin"))
    for turn in range(2):                  # both replicas take a turn
        res, want = router.search(q[:4]), ref_router.search(q[:4])
        np.testing.assert_array_equal(res.ids, direct.ids.numpy())
        np.testing.assert_array_equal(res.dists, direct.dists.numpy())
        np.testing.assert_array_equal(res.ids, want.ids)
        np.testing.assert_array_equal(res.dists, want.dists)
        assert (res.replica, res.hedged) == (want.replica, want.hedged)
    srv = AsyncAnnEngine(router, CoalescePolicy(max_batch=8), start=False)
    futs = [srv.submit(v) for v in q[:4]]
    srv.flush()
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result().ids, direct.ids[i].numpy())
    srv.close()
    st = router.stats()
    assert list(st) == list(ref_router.stats())
    assert st["replica0_served"] + st["replica1_served"] == 3
    router.close(), ref_router.close()


def test_hedges_from_client_threads_resolve_once(indices):
    """Four client threads, two real replicas and a hedge that fires on
    every request: each answer equals the single engine's, each request
    resolves once, and the redundant legs are counted."""
    _, port, q = indices
    params = TParams(**PARAMS)
    want = port.search(q, params)
    router = TRouter([port.serve(params, bucket_sizes=BUCKETS)
                      for _ in range(2)],
                     policy=TPolicy(hedge_after_ms=0.0))
    with ThreadPoolExecutor(max_workers=4) as pool:
        results = list(pool.map(lambda i: router.search(q[i:i + 1]),
                                range(len(q))))
    router.drain_hedges()
    for i, res in enumerate(results):
        np.testing.assert_array_equal(res.ids[0], want.ids[i].numpy())
        np.testing.assert_array_equal(res.dists[0], want.dists[i].numpy())
    st = router.stats()
    assert st["requests"] == len(q)
    assert st["hedges"] == sum(r.hedged for r in results) > 0
    assert st["hedge_discarded"] == st["hedges"] - st["failovers"]
    assert st["replica0_served"] + st["replica1_served"] == \
        len(q) + st["hedges"]
    router.close()


def test_hedged_request_resolves_once_and_dedups():
    slow_gate = threading.Event()

    class SlowEngine(FakeEngine):
        def search(self, queries):
            assert slow_gate.wait(timeout=30)
            return super().search(queries)

    router = TRouter([SlowEngine(), FakeEngine()],
                     policy=TPolicy(strategy="round_robin",
                                    hedge_after_ms=5.0))
    q = np.arange(8, dtype=np.float32)[None]
    res = router.search(q)
    assert res.hedged and res.replica == 1
    np.testing.assert_array_equal(res.ids, FakeEngine().search(q).ids)
    slow_gate.set()
    router.drain_hedges()
    st = router.stats()
    assert (st["requests"], st["hedges"], st["hedge_wins"],
            st["hedge_discarded"]) == (1.0, 1.0, 1.0, 1.0)
    router.close()


def test_failover_marks_unhealthy_then_recovers():
    """The same failure script through both packages, on virtual clocks:
    the same replicas answer and the same stats come out."""
    def script(router_cls, policy_cls):
        clock = VirtualClock()

        class DownEngine(FakeEngine):
            down = True

            def search(self, queries):
                if self.down:
                    raise RuntimeError("replica down")
                return super().search(queries)

        flaky = DownEngine()
        router = router_cls(
            [flaky, FakeEngine()],
            policy=policy_cls(strategy="round_robin", hedge_after_ms=50.0,
                              max_failures=1, cooldown_s=10.0),
            clock=clock)
        q = np.arange(8, dtype=np.float32)[None]
        seen = [router.search(q)]               # fails over
        seen.append(router.search(q))           # the unhealthy one skipped
        healthy = router.stats()["replica0_healthy"]
        flaky.down = False
        clock.advance(11.0)                     # the cooldown lapses
        seen.append(router.search(q))           # re-probed and serving
        st = router.stats()
        router.close()
        return [(r.replica, r.hedged) for r in seen], healthy, st

    ref, got = script(JRouter, JPolicy), script(TRouter, TPolicy)
    assert got[0] == ref[0] == [(1, True), (1, False), (0, False)]
    assert got[1] == ref[1] == 0.0
    keys = [k for k in ref[2] if not k.endswith("_ms")]
    assert {k: got[2][k] for k in keys} == {k: ref[2][k] for k in keys}
    assert got[2]["failovers"] == 1.0


def test_merge_topk_equals_reference():
    rng = np.random.RandomState(4)
    for b, s, k in ((1, 2, 4), (5, 3, 10), (8, 4, 7)):
        ids = rng.randint(0, 50, size=(b, s * k)).astype(np.int32)
        dists = rng.randint(0, 6, size=(b, s * k)).astype(np.float32)
        dists[:, ::5] = np.inf
        want, got = j_merge_topk(ids, dists, k), t_merge_topk(ids, dists, k)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)


def test_sharded_router_merges_as_reference():
    class Shard(FakeEngine):
        def __init__(self, dists):
            self._d = np.asarray(dists, np.float32)

        def search(self, queries):
            b = np.atleast_2d(queries).shape[0]
            return _Res(np.tile(np.arange(4, dtype=np.int32), (b, 1)),
                        np.tile(self._d, (b, 1)))
    shards = ([0.1, 0.4, 0.6, 0.9], [0.2, 0.3, 0.7, 0.8])
    out = []
    for router_cls in (JRouter, TRouter):
        router = router_cls([Shard(d) for d in shards], mode="sharded",
                            shard_offsets=[0, 1000])
        out.append(router.search(np.ones((2, 8), np.float32)))
        router.close()
    ref, got = out
    np.testing.assert_array_equal(got.ids, ref.ids)
    np.testing.assert_array_equal(got.dists, ref.dists)
    np.testing.assert_array_equal(got.ids[0], [0, 1000, 1001, 1])
    assert got.replica == ref.replica == -1


@pytest.mark.parametrize("router_cls,policy_cls", [(JRouter, JPolicy),
                                                   (TRouter, TPolicy)])
def test_router_validation(router_cls, policy_cls):
    with pytest.raises(ValueError, match="at least one"):
        router_cls([])
    with pytest.raises(ValueError, match="mode"):
        router_cls([FakeEngine()], mode="mirrored")
    with pytest.raises(ValueError, match="strategy"):
        router_cls([FakeEngine()], policy=policy_cls(strategy="random"))
    with pytest.raises(ValueError, match="hedge_after_ms"):
        router_cls([FakeEngine()], policy=policy_cls(hedge_after_ms=-1.0))
    with pytest.raises(ValueError, match="shard offset"):
        router_cls([FakeEngine(), FakeEngine()], mode="sharded",
                   shard_offsets=[0])
    with pytest.raises(ValueError, match="sharded"):
        router_cls([FakeEngine()], shard_offsets=[0])
