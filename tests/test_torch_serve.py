"""The port's AnnEngine against the reference's.

``repro`` builds small indices on integer data (so every f32 sum is exact)
and saves them; the port loads each file on the CPU.  Both engines serve
the same stream of requests, and every request must give the same ids,
dists, all eight ``SearchStats`` counters and buckets; the engines' padding
and cache counters, ``stats()`` keys and their order must be the
reference's.  The facade path, the legacy ``(PaddedCSR, SearchConfig)``
path and the hnsw descent are covered; the sharded modes raise.
"""
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro.ann import AnnIndex as JIndex
from repro.ann import IndexSpec as JSpec
from repro.ann import SearchParams as JParams
from repro.core.config import SearchConfig as JConfig
from repro.serve import AnnEngine as JEngine
from repro_torch.ann import AnnIndex as TIndex
from repro_torch.ann import SearchParams as TParams
from repro_torch.core.config import SearchConfig as TConfig
from repro_torch.serve import AnnEngine as TEngine
from repro_torch.serve import AsyncAnnEngine
from repro_torch.serve.ann_engine import DEFAULT_BUCKETS

BUCKETS = (1, 2, 4, 8)
STREAM = (1, 3, 7, 4, 2, 8, 11)
PARAMS = dict(k=10, queue_len=48, m_max=4, num_walkers=4, max_steps=128,
              local_steps=4)
SPECS = {"l2": dict(), "grouped": dict(n_top_fraction=0.05),
         "hnsw": dict(builder="hnsw")}
# the engine counters that do not depend on the wall clock
COUNTERS = ("queries_served", "requests_served", "padded_queries",
            "jit_cache_size", "cache_hits", "cache_misses",
            "dist_comps_total", "uniq_comps_total", "batch_dup_comps_total",
            "batch_dup_ratio")


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(3)
    x = rng.randint(-8, 9, size=(1200, 24)).astype(np.float32)
    q = rng.randint(-8, 9, size=(sum(STREAM), 24)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def files(data, tmp_path_factory):
    x, _ = data
    root = tmp_path_factory.mktemp("serve")
    out = {}
    for name, kw in SPECS.items():
        idx = JIndex.build(x, JSpec(degree=12, passes=1, **kw))
        out[name] = (idx, idx.save(str(root / name)))
    return out


def _requests(q):
    lo = 0
    for n in STREAM:
        yield q[lo:lo + n]
        lo += n


def _same_result(ref, got):
    np.testing.assert_array_equal(got.ids, np.asarray(ref.ids))
    np.testing.assert_array_equal(got.dists, np.asarray(ref.dists))
    for name, r, g in zip(ref.stats._fields, ref.stats, got.stats):
        np.testing.assert_array_equal(g, np.asarray(r), err_msg=name)
    assert got.buckets == ref.buckets


def _same_engines(ref, got):
    sr, sg = ref.stats(), got.stats()
    assert list(sg) == list(sr)
    for key in sr:
        if key in COUNTERS or key.endswith("_chunks") or key == \
                "recall_at_k":
            assert sg[key] == sr[key], key
    assert list(got.latency_histograms()) == list(ref.latency_histograms())
    assert got.bucket_sizes == ref.bucket_sizes


def _serve_stream(ref, got, q, gt=None):
    for i, req in enumerate(_requests(q)):
        lo = sum(STREAM[:i])
        g = None if gt is None else gt[lo:lo + len(req)]
        _same_result(ref.search(req, gt_ids=g), got.search(req, gt_ids=g))
    _same_engines(ref, got)


@pytest.mark.parametrize("name,algorithm", [
    ("l2", "speedann"), ("l2", "topm"), ("l2", "bfis"),
    ("grouped", "speedann"), ("hnsw", "bfis")])
def test_engine_stream_equals_reference(files, data, name, algorithm):
    ref_idx, path = files[name]
    _, q = data
    port = TIndex.load(path, device="cpu")
    params = dict(PARAMS, algorithm=algorithm)
    ref = ref_idx.serve(JParams(**params), bucket_sizes=BUCKETS)
    got = port.serve(TParams(**params), bucket_sizes=BUCKETS)
    gt = np.asarray(ref_idx.exact(q, 10)[0])
    _serve_stream(ref, got, q, gt)
    assert got.stats()["padded_queries"] == 3.0     # 3 -> 4, 11 -> 8 + 4
    assert got.stats()["jit_cache_size"] == 4.0


@pytest.mark.parametrize("name,algorithm,backend", [
    ("l2", "speedann", "ref"), ("l2", "topm", "rowgather"),
    ("grouped", "speedann", "ref"), ("hnsw", "bfis", "ref")])
def test_legacy_engine_equals_reference(files, data, name, algorithm,
                                        backend):
    """``AnnEngine(graph, SearchConfig)``: a bare graph for the l2 file; an
    index for the others, so the grouping remap and the hnsw descent run
    in the legacy path's own searchers."""
    ref_idx, path = files[name]
    _, q = data
    port = TIndex.load(path, device="cpu")
    cfg = dict(PARAMS, dist_backend=backend)
    if name == "l2":
        ref = JEngine(ref_idx.graph, JConfig(**cfg), algorithm=algorithm,
                      bucket_sizes=BUCKETS, metric="l2")
        got = TEngine(port.graph, TConfig(**cfg), algorithm=algorithm,
                      bucket_sizes=BUCKETS, metric="l2")
    else:
        ref = JEngine(ref_idx, JConfig(**cfg), algorithm=algorithm,
                      bucket_sizes=BUCKETS)
        got = TEngine(port, TConfig(**cfg), algorithm=algorithm,
                      bucket_sizes=BUCKETS)
    assert got.params is None and got.algorithm == ref.algorithm
    _serve_stream(ref, got, q)


@pytest.mark.parametrize("backend", ["ref", "rowgather", "dma",
                                     "dedup_gather"])
def test_engine_equals_direct_search(files, data, backend):
    """Transparency: every request through the engine equals
    ``AnnIndex.search`` of the same queries; the batch-relative pair obeys
    ``uniq + dup == dist_comps`` per lane."""
    _, path = files["l2"]
    _, q = data
    port = TIndex.load(path, device="cpu")
    params = TParams(**PARAMS, backend=backend)
    engine = port.serve(params, bucket_sizes=BUCKETS)
    for req in _requests(q):
        got = engine.search(torch.from_numpy(req))
        want = port.search(req, params)
        np.testing.assert_array_equal(got.ids, want.ids.numpy())
        np.testing.assert_array_equal(got.dists, want.dists.numpy())
        for name, w, g in zip(want.stats._fields, want.stats, got.stats):
            if name not in want.stats.BATCH_RELATIVE:
                np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
        np.testing.assert_array_equal(
            got.stats.uniq_comps + got.stats.batch_dup_comps,
            got.stats.dist_comps)


def test_warmup_and_cache_counters_equal_reference(files, data):
    ref_idx, path = files["l2"]
    _, q = data
    ref = ref_idx.serve(JParams(**PARAMS), bucket_sizes=BUCKETS)
    got = TIndex.load(path, device="cpu").serve(TParams(**PARAMS),
                                                bucket_sizes=BUCKETS)
    warm_r, warm_g = ref.warmup(), got.warmup()
    assert list(warm_g) == list(warm_r) == list(BUCKETS)
    assert all(s > 0 for s in warm_g.values())
    _same_engines(ref, got)
    assert got.jit_cache_size == 4
    assert (got.cache_hits, got.cache_misses) == (0, 0)
    _same_result(ref.search(q[:5]), got.search(q[:5]))
    _same_engines(ref, got)
    assert (got.cache_hits, got.cache_misses) == (1, 0)
    assert got.metrics() == got.stats()


def test_serve_entry_points(files):
    """``serve``/``serve_async`` with the reference's defaults, on the
    index's device."""
    _, path = files["l2"]
    port = TIndex.load(path, device="cpu")
    engine = port.serve()
    assert isinstance(engine, TEngine) and engine.mode == "single"
    assert engine.bucket_sizes == DEFAULT_BUCKETS
    assert engine.device == torch.device("cpu") and engine.index is port
    srv = port.serve_async(TParams(**PARAMS), start=False,
                           bucket_sizes=BUCKETS, max_wait_ms=5.0)
    assert isinstance(srv, AsyncAnnEngine) and srv._thread is None
    assert srv.policy.max_batch == 8 and srv.policy.max_wait_ms == 5.0
    assert srv.engine.params == TParams(**PARAMS)
    srv.close()


class _ShardedStandIn(NamedTuple):
    """What an engine can see of a corpus-sharded index: ``num_shards``."""
    num_shards: int = 2


def test_sharded_modes_raise_naming_their_item(files):
    _, path = files["l2"]
    port = TIndex.load(path, device="cpu")
    for call in (lambda: port.serve(TParams(algorithm="sharded")),
                 lambda: port.serve(TParams(), mesh=object()),
                 lambda: port.serve_async(TParams(), mesh=object()),
                 lambda: TEngine(_ShardedStandIn(), TParams()),
                 lambda: TEngine(port.graph, TConfig(),
                                 algorithm="sharded"),
                 lambda: port.search(np.zeros((1, 24), np.float32),
                                     TParams(algorithm="sharded"))):
        with pytest.raises(NotImplementedError, match="ROADMAP.*item 5"):
            call()


def test_bad_arguments_raise_as_reference(files):
    ref_idx, path = files["l2"]
    port = TIndex.load(path, device="cpu")
    for mod, idx, params, cfg in (
            (JEngine, ref_idx, JParams(**PARAMS), JConfig()),
            (TEngine, port, TParams(**PARAMS), TConfig())):
        engine = mod(idx, params, bucket_sizes=BUCKETS)
        with pytest.raises(ValueError, match="B >= 1"):
            engine.search(np.zeros((0, 24), np.float32))
        with pytest.raises(ValueError, match="non-empty"):
            mod(idx, params, bucket_sizes=())
        with pytest.raises(ValueError, match="unknown algorithm"):
            mod(idx.graph, cfg, algorithm="nope")
        with pytest.raises(ValueError, match="rerank_k"):
            mod(idx.graph, params.with_(rerank_k=20))
        assert [engine.bucket_for(b) for b in (1, 3, 5, 8, 9)] == \
            [1, 4, 8, 8, 8]
