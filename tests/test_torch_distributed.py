"""The port's sharded searches against ``repro.core.distributed`` on the
(1, 1) mesh, in this process (JAX has one CPU device here).

Integer data (coordinates in [-8, 8], d = 16) makes every f32 sum exact,
so ids, dists and all 8 ``SearchStats`` counters must be the reference's
bit for bit; one N(0, 1) case is held to rtol = atol = 1e-5.  Covered: the
per-query ``expand`` and its lane-batched form, the walker path in every
visited mode over the four f32 backends (plain versions on the CPU) and
both metrics, the facade's ``algorithm="sharded"`` on grouped and
tombstoned indices, ``build_partitioned``/``build_partitioned_index``, the
corpus path and its engine searcher, both sharded ``AnnEngine`` modes with
padding, the coalescer over a sharded engine, and every refusal.  Meshes of
several positions: ``tests/test_torch_distributed_mesh.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import AnnIndex as JIndex
from repro.ann import IndexSpec as JSpec
from repro.ann import SearchParams as JParams
from repro.core import bfis as j_bfis
from repro.core import distributed as jd
from repro.core import queue as j_fq
from repro.core import visited as j_vs
from repro.core.build import knn_graph as j_knn_graph
from repro.core.config import SearchConfig as JConfig
from repro.core.graph import make_padded_csr as j_make_csr
from repro.serve import AnnEngine as JEngine
from repro_torch.ann import AnnIndex as TIndex
from repro_torch.ann import IndexSpec as TSpec
from repro_torch.ann import SearchParams as TParams
from repro_torch.ann.index import quantize_graph
from repro_torch.core import bfis as t_bfis
from repro_torch.core import distributed as td
from repro_torch.core import queue as t_fq
from repro_torch.core import visited as t_vs
from repro_torch.core.config import SearchConfig as TConfig
from repro_torch.core.graph import make_padded_csr as t_make_csr
from repro_torch.quant.scheme import QuantSpec
from repro_torch.serve import AnnEngine as TEngine
from torch_search_case import data, graphs  # noqa: F401

CFG = dict(k=10, queue_len=24, m_max=4, max_steps=48, local_steps=3,
           global_rounds=6, hash_bits=10)
PARAMS = dict(k=8, queue_len=24, m_max=4, max_steps=48, local_steps=3,
              global_rounds=6)
BUCKETS = (2, 4, 8)


def cpu_mesh(shape=(1, 1), names=("data", "model")):
    return td.make_search_mesh(shape, names, device="cpu")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same(ref, got, atol=0.0):
    np.testing.assert_array_equal(_np(got[0]), _np(ref[0]))
    np.testing.assert_allclose(_np(got[1]), _np(ref[1]), rtol=atol,
                               atol=atol)
    if len(ref) > 2:
        for name, r, g in zip(ref[2]._fields, ref[2], got[2]):
            np.testing.assert_array_equal(_np(g), _np(r), err_msg=name)


def ref_walker(jg, q, cfg, shape=(1, 1)):
    """The reference's walker search, jitted as its facade runs it."""
    mesh = jd.make_search_mesh(shape, ("data", "model"))
    return jax.jit(lambda qq: jd.walker_sharded_search(jg, qq, cfg, mesh))(
        jnp.asarray(q))


# -- the expansion round -----------------------------------------------------

@pytest.mark.parametrize("mode", ["bitmap", "hash", "loose"])
def test_expand_matches_reference_and_lanes_match_expand(graphs, data, mode):
    jg, tg = graphs[16]
    q = data[1]
    cap, n = 16, tg.n_nodes
    frontiers, tables = [], []
    for b in range(q.shape[0]):
        jf = j_fq.make_frontier(cap)
        jv = j_vs.make_visited(mode, n, 10)
        tf = t_fq.make_frontier(cap, "cpu")
        tv = t_vs.make_visited(mode, n, 10, "cpu")
        med = int(tg.medoid)
        jv, _ = j_vs.check_and_insert(jv, jnp.asarray([med]),
                                      jnp.ones((1,), bool))
        t_vs.check_and_insert(tv, torch.tensor([med]),
                              torch.ones((1,), dtype=torch.bool))
        d0 = float(((data[0][med] - q[b]) ** 2).sum())
        jf, _, _ = j_fq.insert(jf, jnp.asarray([med]), jnp.asarray([d0]))
        tf, _, _ = t_fq.insert(tf, torch.tensor([med]), torch.tensor([d0]))
        frontiers.append(tf)
        tables.append(tv.table.clone())
        for _ in range(3):
            jf, jv, jup, jn = j_bfis.expand(jg, jnp.asarray(q[b]), jf, jv,
                                            2, 2)
            tf, tv, tup, tn = t_bfis.expand(tg, torch.from_numpy(q[b]), tf,
                                            tv, 2, 2)
            for a, g in zip(jf, tf):
                np.testing.assert_array_equal(g.numpy(), np.asarray(a))
            np.testing.assert_array_equal(tv.table.numpy(),
                                          np.asarray(jv.table))
            assert int(tup) == int(jup) and int(tn) == int(jn)
        frontiers[b] = (frontiers[b], tf)
    # the lane-batched form, all 8 queries in one call: lane b equals
    # expand on lane b alone
    lanes = t_fq.Frontier(*(torch.stack(ts) for ts in
                            zip(*(f0 for f0, _ in frontiers))))
    vis = t_vs.Visited(torch.stack(tables), mode == "bitmap",
                       0 if mode != "hash" else (1 << 10) - 1)
    for _ in range(3):
        lanes, vis, _, _ = t_bfis.expand_lanes(tg, torch.from_numpy(q), lanes,
                                               vis, 2, 2)
    for b, (_, want) in enumerate(frontiers):
        for a, g in zip(want, lanes):
            assert torch.equal(g[b], a)


# -- the walker path ---------------------------------------------------------

WALKER_CASES = ([(mode, "ref", "l2") for mode in ("bitmap", "hash", "loose")]
                + [(mode, be, metric)
                   for mode in ("bitmap", "hash", "loose")
                   for be in ("ref", "rowgather", "dma", "dedup_gather")
                   for metric in ("ip",)]
                + [("bitmap", be, "l2")
                   for be in ("rowgather", "dma", "dedup_gather")])


@pytest.mark.parametrize("mode,backend,metric", WALKER_CASES)
def test_walker_sharded_matches_reference(graphs, data, mode, backend,
                                          metric):
    jg, tg = graphs[16]
    q = data[1]
    cfg = dict(CFG, visited_mode=mode, dist_backend=backend, metric=metric)
    ref = ref_walker(jg, q, JConfig(**cfg))
    got = td.walker_sharded_search(tg, torch.from_numpy(q), TConfig(**cfg),
                                   cpu_mesh())
    _same(ref, got)
    assert (got[2].uniq_comps == 0).all()
    assert (got[2].batch_dup_comps == 0).all()


def test_walker_sharded_gaussian_data():
    rng = np.random.RandomState(5)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    nbrs = np.concatenate([j_knn_graph(x, 8), rng.randint(0, 300, (300, 4))],
                          axis=1).astype(np.int32)
    cfg = dict(CFG, dist_backend="rowgather")
    ref = ref_walker(j_make_csr(nbrs, x), q, JConfig(**cfg))
    got = td.walker_sharded_search(t_make_csr(nbrs, x, device="cpu"),
                                   torch.from_numpy(q), TConfig(**cfg),
                                   cpu_mesh())
    _same(ref, got, atol=1e-5)


# -- the facade --------------------------------------------------------------

@pytest.fixture(scope="module")
def indices(data, tmp_path_factory):
    """Reference indices over the search case's vectors (grouped, and
    tombstoned) and the port's loads of their files."""
    x = data[0]
    root = tmp_path_factory.mktemp("dist")
    out = {}
    for name, kw in (("l2", {}), ("grouped", dict(n_top_fraction=0.05)),
                     ("deleted", {}), ("cosine", dict(metric="cosine"))):
        idx = JIndex.build(x, JSpec(degree=12, passes=1, **kw))
        if name == "deleted":
            idx.delete([3, 10, 50, int(idx.graph.medoid)])
        out[name] = (idx, TIndex.load(idx.save(str(root / name)),
                                      device="cpu"))
    return out


@pytest.mark.parametrize("name", ["grouped", "deleted", "cosine"])
def test_facade_sharded_search_matches_reference(indices, data, name):
    ref_idx, port = indices[name]
    q = data[1]
    p = dict(PARAMS, algorithm="sharded", backend="rowgather")
    ref = ref_idx.search(q, JParams(**p))
    got = port.search(q, TParams(**p))
    _same(ref, got, atol=1e-5 if name == "cosine" else 0.0)
    # walker_engine_search is the same call; the searcher is cached per mesh
    mesh = cpu_mesh()
    again = td.walker_engine_search(port, q, TParams(**p), mesh=mesh)
    _same(ref, again, atol=1e-5 if name == "cosine" else 0.0)
    assert port.searcher(TParams(**p), mesh=mesh) is \
        port.searcher(TParams(**p), mesh=mesh)


def test_facade_sharded_four_walkers(indices, data):
    """A (1, 4) mesh on the CPU answers like four walkers of the walker
    path itself, after the facade's tombstone mask."""
    _, port = indices["l2"]
    q = torch.from_numpy(data[1])
    mesh = cpu_mesh((1, 4))
    p = TParams(**PARAMS, algorithm="sharded")
    got = port.search(q, p, mesh=mesh)
    want = td.walker_sharded_search(port.graph, q, p.to_search_config("l2"),
                                    mesh)
    _same(want, got)
    assert int(got.stats.crit_rounds.sum()) < int(
        got.stats.local_steps.sum())


# -- the corpus path ---------------------------------------------------------

@pytest.fixture(scope="module")
def partitions(data):
    x = data[0][:299]
    kw = dict(degree=8, ef_construction=16, passes=1)
    return (x, jd.build_partitioned(x, 2, **kw),
            td.build_partitioned(x, 2, device="cpu", **kw))


def test_build_partitioned_matches_reference(partitions):
    _, ref, got = partitions
    assert got.nbrs.shape == (2, 150, 8)        # shards of 149 and 150
    for field in td.ShardedIndex._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)


def test_build_partitioned_index_cosine_matches_reference(data):
    x, q = data[0][:200], data[1]
    kw = dict(metric="cosine", degree=8, ef_construction=16, passes=1)
    ref = jd.build_partitioned_index(x, 2, JSpec(**kw))
    got = td.build_partitioned_index(x, 2, TSpec(**kw), device="cpu")
    for field in td.ShardedIndex._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)
    # one shard: the reference's (1, 1) mesh searches it whole
    ref1 = jd.build_partitioned_index(x, 1, JSpec(**kw))
    got1 = td.build_partitioned_index(x, 1, TSpec(**kw), device="cpu")
    p = dict(PARAMS, queue_len=32)
    want = jd.corpus_engine_searcher(
        ref1, JParams(**p), jd.make_search_mesh((1, 1)), metric="cosine")(q)
    have = td.corpus_engine_searcher(got1, TParams(**p), cpu_mesh(),
                                     metric="cosine")(q)
    _same(want, have, atol=1e-5)


@pytest.mark.parametrize("backend", ["ref", "rowgather", "dedup_gather"])
def test_corpus_sharded_search_matches_reference(data, backend):
    x, q = data[0], data[1]
    kw = dict(degree=8, ef_construction=16, passes=1)
    ref_index = jd.build_partitioned(x, 1, **kw)
    index = td.ShardedIndex(*(torch.from_numpy(np.array(t))
                              for t in ref_index))
    cfg = dict(CFG, m_max=2, dist_backend=backend)
    mesh = jd.make_search_mesh((1, 1))
    want = jax.jit(lambda qq: jd.corpus_sharded_search(
        ref_index, qq, JConfig(**cfg), mesh))(jnp.asarray(q))
    _same(want, td.corpus_sharded_search(index, torch.from_numpy(q),
                                         TConfig(**cfg), cpu_mesh()))
    p = dict(PARAMS, backend=backend)
    want = jd.corpus_engine_searcher(ref_index, JParams(**p), mesh)(q)
    got = td.corpus_engine_searcher(index, TParams(**p), cpu_mesh())(q)
    _same(want, got)
    assert all(int(t.abs().sum()) == 0 for t in got[2])


# -- serving -----------------------------------------------------------------

def _same_served(ref, got):
    _same((ref.ids, ref.dists, ref.stats), (got.ids, got.dists, got.stats))
    assert got.buckets == ref.buckets


def test_sharded_engines_match_reference_with_padding(indices, data):
    ref_idx, port = indices["l2"]
    q = data[1][:5]                       # pads to bucket 8
    p = dict(PARAMS, algorithm="sharded")
    ref = JEngine(ref_idx, JParams(**p), bucket_sizes=BUCKETS)
    got = TEngine(port, TParams(**p), bucket_sizes=BUCKETS)
    assert got.mode == ref.mode == "sharded"
    _same_served(ref.search(q), got.search(q))
    assert got.stats()["padded_queries"] == 3

    kw = dict(degree=8, ef_construction=16, passes=1)
    ref_index = jd.build_partitioned(data[0], 1, **kw)
    index = td.ShardedIndex(*(torch.from_numpy(np.array(t))
                              for t in ref_index))
    ref = JEngine(ref_index, JParams(**PARAMS),
                  mesh=jd.make_search_mesh((1, 1)), bucket_sizes=BUCKETS)
    got = TEngine(index, TParams(**PARAMS), mesh=cpu_mesh(),
                  bucket_sizes=BUCKETS)
    assert got.mode == ref.mode == "corpus"
    _same_served(ref.search(q), got.search(q))
    _same_served(ref.search(data[1][:2]), got.search(data[1][:2]))
    assert got.warmup() and got.stats()["jit_cache_size"] == 3


def test_coalescer_over_sharded_engine_equals_search(indices, data):
    _, port = indices["l2"]
    mesh = cpu_mesh((2, 4))
    p = TParams(**PARAMS, algorithm="sharded")
    srv = port.serve_async(p, mesh=mesh, start=False, bucket_sizes=BUCKETS)
    assert srv.engine.mode == "sharded"
    try:
        futs = [srv.submit(v) for v in data[1][:5]]
        srv.flush()
        direct = port.search(data[1][:6], p, mesh=mesh)   # data axis: 2
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result().ids,
                                          direct.ids[i].numpy())
            np.testing.assert_array_equal(f.result().dists,
                                          direct.dists[i].numpy())
    finally:
        srv.close()


# -- refusals ----------------------------------------------------------------

def test_refusals_raise_value_error(indices, data, partitions):
    _, port = indices["l2"]
    q = data[1]
    sharded = TParams(**PARAMS, algorithm="sharded")
    # quantized backends are not wired into the walker path
    qport = TIndex(port.spec.with_(quant="int8"),
                   quantize_graph(port.graph, QuantSpec("int8")))
    with pytest.raises(ValueError, match="quantized backends"):
        qport.search(q, sharded.with_(backend="ref_int8"))
    with pytest.raises(ValueError, match="quantized storage"):
        td.build_partitioned_index(data[0], 2, TSpec(quant="int8"),
                                   device="cpu")
    # a batch must split over the data axis; every bucket must too
    with pytest.raises(ValueError, match="split evenly"):
        port.search(q[:3], sharded, mesh=cpu_mesh((2, 1)))
    with pytest.raises(ValueError, match="not divisible"):
        TEngine(port, sharded, mesh=cpu_mesh((2, 1)), bucket_sizes=(1, 2))
    # a mesh on another device than the index names the multi-card item
    with pytest.raises(ValueError, match=r"ROADMAP\.md §1 item 8"):
        port.search(q, sharded, mesh=td.make_search_mesh((1, 2),
                                                         device="meta"))
    with pytest.raises(ValueError, match="pair one size"):
        td.make_search_mesh((1, 2, 2), device="cpu")
    with pytest.raises(ValueError, match="no 'model' axis"):
        port.search(q, sharded, mesh=cpu_mesh((1,), ("data",)))
    # the legacy engine refuses the sharded algorithm, as the reference's
    for mod, cfg, graph in ((JEngine, JConfig(), indices["l2"][0].graph),
                            (TEngine, TConfig(), port.graph)):
        with pytest.raises(ValueError, match="facade"):
            mod(graph, cfg, algorithm="sharded")
    # the corpus engine's three refusals, as the reference's
    _, ref_index, index = partitions
    for mod, idx, mesh, params, cfg in (
            (JEngine, ref_index, jd.make_search_mesh((1, 1)),
             JParams(), JConfig()),
            (TEngine, index, cpu_mesh((1, 2)), TParams(), TConfig())):
        with pytest.raises(ValueError, match="takes SearchParams"):
            mod(idx, cfg, mesh=mesh)
        with pytest.raises(ValueError, match="explicit mesh"):
            mod(idx, params)
        with pytest.raises(ValueError, match="serves only the sharded"):
            mod(idx, params, mesh=mesh, algorithm="bfis")


def test_corpus_needs_one_shard_per_position(data):
    """The reference on a (1, 1) mesh searches only the first of 2 shards
    and says nothing; the port refuses the pairing."""
    rng = np.random.RandomState(11)
    x = rng.randint(-8, 9, size=(400, 16)).astype(np.float32)
    q = x[200 + rng.choice(200, 16, replace=False)]   # all from shard 1
    kw = dict(degree=16, ef_construction=32, passes=2)
    ref_index = jd.build_partitioned(x, 2, **kw)
    cfg = dict(k=10, queue_len=64, m_max=1, staged=False, max_steps=256)
    mesh = jd.make_search_mesh((1, 1))
    ids, dists = jax.jit(lambda qq: jd.corpus_sharded_search(
        ref_index, qq, JConfig(**cfg), mesh))(jnp.asarray(q))
    assert (np.asarray(ids) < 200).all()             # shard 1 never seen
    assert (np.asarray(dists)[:, 0] > 0).all()       # the query is in it
    index = td.ShardedIndex(*(torch.from_numpy(np.array(t))
                              for t in ref_index))
    with pytest.raises(ValueError, match="one shard per position"):
        td.corpus_sharded_search(index, torch.from_numpy(q), TConfig(**cfg),
                                 cpu_mesh())
    ids, dists = td.corpus_sharded_search(index, torch.from_numpy(q),
                                          TConfig(**cfg), cpu_mesh((1, 2)))
    assert (dists[:, 0] == 0).all()                  # each query found


def test_no_card_no_fallback(monkeypatch, data):
    """Without a CUDA device the default mesh and the builders raise; they
    never carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: td.make_search_mesh((1, 1)),
                 lambda: td.build_partitioned(data[0][:64], 2, degree=8),
                 lambda: td.build_partitioned_index(data[0][:64], 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
