"""The HNSW builder and descent of the port, against the reference.

On integer data in [-8, 8] the port's ``build_hnsw`` must give ``repro``'s
levels (``level_nbrs``, ``level_nodes``, ``entry``) and level-0 graph, the
batched ``greedy_descent`` the per-query walk's end points, and
``hnsw_search_batch`` the same ids, dists and all eight counters.  hnsw
index files round-trip between the packages both ways.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import AnnIndex as JIndex
from repro.ann import IndexSpec as JSpec
from repro.ann import SearchParams as JParams
from repro.core import bfis as jbfis
from repro.core import build as jb
from repro.core.config import SearchConfig as JConfig
from repro_torch.ann import AnnIndex as TIndex
from repro_torch.ann import IndexSpec as TSpec
from repro_torch.ann import SearchParams as TParams
from repro_torch.core import bfis as tbfis
from repro_torch.core import build as tb
from repro_torch.core.config import SearchConfig as TConfig

N, DIM = 200, 8
KW = dict(degree=8, upper_degree=4, ml=0.6, seed=3)


def _ints(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(-8, 9, size=(n, DIM)).astype(np.float32)


@pytest.fixture(scope="module", params=["l2", "ip"])
def built(request):
    x = _ints(N, 0)
    metric = request.param
    return (metric, x, jb.build_hnsw(x, metric=metric, **KW),
            tb.build_hnsw(x, metric=metric, device="cpu", **KW))


def test_build_hnsw_equals_reference(built):
    _, _, ref, got = built
    assert got.entry == ref.entry
    assert len(got.level_nbrs) == len(ref.level_nbrs) >= 2
    for a, b in zip(ref.level_nbrs, got.level_nbrs):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(ref.level_nodes, got.level_nodes):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(got.base.nbrs.numpy(),
                                  np.asarray(ref.base.nbrs))
    assert int(got.base.medoid) == int(ref.base.medoid)


@pytest.mark.parametrize("max_hops", [1, 2, 64])
def test_greedy_descent_equals_per_query_walk(built, max_hops):
    metric, x, ref, got = built
    q = _ints(32, 1)
    starts = np.random.RandomState(2).randint(0, N, size=32).astype(np.int32)
    for lvl in range(len(ref.level_nbrs)):
        walk = jax.vmap(lambda s, v: jbfis.greedy_descent(
            ref.level_nbrs[lvl], ref.base.vectors, s, v, max_hops=max_hops,
            metric=metric))
        want = np.asarray(walk(jnp.asarray(starts), jnp.asarray(q)))
        end = tbfis.greedy_descent(got.level_nbrs[lvl], got.base.vectors,
                                   torch.from_numpy(starts),
                                   torch.from_numpy(q), max_hops=max_hops,
                                   metric=metric)
        np.testing.assert_array_equal(end.numpy(), want)


def test_hnsw_search_batch_equals_reference(built):
    metric, _, ref, got = built
    q = _ints(12, 4)
    cfg = dict(k=5, queue_len=16, max_steps=48, metric=metric)
    want = jbfis.hnsw_search_batch(ref, q, JConfig(**cfg))
    res = tbfis.hnsw_search_batch(got, torch.from_numpy(q), TConfig(**cfg))
    for w, g in zip(want[:2], res[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for name, w, g in zip(want[2]._fields, want[2], res[2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_hnsw_index_files_round_trip_both_ways(tmp_path):
    x, q = _ints(N, 5), _ints(6, 6)
    spec = dict(builder="hnsw", degree=8, upper_degree=4)
    ref = JIndex.build(x, JSpec(**spec))
    got = TIndex.build(x, TSpec(**spec), device="cpu")
    a = ref.save(str(tmp_path / "ref"))
    b = got.save(str(tmp_path / "port"))
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        assert "hnsw_entry" in za.files
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    params = dict(k=5, queue_len=16, max_steps=48, algorithm="bfis")
    want = ref.search(q, JParams(**params))
    for res in (TIndex.load(a, device="cpu").search(q, TParams(**params)),
                got.search(q, TParams(**params))):
        np.testing.assert_array_equal(res.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_array_equal(res.dists.numpy(),
                                      np.asarray(want.dists))
    back = JIndex.load(b).search(q, JParams(**params))
    np.testing.assert_array_equal(np.asarray(back.ids), np.asarray(want.ids))
    with pytest.raises(NotImplementedError, match="nsg builder only"):
        got.add(x[:2])
    with pytest.raises(NotImplementedError, match="nsg builder only"):
        got.delete([1])
