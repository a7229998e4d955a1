"""The int8 kernel DistFns quantize the query side once per queries tensor.

``rowgather_int8`` and ``dedup_gather_int8`` keep ``query_meta`` of the last
queries tensor they were handed (``quant.kernels.QueryMetaMemo``).  A search
hands every step the same tensor (speedann a new one per global step), so
``query_meta`` runs 1 + global steps times per speedann search and once per
topm or bfis search, and the results stay those of ``ref_int8`` and of the
reference, bit for bit.  A tensor changed in place is quantized again.
A tensor made under ``torch.inference_mode()`` has no version counter, so
its query side is computed on every call.  Also: the dedup kernels' tile
sizing (``kernels.dedup.tile_lanes``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann.index import quantize_graph as j_quantize_graph
from repro.core import bfis as j_bfis
from repro.core import speedann as j_speedann
from repro.core.build import knn_graph as j_knn_graph
from repro.core.config import SearchConfig as JConfig
from repro.core.graph import make_padded_csr as j_make_csr
from repro.quant.scheme import QuantSpec as JQuant
from repro_torch.ann import quantize_graph
from repro_torch.core import bfis as t_bfis
from repro_torch.core import speedann as t_speedann
from repro_torch.core.config import SearchConfig as TConfig
from repro_torch.core.graph import make_padded_csr as t_make_csr
from repro_torch.kernels import dedup
from repro_torch.kernels import resolve_backend as t_resolve
from repro_torch.quant import kernels as qk
from repro_torch.quant.scheme import QuantSpec as TQuant

BACKENDS = ("rowgather_int8", "dedup_gather_int8")
ALGOS = {"bfis": (j_bfis.bfis_search_batch, t_bfis.bfis_search_batch),
         "topm": (j_bfis.search_topm_batch, t_bfis.search_topm_batch),
         "speedann": (j_speedann.search_speedann_batch,
                      t_speedann.search_speedann_batch)}


@pytest.fixture(scope="module")
def qgraphs():
    """An int8 graph in both packages over a table whose per-vector scales
    are powers of two (codes in [-127, 127] with a ±127 in every row), so
    the reference's contracted l2 epilogue is exact too; integer queries."""
    rng = np.random.RandomState(0)
    n, d = 300, 16
    codes = rng.randint(-127, 128, size=(n, d))
    codes[np.arange(n), rng.randint(0, d, n)] = rng.choice([-127, 127], n)
    x = (codes * 2.0 ** rng.randint(-3, 4, size=(n, 1))).astype(np.float32)
    q = rng.randint(-8, 9, size=(6, d)).astype(np.float32)
    nbrs = np.concatenate([j_knn_graph(x, 8), rng.randint(0, n, (n, 4))],
                          axis=1).astype(np.int32)
    jg = j_quantize_graph(j_make_csr(nbrs, x), JQuant("int8"))
    tg = quantize_graph(t_make_csr(nbrs, x, device="cpu"), TQuant("int8"))
    return jg, tg, q


@pytest.fixture
def meta_calls(monkeypatch):
    """Every queries tensor ``quant.kernels.query_meta`` is called with."""
    calls, real = [], qk.query_meta

    def counting(queries):
        calls.append(queries)
        return real(queries)
    monkeypatch.setattr(qk, "query_meta", counting)
    return calls


def _assert_same(want, got):
    for w, g in zip(want[:2], got[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for name, w, g in zip(want[2]._fields, want[2], got[2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("algo,walkers", [("speedann", 1), ("speedann", 4),
                                          ("topm", 4), ("bfis", 1)])
def test_query_meta_once_per_queries_tensor(qgraphs, meta_calls, backend,
                                            algo, walkers):
    jg, tg, q = qgraphs
    cfg = dict(k=8, queue_len=24, m_max=4, num_walkers=walkers,
               max_steps=48, local_steps=3)
    jfn, tfn = ALGOS[algo]
    ref = jfn(jg, jnp.asarray(q), JConfig(dist_backend="ref_int8", **cfg))
    plain = tfn(tg, torch.from_numpy(q),
                TConfig(dist_backend="ref_int8", **cfg))
    del meta_calls[:]
    got = tfn(tg, torch.from_numpy(q), TConfig(dist_backend=backend, **cfg))
    steps = int(got[2].steps.max())
    assert steps > 1
    want_calls = 1 + steps if algo == "speedann" else 1
    assert len(meta_calls) == want_calls
    assert len({id(t) for t in meta_calls}) == want_calls
    _assert_same(ref, got)
    _assert_same(plain, got)


@pytest.mark.parametrize("backend", BACKENDS)
def test_mutated_queries_are_quantized_again(qgraphs, meta_calls, backend):
    _, tg, q = qgraphs
    rng = np.random.RandomState(1)
    nbr = torch.from_numpy(rng.randint(-2, 305, size=(6, 2, 12)).astype(
        np.int32))
    active = torch.zeros((6, 2), dtype=torch.int32)
    fn = t_resolve(TConfig(dist_backend=backend))
    plain = t_resolve(TConfig(dist_backend="ref_int8"))
    queries = torch.from_numpy(q.copy())
    first = fn(tg, active, nbr, queries)
    again = fn(tg, active, nbr, queries)
    assert len(meta_calls) == 1
    assert torch.equal(first, again)
    queries.mul_(3.0)
    scaled = fn(tg, active, nbr, queries)
    assert len(meta_calls) == 2
    assert not torch.equal(scaled, first)
    assert torch.equal(scaled, plain(tg, active, nbr, queries))
    fresh = queries.clone()                     # same values, new tensor
    assert torch.equal(fn(tg, active, nbr, fresh), scaled)
    assert len(meta_calls) == 4                 # and the plain version's


def test_qmeta_must_match_queries():
    rng = np.random.RandomState(2)
    codes = torch.from_numpy(rng.randint(-127, 128, (40, 16)).astype(np.int8))
    scales = torch.ones((40, 1))
    ids = torch.from_numpy(rng.randint(0, 40, (3, 5)).astype(np.int32))
    q = torch.from_numpy(rng.randn(3, 16).astype(np.float32))
    meta = qk.query_meta(q)
    want = qk.int8dist_ref(codes, scales, ids, q)
    for fn in (qk.int8dist_rowgather, dedup.dedupdist_int8):
        assert torch.equal(fn(codes, scales, ids, q, qmeta=meta), want)
        with pytest.raises(ValueError, match="qmeta"):
            fn(codes, scales, ids, q, qmeta=qk.query_meta(q[:2]))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("algo,walkers", [("speedann", 4), ("topm", 4)])
def test_search_under_inference_mode(qgraphs, meta_calls, backend, algo,
                                     walkers):
    # tensors made under inference_mode carry no version counter, so the
    # query side of such a tensor is computed on every call
    jg, tg, q = qgraphs
    cfg = dict(k=8, queue_len=24, m_max=4, num_walkers=walkers,
               max_steps=48, local_steps=3)
    jfn, tfn = ALGOS[algo]
    ref = jfn(jg, jnp.asarray(q), JConfig(dist_backend="ref_int8", **cfg))
    with torch.inference_mode():
        queries = torch.from_numpy(q).clone()
        got = tfn(tg, queries, TConfig(dist_backend=backend, **cfg))
    assert len(meta_calls) >= int(got[2].steps.max()) > 1
    _assert_same(ref, got)


@pytest.mark.parametrize("backend", BACKENDS)
def test_inference_queries_mutated_are_quantized_again(qgraphs, meta_calls,
                                                       backend):
    _, tg, q = qgraphs
    rng = np.random.RandomState(3)
    nbr = torch.from_numpy(rng.randint(-2, 305, size=(6, 2, 12)).astype(
        np.int32))
    active = torch.zeros((6, 2), dtype=torch.int32)
    fn = t_resolve(TConfig(dist_backend=backend))
    plain = t_resolve(TConfig(dist_backend="ref_int8"))
    with torch.inference_mode():
        queries = torch.from_numpy(q).clone()
        assert queries.is_inference()
        first = fn(tg, active, nbr, queries)
        queries.mul_(3.0)
        scaled = fn(tg, active, nbr, queries)
        assert not torch.equal(scaled, first)
        assert torch.equal(scaled, plain(tg, active, nbr, queries))
    assert len(meta_calls) == 3                 # and the plain version's


@pytest.mark.parametrize("d,row_bytes,b,c,want", [
    (128, 512, 512, 32, 32),        # the speedann step, f32
    (128, 128, 512, 32, 32),        # int8
    (128, 512, 64, 256, 32),        # the topm step
    (960, 3840, 3, 40, 16),
    (960, 3840, 64, 1, 8),
    (960, 960, 1, 1, 32),
    (4096, 16384, 8, 8, 2),
    (8192, 32768, 64, 250, 1),
    (16384, 16384, 64, 250, 1)])
def test_tile_lanes_fit_shared_memory(d, row_bytes, b, c, want):
    t = dedup.tile_lanes(d, row_bytes, b, c)
    assert t == want
    nq = min(b, (t + c - 2) // c + 1)
    assert t == 1 or nq * (4 * d + 8) + t * (row_bytes + 4) <= \
        dedup.SMEM_BUDGET
    assert t & (t - 1) == 0 and 1 <= t <= dedup.TILE_LANES


def test_tile_lanes_refuse_a_row_too_wide():
    with pytest.raises(ValueError, match="d = 40000"):
        dedup.tile_lanes(40000, 160000, 2, 2)
    table = torch.zeros((10, 40000))
    with pytest.raises(ValueError, match="d = 40000"):
        dedup.dedupdist(table, torch.zeros((2, 3), dtype=torch.int32),
                        torch.zeros((2, 40000)))
