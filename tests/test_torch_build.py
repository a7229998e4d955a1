"""Graph construction and live updates of the port, against the reference.

On integer data in [-8, 8] every distance sum is exact, so the port's
builders must give ``repro``'s graph bytes (neighbor table and medoid) for
every metric, pass count, ``build_batch`` and chunk permutation, and its
live ``add``/``delete`` must leave the same graph, codes and tombstones.
Exact kNN must order exact distance ties as ``lax.top_k`` does (lowest id
first).  The vectorized reverse pass and prune are held against the scalar
oracles they replace.
"""
import numpy as np
import pytest
import torch

from repro.ann import AnnIndex as JIndex
from repro.ann import IndexSpec as JSpec
from repro.ann import SearchParams as JParams
from repro.core import build as jb
from repro.core import graph as jg
from repro_torch.ann import AnnIndex as TIndex
from repro_torch.ann import IndexSpec as TSpec
from repro_torch.ann import SearchParams as TParams
from repro_torch.core import build as tb
from repro_torch.core import graph as tg

DEGREE, EF, N, DIM = 8, 16, 160, 8
PARAMS = dict(k=5, queue_len=16, max_steps=48)


def _ints(n, dim=DIM, seed=0, lo=-8, hi=8):
    rng = np.random.RandomState(seed)
    return rng.randint(lo, hi + 1, size=(n, dim)).astype(np.float32)


def _same_graph(ref, got):
    np.testing.assert_array_equal(got.nbrs.numpy(), np.asarray(ref.nbrs))
    assert int(got.medoid) == int(ref.medoid)


def _same_result(ref, got):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(ref.dists))
    for name, r, g in zip(ref.stats._fields, ref.stats, got.stats):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


# ---------------------------------------------------------------------------
# exact kNN: the tie order of lax.top_k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_exact_knn_orders_ties_as_reference(metric):
    # coordinates in [-2, 2], d = 4: most distances tie, inside the k and
    # at its boundary
    x = _ints(300, dim=4, seed=5, lo=-2, hi=2)
    want_ids, want_d = jb.exact_knn(x, x[:64], 24, block=40, metric=metric)
    got_ids, got_d = tb.exact_knn(x, x[:64], 24, block=40, metric=metric)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(tb.knn_graph(x, 16, metric=metric).numpy(),
                                  jb.knn_graph(x, 16, metric=metric))


def test_exact_knn_k_as_wide_as_the_data():
    x = _ints(40, dim=3, seed=6, lo=-1, hi=1)
    want_ids, _ = jb.exact_knn(x, x, 40)
    np.testing.assert_array_equal(tb.exact_knn(x, x, 40)[0].numpy(), want_ids)


# ---------------------------------------------------------------------------
# the α-prune
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_robust_prune_batch_equals_scalar_and_reference(metric):
    x = _ints(200, seed=1)
    rng = np.random.RandomState(2)
    nodes = rng.randint(0, 200, size=24)
    cand = rng.randint(0, 230, size=(24, 40)).astype(np.int32)   # >= 200: pad
    cand[:, 0] = nodes                                            # self
    cand = np.where(cand >= 200, 200, cand).astype(np.int32)
    want = jb.robust_prune_batch(x, nodes, cand, 8, 1.2, metric=metric)
    got = tb.robust_prune_batch(torch.from_numpy(x), nodes, cand, 8, 1.2,
                                metric=metric)
    np.testing.assert_array_equal(got.numpy(), want)
    xt = torch.from_numpy(x)
    for i, node in enumerate(nodes):
        c = torch.from_numpy(cand[i][cand[i] < 200]).long()
        kept = tb._robust_prune(xt, int(node), c,
                                tb._prune_dists(xt, c, xt[int(node)], metric),
                                8, 1.2, metric=metric)
        row = got[i][got[i] < 200]
        np.testing.assert_array_equal(kept.numpy(), row.numpy())


def test_prune_tiles_change_no_row(monkeypatch):
    x = torch.from_numpy(_ints(200, seed=3))
    rng = np.random.RandomState(4)
    nodes = torch.from_numpy(rng.randint(0, 200, size=50))
    cand = torch.from_numpy(np.sort(rng.randint(0, 260, size=(50, 60)),
                                    axis=1).astype(np.int32))
    cand = torch.where(cand >= 200, 200, cand)
    whole = tb._prune_round(x, nodes, cand, 8, 1.2, "l2", serial=False)
    monkeypatch.setattr(tb, "_PRUNE_CHUNK", 7)
    monkeypatch.setattr(tb, "_PRUNE_BYTES", 20 * DIM * 4)
    assert torch.equal(tb._prune_round(x, nodes, cand, 8, 1.2, "l2",
                                       serial=False), whole)


# ---------------------------------------------------------------------------
# the reverse pass: vectorized against the per-target oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("degree", [4, 8])
def test_reverse_pass_equals_serial_loop(degree):
    n = 120
    x = torch.from_numpy(_ints(n, seed=7))
    rng = np.random.RandomState(8)
    nbrs = np.full((n, degree), n, np.int32)
    for u in range(n):
        row = rng.choice(n, size=rng.randint(0, degree + 1), replace=False)
        row = row[row != u]
        nbrs[u, :row.shape[0]] = row
        rng.shuffle(nbrs[u])             # padding mid-row, as a file may hold
    round_ids = torch.from_numpy(rng.choice(n, size=40, replace=False))
    pruned = torch.from_numpy(np.stack([
        np.concatenate([rng.choice(n, size=degree - 2, replace=False),
                        [n, n]]) for _ in range(40)]).astype(np.int32))
    pruned = torch.where(pruned == round_ids[:, None].int(), n, pruned)
    a = torch.from_numpy(nbrs.copy())
    b = torch.from_numpy(nbrs.copy())
    tb._apply_reverse(a, x, round_ids, pruned, degree, 1.2, "l2",
                      serial=False)
    tb._apply_reverse(b, x, round_ids, pruned, degree, 1.2, "l2",
                      serial=True)
    assert torch.equal(a, b)
    assert not torch.equal(a, torch.from_numpy(nbrs))
    want = nbrs.copy()
    jb._apply_reverse(want, x.numpy(), round_ids.numpy(), pruned.numpy(),
                      degree, 1.2, "l2", serial=False)
    np.testing.assert_array_equal(a.numpy(), want)


# ---------------------------------------------------------------------------
# build_nsg: graph bytes equal to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("build_batch", [1, 32])
def test_build_nsg_equals_reference(metric, passes, build_batch):
    x = _ints(N)
    kw = dict(degree=DEGREE, ef_construction=EF, alpha=1.2, seed=0,
              passes=passes, metric=metric, build_batch=build_batch)
    _same_graph(jb.build_nsg(x, **kw), tb.build_nsg(x, device="cpu", **kw))


def test_build_nsg_batch_perm_equals_reference():
    x = _ints(N, seed=9)
    kw = dict(degree=DEGREE, ef_construction=EF, seed=2, passes=2,
              build_batch=32, batch_perm=3)
    got = tb.build_nsg(x, device="cpu", **kw)
    _same_graph(jb.build_nsg(x, **kw), got)
    assert torch.equal(got.nbrs, tb.build_nsg(
        x, device="cpu", **dict(kw, batch_perm=None, build_batch=7)).nbrs)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_build_batch1_equals_serial_oracle(metric):
    x = _ints(96, seed=10)
    kw = dict(degree=DEGREE, ef_construction=EF, seed=0, passes=2,
              metric=metric)
    serial = tb.build_nsg_serial(x, **kw)
    batched = tb.build_nsg(x, build_batch=1, device="cpu", **kw)
    assert torch.equal(serial.nbrs, batched.nbrs)
    assert int(serial.medoid) == int(batched.medoid)


def test_cosine_build_matches_reference_to_tolerance():
    rng = np.random.RandomState(11)
    x = rng.normal(size=(200, DIM)).astype(np.float32)
    q = rng.normal(size=(16, DIM)).astype(np.float32)
    spec = dict(metric="cosine", degree=DEGREE, passes=1)
    ref = JIndex.build(x, JSpec(**spec))
    got = TIndex.build(x, TSpec(**spec), device="cpu")
    np.testing.assert_allclose(got.graph.vectors.numpy(),
                               np.asarray(ref.graph.vectors), rtol=0,
                               atol=1e-6)

    def recall(idx, params):
        gt, _ = idx.exact(q, 5)
        ids = np.asarray(idx.search(q, params).ids)
        gt = np.asarray(gt).tolist()
        return np.mean([len(set(a) & set(b)) / 5
                        for a, b in zip(ids.tolist(), gt)])
    assert recall(got, TParams(**PARAMS)) == recall(ref, JParams(**PARAMS))


# ---------------------------------------------------------------------------
# live updates: add and delete
# ---------------------------------------------------------------------------

UPDATE_SPECS = {
    "l2": dict(metric="l2"),
    "ip": dict(metric="ip"),
    "grouped": dict(metric="l2", n_top_fraction=0.05),
    "int8": dict(metric="l2", quant="int8"),
    "max_norm": dict(metric="ip", entry_policy="max_norm"),
}


@pytest.mark.parametrize("name", list(UPDATE_SPECS))
def test_add_then_delete_equals_reference(name):
    x, extra = _ints(N, seed=12), _ints(24, seed=13)
    q = _ints(6, seed=14)
    spec = dict(degree=DEGREE, passes=1, **UPDATE_SPECS[name])
    ref = JIndex.build(x, JSpec(**spec))
    got = TIndex.build(x, TSpec(**spec), device="cpu")
    _same_graph(ref.graph, got.graph)
    codes = None if got.graph.codes is None else got.graph.codes.clone()

    np.testing.assert_array_equal(got.add(extra), ref.add(extra))
    _same_graph(ref.graph, got.graph)
    if codes is not None:
        # per-vector scales: the old rows' codes are untouched
        assert torch.equal(got.graph.codes[:N], codes)
        np.testing.assert_array_equal(got.graph.codes.numpy(),
                                      np.asarray(ref.graph.codes))
        np.testing.assert_array_equal(got.graph.scales.numpy(),
                                      np.asarray(ref.graph.scales))

    medoid = int(ref.graph.medoid)
    entry = medoid if ref.old_from_new is None else \
        int(ref.old_from_new[medoid])
    dead = [3, 17, N + 2, entry]                   # the entry vertex too
    assert got.delete(dead) == ref.delete(dead)
    _same_graph(ref.graph, got.graph)
    assert int(got.graph.medoid) != medoid         # re-elected
    np.testing.assert_array_equal(got.tombstone, ref.tombstone)
    _same_result(ref.search(q, JParams(**PARAMS)),
                 got.search(q, TParams(**PARAMS)))


def test_insert_points_and_repair_deleted_equal_reference():
    x = _ints(N, seed=15)
    kw = dict(degree=DEGREE, alpha=1.2, metric="l2")
    ref = np.asarray(jb.build_nsg(x, degree=DEGREE, passes=1).nbrs).copy()
    got = torch.from_numpy(ref.copy())
    ids = np.arange(N - 40, N)
    ref[ids] = N
    got[ids] = N
    jb.insert_points(ref, x, 0, ids, N - 40, ef=EF, build_batch=8, **kw)
    tb.insert_points(got, torch.from_numpy(x), 0, ids, N - 40, ef=EF,
                     build_batch=8, **kw)
    np.testing.assert_array_equal(got.numpy(), ref)
    tomb = np.zeros(N, bool)
    tomb[[1, 5, 40, 41, 100]] = True
    assert tb.repair_deleted(got, torch.from_numpy(x), tomb, **kw) == \
        jb.repair_deleted(ref, x, tomb, **kw)
    np.testing.assert_array_equal(got.numpy(), ref)
    serial = torch.from_numpy(np.asarray(got.numpy()).copy())
    tomb[[7, 8]] = True
    jb.repair_deleted(ref, x, tomb, **kw)
    tb.repair_deleted(serial, torch.from_numpy(x), tomb, serial=True, **kw)
    np.testing.assert_array_equal(serial.numpy(), ref)


# ---------------------------------------------------------------------------
# neighbor grouping, sentinel remap
# ---------------------------------------------------------------------------

def test_grouping_relabel_and_remap_equal_reference():
    x = _ints(N, seed=16)
    nbrs = np.array(jb.build_nsg(x, degree=DEGREE, passes=1).nbrs)
    nt = torch.from_numpy(nbrs)
    np.testing.assert_array_equal(tg.indegree_rank(nt).numpy(),
                                  jg.indegree_rank(nbrs))
    counts = np.random.RandomState(17).randint(0, 5, size=N)
    np.testing.assert_array_equal(tg.frequency_rank(nt, counts).numpy(),
                                  jg.frequency_rank(nbrs, counts))
    want, want_ofn = jg.group_by_indegree(nbrs, x, medoid=7,
                                          top_fraction=0.05)
    got, got_ofn = tg.group_by_indegree(nt, torch.from_numpy(x), medoid=7,
                                        top_fraction=0.05)
    np.testing.assert_array_equal(got_ofn.numpy(), want_ofn)
    _same_graph(want, got)
    assert got.n_top == want.n_top
    np.testing.assert_array_equal(got.flat.numpy(), np.asarray(want.flat))
    np.testing.assert_array_equal(
        tg.remap_sentinels(nt, N, N + 9).numpy(),
        jg.remap_sentinels(nbrs, N, N + 9))
    active = torch.from_numpy(np.array([[0, 3, N, 40], [1, 2, 3, N]]))
    assert float(tg.top_level_hit_fraction(got, active)) == pytest.approx(
        float(jg.top_level_hit_fraction(want, np.asarray(active))))


# ---------------------------------------------------------------------------
# files: built by one package, read by the other
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["l2", "grouped", "int8"])
def test_built_index_files_round_trip_both_ways(name, tmp_path):
    x, q = _ints(N, seed=18), _ints(6, seed=19)
    spec = dict(degree=DEGREE, passes=1, **UPDATE_SPECS[name])
    ref = JIndex.build(x, JSpec(**spec))
    got = TIndex.build(x, TSpec(**spec), device="cpu")
    got.delete([4, 9])
    ref.delete([4, 9])
    a = ref.save(str(tmp_path / "ref"))
    b = got.save(str(tmp_path / "port"))
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    _same_result(JIndex.load(b).search(q, JParams(**PARAMS)),
                 TIndex.load(a, device="cpu").search(q, TParams(**PARAMS)))
