"""Frontier, visited-map and counter ops of the port against the reference.

Inputs are numpy-seeded and full of ties (small id and distance ranges),
INVALID_ID and +inf, so every stable-sort tie-break is exercised.  Queue,
bitmap/loose visited maps and the counters are held bit-identical; hash
mode is held to its contract (no false positives).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as j_metrics
from repro.core import queue as j_queue
from repro.core import visited as j_visited
from repro_torch.core import metrics as t_metrics
from repro_torch.core import queue as t_queue
from repro_torch.core import visited as t_visited

INVALID = 2**31 - 1


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _eq_frontier(jf, tf):
    _eq(jf.ids, tf.ids)
    _eq(jf.dists, tf.dists)
    _eq(jf.checked, tf.checked)


def _candidates(rng, b, c, id_range=40):
    ids = rng.randint(-2, id_range, size=(b, c)).astype(np.int32)
    ids[rng.rand(b, c) < 0.1] = INVALID
    dists = rng.randint(0, 6, size=(b, c)).astype(np.float32)
    dists[rng.rand(b, c) < 0.1] = np.inf
    dists[rng.rand(b, c) < 0.05] = -0.0
    return ids, dists


@pytest.mark.parametrize("seed", range(4))
def test_insert_select_sequence_bit_identical(seed):
    """Alternate inserts and selections on a (B, L) frontier."""
    rng = np.random.RandomState(seed)
    b, cap = 5, 12
    jf = j_queue.make_frontier_batch(cap, b)
    tf = t_queue.make_frontier_batch(cap, b)
    for _ in range(6):
        ids, dists = _candidates(rng, b, 9)
        jf, jup, jn = j_queue.insert_batch(jf, *map(jnp.asarray, (ids, dists)))
        tf, tup, tn = t_queue.insert_batch(
            tf, torch.from_numpy(ids), torch.from_numpy(dists))
        _eq_frontier(jf, tf)
        _eq(jup, tup)
        _eq(jn, tn)
        m = rng.randint(0, 4, size=(b,)).astype(np.int32)
        jf, ja, jv = j_queue.select_unchecked_batch(jf, 3, jnp.asarray(m))
        tf, ta, tv = t_queue.select_unchecked_batch(tf, 3,
                                                    torch.from_numpy(m))
        _eq_frontier(jf, tf)
        _eq(ja, ta)
        _eq(jv, tv)
        _eq(j_queue.has_unchecked_batch(jf), t_queue.has_unchecked_batch(tf))
    for k in (1, 4):
        for jr, tr in zip(j_queue.results_batch(jf, k),
                          t_queue.results_batch(tf, k)):
            _eq(jr, tr)
        _eq(jax.vmap(functools.partial(j_queue.top_k_stable, k=k))(jf),
            t_queue.top_k_stable(tf, k))


def _random_frontier(rng, b, cap):
    jf = j_queue.make_frontier_batch(cap, b)
    tf = t_queue.make_frontier_batch(cap, b)
    for _ in range(3):
        ids, dists = _candidates(rng, b, cap)
        jf, _, _ = j_queue.insert_batch(jf, *map(jnp.asarray, (ids, dists)))
        tf, _, _ = t_queue.insert_batch(tf, torch.from_numpy(ids),
                                        torch.from_numpy(dists))
        m = rng.randint(0, 3, size=(b,)).astype(np.int32)
        jf, _, _ = j_queue.select_unchecked_batch(jf, 2, jnp.asarray(m))
        tf, _, _ = t_queue.select_unchecked_batch(tf, 2, torch.from_numpy(m))
    _eq_frontier(jf, tf)
    return jf, tf


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("w", [1, 4])
def test_scatter_and_merge_bit_identical(seed, w):
    rng = np.random.RandomState(100 + seed)
    b, cap = 4, 16
    jf, tf = _random_frontier(rng, b, cap)
    active = rng.randint(0, w + 1, size=(b,)).astype(np.int32)
    jl = jax.vmap(lambda f, a: j_queue.scatter_round_robin(f, w, a))(
        jf, jnp.asarray(active))
    tl = t_queue.scatter_round_robin(tf, w, torch.from_numpy(active))
    _eq_frontier(jl, tl)
    # walkers expand a little, then merge
    ids, dists = _candidates(rng, b * w, 6)
    jl2, _, _ = j_queue.insert_batch(
        jax.tree.map(lambda t: t.reshape((b * w,) + t.shape[2:]), jl),
        *map(jnp.asarray, (ids, dists)))
    tl2, _, _ = t_queue.insert_batch(
        t_queue.Frontier(*(t.reshape(b * w, -1) for t in tl)),
        torch.from_numpy(ids), torch.from_numpy(dists))
    jl2 = jax.tree.map(lambda t: t.reshape((b, w) + t.shape[1:]), jl2)
    tl2 = t_queue.Frontier(*(t.reshape(b, w, -1) for t in tl2))
    jm, jd = jax.vmap(j_queue.merge_frontiers)(jl2)
    tm, td = t_queue.merge_frontiers(tl2)
    _eq_frontier(jm, tm)
    _eq(jd, td)


def test_single_query_forms_match_reference():
    rng = np.random.RandomState(7)
    ids, dists = _candidates(rng, 1, 10)
    jf, jup, _ = j_queue.insert(j_queue.make_frontier(8),
                                jnp.asarray(ids[0]), jnp.asarray(dists[0]))
    tf, tup, _ = t_queue.insert(t_queue.make_frontier(8),
                                torch.from_numpy(ids[0]),
                                torch.from_numpy(dists[0]))
    _eq_frontier(jf, tf)
    _eq(jup, tup)
    jf, ja, _ = j_queue.select_unchecked(jf, 3, 2)
    tf, ta, _ = t_queue.select_unchecked(tf, 3, 2)
    _eq_frontier(jf, tf)
    _eq(ja, ta)
    _eq_frontier(j_queue.scatter_round_robin(jf, 3, 2),
                 t_queue.scatter_round_robin(tf, 3, 2))


def _visited_ids(rng, b, c, n):
    ids = rng.randint(0, n + 3, size=(b, c)).astype(np.int32)
    valid = (ids < n) & (rng.rand(b, c) < 0.9)
    return ids, valid


@pytest.mark.parametrize("mode", ["bitmap", "loose"])
def test_check_and_insert_bit_identical(mode):
    rng = np.random.RandomState(3)
    b, n = 4, 50
    jv = j_visited.make_visited_batch(mode, n, b)
    tv = t_visited.make_visited_batch(mode, n, b)
    for _ in range(4):
        ids, valid = _visited_ids(rng, b, 20, n)
        jv, jfresh = j_visited.check_and_insert_batch(
            jv, jnp.asarray(ids), jnp.asarray(valid))
        tv, tfresh = t_visited.check_and_insert_batch(
            tv, torch.from_numpy(ids), torch.from_numpy(valid))
        _eq(jfresh, tfresh)
        _eq(jv.table, tv.table)


def test_bitmap_write_mask_leaves_other_lanes_untouched():
    rng = np.random.RandomState(4)
    b, n = 4, 50
    tv = t_visited.make_visited_batch("bitmap", n, b)
    ids, valid = _visited_ids(rng, b, 20, n)
    mask = torch.tensor([True, False, True, False])
    _, fresh = t_visited.check_and_insert_batch(
        tv, torch.from_numpy(ids), torch.from_numpy(valid), write_mask=mask)
    jv, jfresh = j_visited.check_and_insert_batch(
        j_visited.make_visited_batch("bitmap", n, b), jnp.asarray(ids),
        jnp.asarray(valid))
    _eq(jfresh, fresh)
    want = np.asarray(jv.table).copy()
    want[[1, 3]] = False
    np.testing.assert_array_equal(tv.table.numpy(), want)


def test_hash_function_matches_reference():
    ids = np.array([0, 1, 7, 12345, 2**31 - 2, 2**30 + 17], np.int32)
    for bits in (4, 14):
        mask = (1 << bits) - 1
        _eq(j_visited._hash(jnp.asarray(ids), mask),
            t_visited._hash(torch.from_numpy(ids), mask))


@pytest.mark.parametrize("bits", [3, 6])
def test_hash_mode_contract(bits):
    """No false positives: an id reported not-fresh was inserted before
    (in an earlier call, or earlier in the same row of this call); in-batch
    duplicates are fresh at most once."""
    rng = np.random.RandomState(bits)
    b, n = 3, 40
    tv = t_visited.make_visited_batch("hash", n, b, hash_bits=bits)
    seen = [set() for _ in range(b)]
    for _ in range(5):
        ids, valid = _visited_ids(rng, b, 16, n)
        tv, fresh = t_visited.check_and_insert_batch(
            tv, torch.from_numpy(ids), torch.from_numpy(valid))
        fresh = fresh.numpy()
        for r in range(b):
            before = set(seen[r])
            row_seen = set()
            for i in range(ids.shape[1]):
                if not valid[r, i]:
                    assert not fresh[r, i]
                    continue
                v = int(ids[r, i])
                if not fresh[r, i]:
                    assert v in before or v in row_seen, (r, v)
                else:
                    assert v not in row_seen
                row_seen.add(v)
            seen[r] |= row_seen


@pytest.mark.parametrize("mode", ["bitmap", "hash", "loose"])
def test_merge_visited_and_popcount_match(mode):
    rng = np.random.RandomState(9)
    b, w, n = 3, 4, 30
    jv = j_visited.make_visited_batch(mode, n, b * w, hash_bits=5)
    ids, valid = _visited_ids(rng, b * w, 12, n)
    jv, _ = j_visited.check_and_insert_batch(jv, jnp.asarray(ids),
                                             jnp.asarray(valid))
    table = np.asarray(jv.table).reshape((b, w) + jv.table.shape[1:])
    jstack = j_visited.Visited(jnp.asarray(table), jv.mode_bitmap, jv.mask)
    tstack = t_visited.Visited(torch.from_numpy(table.copy()),
                               jv.mode_bitmap, jv.mask)
    _eq(jax.vmap(j_visited.popcount)(jstack), t_visited.popcount(tstack))
    jm = jax.vmap(j_visited.merge_visited)(jstack)
    tm = t_visited.merge_visited(tstack)
    _eq(jm.table, tm.table)
    _eq(jax.vmap(j_visited.popcount)(jm), t_visited.popcount(tm))


@pytest.mark.parametrize("seed", range(3))
def test_batch_unique_counts_bit_identical(seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 12, size=(6, 10)).astype(np.int32)
    counted = rng.rand(6, 10) < 0.7
    _eq(j_metrics.batch_unique_counts(jnp.asarray(ids),
                                      jnp.asarray(counted)),
        t_metrics.batch_unique_counts(torch.from_numpy(ids),
                                      torch.from_numpy(counted)))


def test_recall_and_telemetry_match():
    rng = np.random.RandomState(1)
    found = rng.randint(0, 20, size=(5, 10))
    gt = rng.randint(0, 20, size=(5, 10))
    assert t_metrics.recall_at_k(torch.from_numpy(found), gt, 10) \
        == j_metrics.recall_at_k(found, gt, 10)
    vals = [rng.randint(0, 50, size=(5,)).astype(np.int32) for _ in range(8)]
    js = j_metrics.SearchStats(*map(jnp.asarray, vals))
    ts = t_metrics.SearchStats(*map(torch.from_numpy, vals))
    jt, tt = j_metrics.telemetry_per_lane(js), \
        t_metrics.telemetry_per_lane(ts)
    assert list(jt) == list(tt)
    for k in jt:
        np.testing.assert_array_equal(jt[k], tt[k])
    assert js.summary() == ts.summary()
