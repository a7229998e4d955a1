"""The port's bitonic co-sort and frontier merge against the reference's.

``sort_pairs`` (on the CPU its plain version, ``kernels.ref.sort_pairs_ref``)
against ``repro``'s Pallas bitonic kernel in interpret mode, bit for bit on
rows with heavy key ties and +inf padding; ``topl_merge`` against
``repro``'s ``topl_merge`` and against the port's own ``queue.insert``, as
``tests/test_kernels.py`` holds the reference's.  Inputs are made from a
seed with numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.core import queue as fq
from repro_torch.kernels import ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.bitonic import MAX_N, sort_pairs

INVALID = 2**31 - 1


def _rows(rng, b, n):
    """Keys on a coarse grid (heavy ties), a quarter of each row +inf
    padding, payloads with ties of their own."""
    keys = rng.randint(0, 6, size=(b, n)).astype(np.float32) * 0.5
    keys[:, rng.rand(n) < 0.25] = np.inf
    p0 = rng.randint(0, 4, size=(b, n)).astype(np.int32)
    p0[0] = INVALID
    p1 = rng.randint(-50, 50, size=(b, n)).astype(np.int32)
    return keys, p0, p1


@pytest.mark.parametrize("n", [8, 64, 256, 1024])
def test_sort_pairs_matches_reference_kernel(n):
    keys, p0, p1 = _rows(np.random.RandomState(n), 3, n)
    want = j_ops.sort_pairs(jnp.asarray(keys), jnp.asarray(p0),
                            jnp.asarray(p1), interpret=True)
    got = sort_pairs(torch.from_numpy(keys), torch.from_numpy(p0),
                     torch.from_numpy(p1))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a total order: the triples come out lexicographically sorted
    order = np.lexsort((p1, p0, keys), axis=-1)
    for arr, g in zip((keys, p0, p1), got):
        np.testing.assert_array_equal(
            g.numpy(), np.take_along_axis(arr, order, axis=-1))


def test_sort_pairs_ref_matches_reference_ref_without_full_ties():
    """On rows whose (key, p0) never tie, the reference's two-key oracle
    and the port's three-key plain version agree."""
    rng = np.random.RandomState(0)
    keys = rng.permutation(64).reshape(2, 32).astype(np.float32)
    p0 = rng.randint(0, 9, size=(2, 32)).astype(np.int32)
    p1 = rng.randint(0, 9, size=(2, 32)).astype(np.int32)
    want = j_ref.sort_pairs_ref(jnp.asarray(keys), jnp.asarray(p0),
                                jnp.asarray(p1))
    got = t_ref.sort_pairs_ref(torch.from_numpy(keys), torch.from_numpy(p0),
                               torch.from_numpy(p1))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [0, 3, 12, 2 * MAX_N])
def test_sort_pairs_rejects_bad_lengths(n):
    z = torch.zeros((2, n))
    zi = torch.zeros((2, n), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        sort_pairs(z, zi, zi)
    with pytest.raises(TypeError):
        sort_pairs(z.double(), zi, zi)


def _frontier_case(seed, b=2, ln=16, c=12):
    """tests/test_kernels.py's merge inputs: sorted frontier rows with empty
    tails, fresh candidates of which some repeat queue entries."""
    rng = np.random.RandomState(seed)
    dists = np.sort(rng.uniform(0.0, 10.0, size=(b, ln)).astype(np.float32),
                    1)
    ids = np.stack([rng.choice(10_000, size=ln, replace=False)
                    for _ in range(b)]).astype(np.int32)
    meta = rng.randint(0, 2, size=(b, ln)).astype(np.int32)
    n_empty = rng.randint(0, ln // 2)
    if n_empty:
        dists[:, ln - n_empty:] = np.inf
        ids[:, ln - n_empty:] = INVALID
        meta[:, ln - n_empty:] = 1
    cd = rng.uniform(0.0, 10.0, size=(b, c)).astype(np.float32)
    ci = rng.choice(10_000, size=(b, c)).astype(np.int32)
    for r in range(b):
        for j in range(3):
            src = rng.randint(0, ln)
            if ids[r, src] != INVALID:
                ci[r, j] = ids[r, src]
                cd[r, j] = dists[r, src]
    return dists, ids, meta, cd, ci


@pytest.mark.parametrize("seed", range(8))
def test_topl_merge_matches_reference_and_queue_insert(seed):
    qd, qi, qm, cd, ci = _frontier_case(seed)
    got = ops.topl_merge(*(torch.from_numpy(a) for a in (qd, qi, qm, cd,
                                                         ci)))
    want = j_ops.topl_merge(*(jnp.asarray(a) for a in (qd, qi, qm, cd, ci)),
                            interpret=True)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    plain = t_ref.topl_merge_ref(*(torch.from_numpy(a) for a in (qd, qi, qm,
                                                                 cd, ci)),
                                 INVALID)
    jplain = j_ref.topl_merge_ref(*(jnp.asarray(a) for a in (qd, qi, qm, cd,
                                                             ci)), INVALID)
    for w, g in zip(jplain, plain):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    f = fq.Frontier(ids=torch.from_numpy(qi), dists=torch.from_numpy(qd),
                    checked=torch.from_numpy(qm == 1))
    f2, up, _ = fq.insert(f, torch.from_numpy(ci), torch.from_numpy(cd))
    d2, i2, m2, up2 = got
    assert torch.equal(i2, f2.ids) and torch.equal(d2, f2.dists)
    assert torch.equal(up2, up)
    assert torch.equal((m2 == 1) | (i2 == INVALID), f2.checked)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
