"""Searches through the kernel backends and the other search options,
against the reference, bit for bit on integer-valued data.

Each kernel backend (``rowgather``, ``dma``, ``dedup_gather``; the
reference runs them in Pallas interpret mode) runs one topm and one
speedann case per metric; on the CPU the port's wrappers take their plain
versions.  Also: the flattened hot-vertex layout, the loose and hash
visited maps, the single-query wrappers and the visited-set output.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bfis as j_bfis
from repro.core import speedann as j_speedann
from repro.core.config import SearchConfig as JConfig
from repro_torch.core import bfis as t_bfis
from repro_torch.core import speedann as t_speedann
from repro_torch.core.config import SearchConfig as TConfig
from torch_search_case import _assert_same, _run, data, graphs  # noqa: F401


@pytest.mark.parametrize("backend", ["rowgather", "dma", "dedup_gather"])
@pytest.mark.parametrize("algo", ["topm", "speedann"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_kernel_backends_bit_identical(graphs, data, backend, algo, metric):
    _run(graphs, data, algo, 8, metric=metric, num_walkers=4, m_max=4,
         dist_backend=backend)


@pytest.mark.parametrize("algo", ["topm", "speedann"])
@pytest.mark.parametrize("mode", ["loose", "bitmap"])
def test_flattened_top_level_and_loose_visited(graphs, data, algo, mode):
    _run(graphs, data, algo, 8, n_top=16, num_walkers=4, m_max=4,
         visited_mode=mode)


def test_hash_visited_contract(graphs, data):
    """Hash mode is held to its contract (sorted, exact distances of
    distinct real vertices) and to the reference's results: where lanes of
    a row race for a slot, the port keeps the reference's winner (the last
    lane that writes it), so ids and all 8 counters are the reference's."""
    x, q, _ = data
    _, tg = graphs[0]
    cfg = TConfig(k=10, queue_len=24, max_steps=48, num_walkers=4,
                  m_max=4, visited_mode="hash", hash_bits=10)
    ids, dists, stats = t_speedann.search_speedann_batch(
        tg, torch.from_numpy(q), cfg)
    ids, dists = ids.numpy(), dists.numpy()
    for r in range(q.shape[0]):
        assert len(set(ids[r])) == ids.shape[1]
        assert (np.diff(dists[r]) >= 0).all()
        np.testing.assert_array_equal(
            dists[r], ((x[ids[r]] - q[r]) ** 2).sum(axis=1))
    ref = j_speedann.search_speedann_batch(
        graphs[0][0], jnp.asarray(q), JConfig(**dataclasses.asdict(cfg)))
    np.testing.assert_array_equal(dists, np.asarray(ref[1]))
    _assert_same(ref, (torch.from_numpy(ids), torch.from_numpy(dists),
                       stats))
    assert (stats.uniq_comps + stats.batch_dup_comps
            == stats.dist_comps).all()


def test_single_query_wrappers(graphs, data):
    jg, tg = graphs[16]
    q = data[1][3]
    for jfn, tfn in ((j_speedann.search_speedann, t_speedann.search_speedann),
                     (j_bfis.search_topm, t_bfis.search_topm)):
        cfg = dict(k=5, queue_len=16, num_walkers=4, m_max=4)
        ref = jfn(jg, jnp.asarray(q), JConfig(**cfg), start=7)
        got = tfn(tg, torch.from_numpy(q), TConfig(**cfg), start=7)
        _assert_same(ref, got)


def test_topm_visited_mask_matches(graphs, data):
    jg, tg = graphs[0]
    q = data[1]
    cfg = dict(k=10, queue_len=24, m_max=4)
    ref = j_bfis.search_topm_batch_visited(jg, jnp.asarray(q),
                                           JConfig(**cfg))
    got = t_bfis.search_topm_batch_visited(tg, torch.from_numpy(q),
                                           TConfig(**cfg))
    _assert_same(ref[:3], got[:3])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
