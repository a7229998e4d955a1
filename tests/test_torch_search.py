"""Whole searches of the port against the reference, bit for bit.

Integer-valued vectors make every f32 distance exact in any summation
order, so bfis, topm and speedann must return the reference's ids, dists
and all eight SearchStats counters exactly.  Here: the ``ref`` backend over
the full matrix (l2/ip, B ∈ {1, 8}, W ∈ {1, 4}, m_max ∈ {1, 8}, staged
on/off).  The kernel backends are in ``test_torch_search_backends.py``.
"""
import dataclasses

import pytest

from repro.core import speedann as j_speedann
from repro.core.config import SearchConfig as JConfig
from repro_torch.core import speedann as t_speedann
from repro_torch.core.config import SearchConfig as TConfig
from torch_search_case import _run, data, graphs  # noqa: F401

MATRIX = (
    [("speedann", m, b, w, mm, st) for m in ("l2", "ip") for b in (1, 8)
     for w in (1, 4) for mm in (1, 8) for st in (True, False)]
    + [("topm", m, b, 1, mm, st) for m in ("l2", "ip") for b in (1, 8)
       for mm in (1, 8) for st in (True, False)]
    + [("bfis", m, b, 1, 1, False) for m in ("l2", "ip") for b in (1, 8)])


@pytest.mark.parametrize("algo,metric,b,w,m_max,staged", MATRIX)
def test_ref_backend_bit_identical(graphs, data, algo, metric, b, w, m_max,
                                   staged):
    _run(graphs, data, algo, b, metric=metric, num_walkers=w, m_max=m_max,
         staged=staged)


@pytest.mark.parametrize("name", ["bfis", "edge_parallel", "nostaged",
                                  "nosync", "adaptive"])
def test_variants_match(name):
    cfg = dict(k=7, num_walkers=4, max_steps=30)
    assert dataclasses.asdict(t_speedann.variant(TConfig(**cfg), name)) \
        == dataclasses.asdict(j_speedann.variant(JConfig(**cfg), name))
