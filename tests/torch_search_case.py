"""Shared inputs of the port's whole-search parity tests: an integer-valued
graph (kNN-8 plus 4 random out-edges per vertex) built once in both
packages, and a runner holding one search of the port to the reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bfis as j_bfis
from repro.core import speedann as j_speedann
from repro.core.build import knn_graph as j_knn_graph
from repro.core.config import SearchConfig as JConfig
from repro.core.graph import make_padded_csr as j_make_csr
from repro_torch.core import bfis as t_bfis
from repro_torch.core import speedann as t_speedann
from repro_torch.core.config import SearchConfig as TConfig
from repro_torch.core.graph import make_padded_csr as t_make_csr

N, D = 300, 16


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    x = rng.randint(-8, 9, size=(N, D)).astype(np.float32)
    q = rng.randint(-8, 9, size=(8, D)).astype(np.float32)
    nbrs = np.concatenate([j_knn_graph(x, 8),
                           rng.randint(0, N, size=(N, 4))], axis=1)
    return x, q, nbrs.astype(np.int32)


@pytest.fixture(scope="module")
def graphs(data):
    x, _, nbrs = data
    out = {}
    for n_top in (0, 16):
        jg = j_make_csr(nbrs, x, n_top=n_top)
        tg = t_make_csr(nbrs, x, n_top=n_top, device="cpu")
        assert int(jg.medoid) == int(tg.medoid)
        out[n_top] = (jg, tg)
    return out


ALGOS = {
    "bfis": (j_bfis.bfis_search_batch, t_bfis.bfis_search_batch),
    "topm": (j_bfis.search_topm_batch, t_bfis.search_topm_batch),
    "speedann": (j_speedann.search_speedann_batch,
                 t_speedann.search_speedann_batch),
}


def _assert_same(ref, got):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    for name, r, g in zip(ref[2]._fields, ref[2], got[2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=name)


def _run(graphs, data, algo, b, n_top=0, **cfg):
    jg, tg = graphs[n_top]
    q = data[1][:b]
    base = dict(k=10, queue_len=24, max_steps=48, local_steps=3)
    base.update(cfg)
    jfn, tfn = ALGOS[algo]
    ref = jfn(jg, jnp.asarray(q), JConfig(**base))
    got = tfn(tg, torch.from_numpy(q), TConfig(**base))
    _assert_same(ref, got)
    return got
