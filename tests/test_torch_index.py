"""Index files built by the reference, searched by the port.

``repro`` builds tiny indices (l2, ip, cosine, neighbor grouping, a
tombstoned one, bf16 codes, hnsw) and saves them; the port's ``load`` and
``from_arrays`` must give the reference's search results (bit for bit on
integer-valued data; cosine to 1e-5), and files must round-trip both ways.
"""
import numpy as np
import pytest
import torch

from repro.ann import AnnIndex as JIndex
from repro.ann import IndexSpec as JSpec
from repro.ann import SearchParams as JParams
from repro_torch.ann import AnnIndex as TIndex
from repro_torch.ann import IndexSpec as TSpec
from repro_torch.ann import SearchParams as TParams

SPECS = {
    "l2": dict(metric="l2"),
    "ip": dict(metric="ip"),
    "cosine": dict(metric="cosine"),
    "grouped": dict(metric="l2", n_top_fraction=0.05),
    "deleted": dict(metric="l2"),
    "bf16": dict(metric="l2", quant="bf16"),
    "hnsw": dict(metric="l2", builder="hnsw"),
}
PARAMS = dict(k=8, queue_len=24, m_max=4, num_walkers=4, max_steps=48)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(1)
    x = rng.randint(-8, 9, size=(256, 16)).astype(np.float32)
    q = rng.randint(-8, 9, size=(6, 16)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def files(data, tmp_path_factory):
    x, _ = data
    root = tmp_path_factory.mktemp("indices")
    out = {}
    for name, kw in SPECS.items():
        idx = JIndex.build(x, JSpec(degree=12, passes=1, **kw))
        if name == "deleted":
            idx.delete([3, 10, 50, int(idx.graph.medoid)])
        out[name] = (idx, idx.save(str(root / name)))
    return out


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same(ref, got, metric):
    np.testing.assert_array_equal(_np(got.ids), _np(ref.ids))
    if metric == "cosine":
        np.testing.assert_allclose(_np(got.dists), _np(ref.dists),
                                   rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(_np(got.dists), _np(ref.dists))
    for name, r, g in zip(ref.stats._fields, ref.stats, got.stats):
        np.testing.assert_array_equal(_np(g), _np(r), err_msg=name)


CASES = ([(name, "speedann", 0) for name in SPECS]
         + [("l2", "topm", 0), ("l2", "bfis", 0), ("l2", "speedann", 20),
            ("deleted", "speedann", 20), ("deleted", "topm", 0),
            ("grouped", "topm", 20), ("cosine", "speedann", 20),
            ("ip", "bfis", 0)])


@pytest.mark.parametrize("name,algorithm,rerank_k", CASES)
def test_loaded_index_searches_like_reference(files, data, name, algorithm,
                                              rerank_k):
    ref_idx, path = files[name]
    _, q = data
    params = dict(PARAMS, algorithm=algorithm, rerank_k=rerank_k)
    ref = ref_idx.search(q, JParams(**params))
    got = TIndex.load(path, device="cpu").search(q, TParams(**params))
    _same(ref, got, SPECS[name]["metric"])


def test_from_arrays_equals_load(files, data):
    _, path = files["grouped"]
    _, q = data
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    a = TIndex.from_arrays(arrays, device="cpu").search(q, TParams(**PARAMS))
    b = TIndex.load(path, device="cpu").search(q, TParams(**PARAMS))
    assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)


@pytest.mark.parametrize("name", list(SPECS))
def test_files_round_trip_both_ways(files, data, tmp_path, name):
    ref_idx, path = files[name]
    _, q = data
    port = TIndex.load(path, device="cpu")
    path2 = port.save(str(tmp_path / "again"))
    with np.load(path) as a, np.load(path2) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the reference reads the port's file and searches as before
    params = JParams(**PARAMS)
    _same(ref_idx.search(q, params), JIndex.load(path2).search(q, params),
          SPECS[name]["metric"])


@pytest.mark.parametrize("name", ["l2", "ip", "cosine", "grouped",
                                  "deleted"])
def test_exact_matches_reference(files, data, name):
    ref_idx, path = files[name]
    _, q = data
    want_ids, want_d = ref_idx.exact(q, 8)
    got_ids, got_d = TIndex.load(path, device="cpu").exact(q, 8)
    # integer data ties: hold the distances, and each id to its distance
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-5, atol=1e-5)
    if name != "cosine":
        np.testing.assert_array_equal(got_d.numpy(), want_d)
    got_ids = got_ids.numpy()
    assert got_ids.shape == want_ids.shape
    if name == "deleted":
        assert not ref_idx.tombstone[got_ids].any()


def test_not_ported_paths_raise(files, data, tmp_path):
    x, q = data
    l2 = TIndex.load(files["l2"][1], device="cpu")
    # distribution is not ported: it raises, naming its ROADMAP item
    # (serving is ported: tests/test_torch_serve.py)
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 5"):
        l2.search(q, TParams(algorithm="sharded"))
    # build, add, delete and bfis on an hnsw file are ported: each equals
    # the reference
    spec = dict(degree=12, passes=1, metric="l2")
    ref, got = JIndex.build(x, JSpec(**spec)), TIndex.build(
        x, TSpec(**spec), device="cpu")
    np.testing.assert_array_equal(got.graph.nbrs.numpy(),
                                  np.asarray(ref.graph.nbrs))
    np.testing.assert_array_equal(got.add(x[:2] + 1), ref.add(x[:2] + 1))
    assert got.delete([1]) == ref.delete([1])
    np.testing.assert_array_equal(got.graph.nbrs.numpy(),
                                  np.asarray(ref.graph.nbrs))
    _same(ref.search(q, JParams(**PARAMS)),
          got.search(q, TParams(**PARAMS)), "l2")
    hnsw_ref, hnsw_path = files["hnsw"]
    hnsw = TIndex.load(hnsw_path, device="cpu")
    params = dict(PARAMS, algorithm="bfis")
    _same(hnsw_ref.search(q, JParams(**params)),
          hnsw.search(q, TParams(**params)), "l2")
    # the quantized path is ported: a bf16 index searches through
    # ref_bf16, a keep_float=False file loads, and a backend of another
    # dtype raises ValueError as in the reference
    bf16_ref, bf16_path = files["bf16"]
    bf16 = TIndex.load(bf16_path, device="cpu")
    assert bf16.graph.codes.dtype == torch.bfloat16
    params = TParams(**PARAMS, backend="ref_bf16")
    _same(bf16_ref.search(q, JParams(**PARAMS, backend="ref_bf16")),
          bf16.search(q, params), "l2")
    with pytest.raises(ValueError, match="int8"):
        bf16.search(q, TParams(backend="ref_int8"))
    lean = JIndex.build(x, JSpec(degree=12, passes=1, metric="l2",
                                 quant={"dtype": "bf16",
                                        "keep_float": False}))
    got = TIndex.load(lean.save(str(tmp_path / "lean")), device="cpu")
    np.testing.assert_array_equal(got.graph.vectors.numpy(),
                                  np.asarray(lean.graph.vectors))
