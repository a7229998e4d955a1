"""The port's quantized path against the reference's.

Codec, distance functions, whole searches over an index that ``repro``
built and saved, and the facade.  Inputs are made from a seed with numpy;
the reference's Pallas kernels (``int8dist_rowgather``, ``dedupdist_int8``)
run in interpret mode.

Bars: codes, scales and query codes equal bit for bit; int8 ip distances
equal bit for bit; int8 l2 distances to rtol = atol = 1e-5 on general data
and bit for bit on tables whose per-vector scales are powers of two (the
reference's XLA CPU build contracts ``s²·‖c‖² − 2·xq`` into one FMA, the
port rounds each product, so only exact products make the two agree);
searches give equal ids and all 8 counters, and distances to the same bars.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import AnnIndex as JIndex
from repro.ann import IndexSpec as JSpec
from repro.ann import SearchParams as JParams
from repro.ann.index import quantize_graph as j_quantize_graph
from repro.config import SearchConfig as JConfig
from repro.core.graph import make_padded_csr as j_make_csr
from repro.kernels import resolve_backend as j_resolve
from repro.kernels.dedup import dedupdist_int8 as j_dedupdist_int8
from repro.quant import codec as jc
from repro.quant.kernels import int8dist_rowgather as j_int8_rowgather
from repro.quant.scheme import QuantSpec as JQuant
from repro_torch.ann import AnnIndex as TIndex
from repro_torch.ann import SearchParams as TParams
from repro_torch.ann import quantize_graph
from repro_torch.core.config import SearchConfig as TConfig
from repro_torch.core.graph import make_padded_csr as t_make_csr
from repro_torch.kernels import resolve_backend as t_resolve
from repro_torch.kernels.dedup import dedupdist_int8
from repro_torch.quant import codec as tc
from repro_torch.quant.kernels import int8dist_ref, int8dist_rowgather
from repro_torch.quant.scheme import QuantSpec as TQuant

INT8_BACKENDS = ("ref_int8", "rowgather_int8", "dedup_gather_int8")


def _t(a):
    return torch.from_numpy(np.array(a))


def _pow2_table(rng, n, d, per_dim=False):
    """Integer codes in [-127, 127] with a ±127 in every row (column when
    ``per_dim``), times a power of two per row (column): the scales are
    exact powers of two, so codes, scales and the f32 sums are exact."""
    codes = rng.randint(-127, 128, size=(n, d))
    if per_dim:
        codes[rng.randint(0, n, d), np.arange(d)] = rng.choice([-127, 127],
                                                               d)
        return (codes * 2.0 ** rng.randint(-2, 1, size=(1, d))).astype(
            np.float32)
    codes[np.arange(n), rng.randint(0, d, n)] = rng.choice([-127, 127], n)
    return (codes * 2.0 ** rng.randint(-3, 4, size=(n, 1))).astype(
        np.float32)


def _gauss(rng, n, d, scale=3.0):
    return (rng.randn(n, d) * scale).astype(np.float32)


# -- codec -------------------------------------------------------------------

CODEC_DATA = {
    "gauss": lambda rng: _gauss(rng, 40, 16),
    "tiny": lambda rng: _gauss(rng, 40, 16, scale=1e-3),
    # every x / s lands on k + 0.5: round half to even decides
    "halves": lambda rng: np.concatenate(
        [np.full((8, 1), 127.0), rng.randint(-126, 126, size=(8, 15)) + 0.5],
        axis=1).astype(np.float32),
    "zeros": lambda rng: np.zeros((4, 8), np.float32),
}


@pytest.mark.parametrize("per_dim", [False, True])
@pytest.mark.parametrize("data", list(CODEC_DATA))
def test_codec_int8_matches_reference(data, per_dim):
    x = CODEC_DATA[data](np.random.RandomState(3))
    js, ts = JQuant("int8", per_dim=per_dim), TQuant("int8", per_dim=per_dim)
    jscales = jc.fit_scales(x, js)
    tscales = tc.fit_scales(_t(x), ts)
    np.testing.assert_array_equal(tscales.numpy(), np.asarray(jscales))
    jcodes = jc.quantize(x, js, jscales)
    tcodes = tc.quantize(_t(x), ts, tscales)
    assert tcodes.dtype == torch.int8
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(
        tc.dequantize(tcodes, ts, tscales).numpy(),
        np.asarray(jc.dequantize(jcodes, js, jscales)))
    np.testing.assert_array_equal(tc.max_error_bound(ts, tscales).numpy(),
                                  np.asarray(jc.max_error_bound(js, jscales)))
    if data == "halves" and not per_dim:
        # s = 1 exactly: codes are x rounded half to even
        np.testing.assert_array_equal(tcodes.numpy(), np.rint(x))
    if data == "zeros":
        assert not tcodes.any()


def test_codec_bf16_and_none_match_reference():
    x = _gauss(np.random.RandomState(4), 20, 16)
    for dtype in ("bf16", "none"):
        js, ts = JQuant(dtype), TQuant(dtype)
        assert tuple(tc.fit_scales(_t(x), ts).shape) == (0, 0)
        assert tuple(tc.no_scales().shape) == (0, 0)
        t = tc.quantize(_t(x), ts)
        j = jc.quantize(x, js)
        np.testing.assert_array_equal(
            tc.dequantize(t, ts).numpy(),
            np.asarray(jc.dequantize(j, js)))
        np.testing.assert_array_equal(
            tc.max_error_bound(ts, None).numpy(),
            np.asarray(jc.max_error_bound(js, None)))


@pytest.mark.parametrize("d", [1, 16, 128, 960])
def test_query_quantization_matches_reference(d):
    rng = np.random.RandomState(d)
    q = _gauss(rng, 3, d)
    q[1] = 0.0                                  # a zero query
    q[2, :] = np.round(q[2]) + 0.5              # .5 boundaries of q / s
    q[2, 0] = 4 * tc.query_levels(d)            # s = 4 exactly
    assert tc.query_levels(d) == jc.query_levels(d)
    jq, js = jc.quantize_query(jnp.asarray(q))
    tq, ts = tc.quantize_query(_t(q))
    assert tq.dtype == torch.int32 and tuple(ts.shape) == (3, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not tq[1].any()


@pytest.mark.parametrize("seed", range(3))
def test_cache_keys_match_reference(seed):
    rng = np.random.RandomState(seed)
    q = _gauss(rng, 1, 32)[0]
    q[::5] = np.round(q[::5]) + 0.5
    for levels in (127.0, 31.0):
        tcodes, tscale = tc.cache_codes(_t(q), levels)
        jcodes, jscale = jc.cache_codes(q, levels)
        np.testing.assert_array_equal(tcodes, jcodes)
        assert tscale.tobytes() == jscale.tobytes()
        assert tc.code_key(tcodes, tscale) == jc.code_key(jcodes, jscale)
        assert tc.query_cache_key(q, levels) == jc.query_cache_key(q,
                                                                    levels)
    assert tc.query_cache_key(np.zeros(8)) == jc.query_cache_key(np.zeros(8))


# -- distance functions -------------------------------------------------------

def _int8_case(seed, n=300, d=32, b=4, c=24, pow2=False):
    rng = np.random.RandomState(seed)
    x = _pow2_table(rng, n, d) if pow2 else _gauss(rng, n, d)
    q = (rng.randint(-8, 9, size=(b, d)).astype(np.float32) if pow2
         else _gauss(rng, b, d))
    q[0] = 0.0                                              # zero query
    ids = rng.randint(0, n + 6, size=(b, c)).astype(np.int32)   # padding
    ids[1, :6] = ids[1, 6:12]                                   # repeats
    spec = JQuant("int8")
    scales = np.asarray(jc.fit_scales(x, spec))
    codes = np.asarray(jc.quantize(x, spec, scales))
    return codes, scales, ids, q


def _reference_int8(kernel, codes, scales, ids, q, metric):
    fn = {"rowgather": j_int8_rowgather, "dedup": j_dedupdist_int8}[kernel]
    return np.asarray(fn(jnp.asarray(codes), jnp.asarray(scales),
                         jnp.asarray(ids), jnp.asarray(q), metric=metric,
                         interpret=True))


@pytest.mark.parametrize("kernel", ["rowgather", "dedup"])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("pow2", [True, False], ids=["pow2", "gauss"])
def test_int8_plain_matches_reference_kernel(kernel, metric, pow2):
    codes, scales, ids, q = _int8_case(7, pow2=pow2)
    want = _reference_int8(kernel, codes, scales, ids, q, metric)
    args = (_t(codes), _t(scales), _t(ids), _t(q))
    got = int8dist_ref(*args, metric).numpy()
    # on the CPU both wrappers are the plain version
    np.testing.assert_array_equal(
        int8dist_rowgather(*args, metric=metric).numpy(), got)
    np.testing.assert_array_equal(
        dedupdist_int8(*args, metric=metric).numpy(), got)
    assert np.isinf(got[ids >= codes.shape[0]]).all()
    if pow2 or metric != "l2":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _graphs(x, jspec):
    n = x.shape[0]
    nbrs = np.tile(np.arange(8, dtype=np.int32)[None, :], (n, 1))
    jg = j_make_csr(nbrs, x)
    tg = t_make_csr(nbrs, x, device="cpu")
    tspec = TQuant(**dataclasses.asdict(jspec))
    return j_quantize_graph(jg, jspec), quantize_graph(tg, tspec)


@pytest.mark.parametrize("backend,per_dim", [("ref_int8", False),
                                             ("ref_int8", True),
                                             ("ref_bf16", False)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_quant_dist_fns_match_reference(backend, per_dim, metric):
    rng = np.random.RandomState(9)
    x = _pow2_table(rng, 60, 16, per_dim) if backend == "ref_int8" else \
        rng.randint(-8, 9, size=(60, 16)).astype(np.float32)
    q = rng.randint(-8, 9, size=(3, 16)).astype(np.float32)
    nbr = rng.randint(0, 64, size=(3, 2, 10)).astype(np.int32)
    jg, tg = _graphs(x, JQuant(backend.split("_")[1], per_dim=per_dim))
    active = np.zeros((3, 2), np.int32)
    want = np.asarray(j_resolve(JConfig(metric=metric, dist_backend=backend))(
        jg, jnp.asarray(active), jnp.asarray(nbr), jnp.asarray(q)))
    got = t_resolve(TConfig(metric=metric, dist_backend=backend))(
        tg, _t(active), _t(nbr), _t(q)).numpy()
    np.testing.assert_array_equal(got, want)


# -- searches over a file repro built -------------------------------------

SEARCH_CASES = [("bfis", "l2", 8, 0), ("topm", "l2", 8, 20),
                ("speedann", "l2", 8, 20), ("speedann", "l2", 1, 0),
                ("topm", "ip", 8, 0), ("speedann", "ip", 1, 20),
                ("bfis", "cosine", 1, 0), ("speedann", "cosine", 8, 20)]
PARAMS = dict(k=8, queue_len=24, m_max=4, num_walkers=4, max_steps=48)


@pytest.fixture(scope="module")
def qdata():
    rng = np.random.RandomState(1)
    return _pow2_table(rng, 256, 16), rng.randint(-8, 9, size=(8, 16)).astype(
        np.float32)


@pytest.fixture(scope="module")
def qfiles(qdata, tmp_path_factory):
    x, _ = qdata
    root = tmp_path_factory.mktemp("qindices")
    out = {}
    for metric in ("l2", "ip", "cosine"):
        idx = JIndex.build(x, JSpec(degree=12, passes=1, metric=metric,
                                    quant="int8"))
        out[metric] = (idx, idx.save(str(root / metric)), {})
    return out


def _assert_same_search(ref, got, metric):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
    if metric == "cosine":
        # normalized queries differ in the last bit between the packages
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(ref.dists),
                                   rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.dists.numpy(),
                                      np.asarray(ref.dists))
    for name, r, g in zip(ref.stats._fields, ref.stats, got.stats):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=name)


@pytest.mark.parametrize("backend", INT8_BACKENDS)
@pytest.mark.parametrize("algo,metric,b,rerank_k", SEARCH_CASES)
def test_int8_search_matches_reference(qfiles, qdata, backend, algo, metric,
                                       b, rerank_k):
    """The reference's three int8 backends are bit-identical (its own
    tests), so its ``ref_int8`` search, run once per case, holds all three
    of the port's."""
    ref_idx, path, cache = qfiles[metric]
    q = qdata[1][:b]
    params = dict(PARAMS, algorithm=algo, rerank_k=rerank_k)
    key = (algo, b, rerank_k)
    if key not in cache:
        cache[key] = ref_idx.search(q, JParams(backend="ref_int8", **params))
    got = TIndex.load(path, device="cpu").search(
        q, TParams(backend=backend, **params))
    _assert_same_search(cache[key], got, metric)


def test_int8_search_matches_reference_pallas_backend(qfiles, qdata):
    ref_idx, path, _ = qfiles["l2"]
    q = qdata[1][:2]
    params = dict(PARAMS, algorithm="topm", rerank_k=20)
    ref = ref_idx.search(q, JParams(backend="rowgather_int8", **params))
    got = TIndex.load(path, device="cpu").search(
        q, TParams(backend="rowgather_int8", **params))
    _assert_same_search(ref, got, "l2")


def test_per_dim_and_bf16_searches_match_reference(qdata, tmp_path):
    x, q = qdata
    for quant, backend in (({"dtype": "int8", "per_dim": True}, "ref_int8"),
                           ("bf16", "ref_bf16")):
        idx = JIndex.build(x, JSpec(degree=12, passes=1, quant=quant))
        path = idx.save(str(tmp_path / backend))
        params = dict(PARAMS, algorithm="speedann", rerank_k=20,
                      backend=backend)
        _assert_same_search(idx.search(q, JParams(**params)),
                            TIndex.load(path, device="cpu").search(
                                q, TParams(**params)), "l2")


# -- facade --------------------------------------------------------------

@pytest.mark.parametrize("quant", ["int8", "bf16"])
def test_lean_file_loads_to_reference_table(qdata, tmp_path, quant):
    x, q = qdata
    spec = JSpec(degree=12, passes=1, n_top_fraction=0.05,
                 quant={"dtype": quant, "keep_float": False})
    path = JIndex.build(x, spec).save(str(tmp_path / "lean"))
    ref, got = JIndex.load(path), TIndex.load(path, device="cpu")
    for f in ("vectors", "flat", "codes"):
        want = np.asarray(getattr(ref.graph, f)).astype(np.float32)
        np.testing.assert_array_equal(
            getattr(got.graph, f).float().numpy(), want, err_msg=f)
    backend = "ref_" + quant
    params = dict(PARAMS, algorithm="speedann", rerank_k=20, backend=backend)
    _assert_same_search(ref.search(q, JParams(**params)),
                        got.search(q, TParams(**params)), "l2")


@pytest.mark.parametrize("per_dim,keep_float", [(False, True), (False, False),
                                                (True, False)])
def test_quantize_graph_matches_reference(per_dim, keep_float):
    rng = np.random.RandomState(2)
    x = _gauss(rng, 80, 16)
    nbrs = rng.randint(0, 80, size=(80, 6)).astype(np.int32)
    jg = j_make_csr(nbrs, x, n_top=8)
    tg = t_make_csr(nbrs, x, n_top=8, device="cpu")
    kw = dict(dtype="int8", per_dim=per_dim, keep_float=keep_float)
    jq = j_quantize_graph(jg, JQuant(**kw))
    tq = quantize_graph(tg, TQuant(**kw))
    for f in ("vectors", "flat", "codes", "scales"):
        np.testing.assert_array_equal(getattr(tq, f).numpy(),
                                      np.asarray(getattr(jq, f)), err_msg=f)
    assert quantize_graph(tg, TQuant()) is tg


def test_mismatched_backend_raises_in_both(qfiles, qdata):
    _, q = qdata
    ref_idx, path, _ = qfiles["l2"]
    port = TIndex.load(path, device="cpu")
    for idx, params in ((ref_idx, JParams), (port, TParams)):
        with pytest.raises(ValueError, match="bf16"):
            idx.search(q, params(backend="ref_bf16"))
    x = qdata[0]
    f32 = JIndex.build(x[:64], JSpec(degree=8, passes=1))
    port_f32 = TIndex.from_arrays(
        {k: v for k, v in np.load(f32.save(str(path) + "_f32")).items()},
        device="cpu")
    for idx, params in ((f32, JParams), (port_f32, TParams)):
        with pytest.raises(ValueError, match="int8"):
            idx.search(q, params(backend="dedup_gather_int8"))


def test_per_dim_scales_rejected_by_int8_kernels():
    codes, scales, ids, q = _int8_case(5)
    per_dim = torch.ones((1, codes.shape[1]))
    args = (_t(codes), per_dim, _t(ids), _t(q))
    for fn in (int8dist_rowgather, dedupdist_int8):
        with pytest.raises(ValueError, match="per-vector"):
            fn(*args)
    x = _gauss(np.random.RandomState(0), 40, 16)
    _, tg = _graphs(x, JQuant("int8", per_dim=True))
    nbr = torch.zeros((1, 2, 4), dtype=torch.int32)
    for backend in ("rowgather_int8", "dedup_gather_int8"):
        fn = t_resolve(TConfig(dist_backend=backend))
        with pytest.raises(NotImplementedError, match="ref_int8"):
            fn(tg, nbr[:, :, 0], nbr, torch.zeros((1, 16)))
    with pytest.raises(ValueError, match="quantized table"):
        t_resolve(TConfig(dist_backend="ref_int8"))(
            tg._replace(codes=None), nbr[:, :, 0], nbr, torch.zeros((1, 16)))


@pytest.mark.parametrize("bad", ["codes_dtype", "scales_dtype", "shape"])
def test_int8_wrappers_check_inputs(bad):
    codes, scales, ids, q = (_t(a) for a in _int8_case(6))
    if bad == "codes_dtype":
        codes = codes.float()
    elif bad == "scales_dtype":
        scales = scales.double()
    else:
        q = q[:, :5]
    for fn in (int8dist_rowgather, dedupdist_int8):
        with pytest.raises((TypeError, ValueError)):
            fn(codes, scales, ids, q)
