"""The CUDA kernels on the card, against their plain versions.

The f32 gather-distance kernels to 1e-5 (exact on integer data); the int8
kernels bit for bit; the bitonic co-sort exactly at every row length, and
the frontier merge on it equal to ``queue.insert``; the gather kernels and
searches through them past 65,535 query rows; index builds, live updates,
the α-prune and the hnsw descent on the card equal to the CPU's.

Every test here needs a CUDA device (the kernels are CUDA C++ with no CPU
mode) and skips without one.  The file imports no JAX, so it also runs on a
machine with the card and without JAX::

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.ann import AnnIndex, IndexSpec, SearchParams, quantize_graph
from repro_torch.core import (build_hnsw, exact_knn, knn_graph,
                              make_padded_csr, robust_prune_batch)
from repro_torch.core.bfis import hnsw_search_batch, search_topm_batch
from repro_torch.core.config import SearchConfig
from repro_torch.core.queue import INVALID_ID, Frontier, insert
from repro_torch.core.speedann import search_speedann_batch
from repro_torch.kernels import _cuda
from repro_torch.kernels import ref
from repro_torch.kernels.bitonic import sort_pairs
from repro_torch.kernels.dedup import dedupdist, dedupdist_int8, tile_lanes
from repro_torch.kernels.l2dist import l2dist_dma, l2dist_rowgather
from repro_torch.kernels.ops import topl_merge
from repro_torch.kernels.ref import sort_pairs_ref
from repro_torch.quant import QuantSpec, fit_scales, quantize, quantize_query
from repro_torch.quant.kernels import int8dist_ref, int8dist_rowgather
from repro_torch.serve import AnnEngine

pytestmark = pytest.mark.cuda

KERNELS = {"l2dist_rowgather": (l2dist_rowgather, ref.dist_ref),
           "l2dist_dma": (l2dist_dma, ref.dist_expanded_ref),
           "dedupdist": (dedupdist, ref.dist_ref)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "CPU mode (their plain versions are tested on the CPU)")
    return torch.device("cuda")


def _inputs(n, d, b, c, seed, integer=False, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    if integer:
        table = rng.randint(0, 256, size=(n, d)).astype(np.float32)
        q = rng.randint(0, 256, size=(b, d)).astype(np.float32)
    else:
        table = rng.normal(size=(n, d)).astype(np.float32)
        q = rng.normal(size=(b, d)).astype(np.float32)
    ids = rng.randint(0, n + 1, size=(b, c)).astype(np.int32)
    return (torch.from_numpy(table).to("cuda", dtype),
            torch.from_numpy(ids).cuda(), torch.from_numpy(q).cuda())


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("n,d,b,c", [(64, 8, 2, 16), (257, 96, 3, 8),
                                     (50, 960, 1, 8), (5000, 128, 512, 32),
                                     (5000, 128, 64, 250), (300, 20, 4, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda_device, kernel, n, d, b, c, dtype):
    table, ids, q = _inputs(n, d, b, c, seed=11, dtype=dtype)
    fn, plain = KERNELS[kernel]
    before = _cuda.LAUNCHES[kernel]
    got = fn(table, ids, q, metric="l2")
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[kernel] == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got, plain(table, ids, q, "l2"), rtol=tol,
                               atol=tol)
    assert bool(torch.isinf(got[ids >= n]).all())


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("d", [128, 20])
def test_kernels_exact_on_integer_data(cuda_device, metric, d):
    table, ids, q = _inputs(3000, d, 64, 256, seed=12, integer=True)
    want = ref.dist_ref(table, ids, q, metric)
    outs = {k: fn(table, ids, q, metric=metric)
            for k, (fn, _) in KERNELS.items()}
    for k, got in outs.items():
        assert torch.equal(got, want), k


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_negative_ids_read_row_zero(cuda_device, kernel):
    table, ids, q = _inputs(300, 128, 8, 16, seed=14, integer=True)
    ids[:, ::3] = -1
    ids[:, 1] = -7
    fn, plain = KERNELS[kernel]
    got = fn(table, ids, q, metric="l2")
    assert torch.equal(got, plain(table, ids, q, "l2"))
    assert torch.equal(got[:, 1], plain(table, torch.zeros_like(ids), q,
                                        "l2")[:, 1])


def _dedup_ids(case, n, b, c, seed):
    """(B, C) int32 ids on the card for a dedup case: walkers sharing
    candidates, one id everywhere, every lane a different row (each block's
    up to 32 rows in its 64-slot hash table probe past each other; with
    padding and negative ids), or 1 x 1."""
    rng = np.random.RandomState(seed)
    if case == "walkers":
        ids = rng.randint(-3, n + 4, size=(b, c))
        ids[1::2] = ids[0::2]
    elif case == "all_duplicate":
        ids = np.full((b, c), 17)
    elif case == "collide":
        ids = rng.permutation(n)[:b * c].reshape(b, c)
        ids[:, ::9] = n + 2
        ids[:, 1::11] = -4
    elif case == "b1c1":
        ids = np.array([[n - 1]])
    else:
        raise ValueError(case)
    return torch.from_numpy(ids.astype(np.int32)).cuda()


DEDUP_CASES = ["walkers", "all_duplicate", "collide", "successive", "b1c1"]


@pytest.mark.parametrize("case", DEDUP_CASES)
@pytest.mark.parametrize("d", [128, 960])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_dedup_bitwise_equals_rowgather(cuda_device, case, d, dtype, metric):
    n = 50_000
    table, _, _ = _inputs(n, d, 1, 1, seed=13, dtype=dtype)
    grids = ([_dedup_ids("walkers", n, 512, 32, s) for s in (1, 2)]
             if case == "successive" else [_dedup_ids(case, n, 512, 32, 3)])
    qs = [torch.randn((g.shape[0], d), device="cuda") for g in grids]
    before = _cuda.LAUNCHES["dedupdist"]
    got = [dedupdist(table, g, q, metric=metric) for g, q in zip(grids, qs)]
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["dedupdist"] == before + len(grids)
    for g, q, out in zip(grids, qs, got):
        assert torch.equal(out, l2dist_rowgather(table, g, q, metric=metric))
        assert bool(torch.isinf(out[g >= n]).all())


@pytest.mark.parametrize("tile,d,d8", [(32, 128, 128), (16, 960, 3072),
                                       (1, 8192, 12288)])
def test_dedup_tile_sizes_equal_rowgather(cuda_device, tile, d, d8):
    # the tile follows from d (kernels.dedup.tile_lanes); 63 x 250 lanes
    # leave a ragged last tile
    table, ids, q = _inputs(3000, d, 63, 250, seed=15)
    ids[1::2] = ids[:-1:2]
    codes, scales, ids8, q8 = _int8_inputs(3000, d8, 63, 250, seed=16)
    assert tile_lanes(d, 4 * d, 63, 250) == tile
    assert tile_lanes(d8, d8, 63, 250) == tile
    for metric in ("l2", "ip"):
        assert torch.equal(dedupdist(table, ids, q, metric=metric),
                           l2dist_rowgather(table, ids, q, metric=metric))
        assert torch.equal(
            dedupdist_int8(codes, scales, ids8, q8, metric=metric),
            int8dist_rowgather(codes, scales, ids8, q8, metric=metric))


@pytest.mark.parametrize("backend", ["rowgather", "dma", "dedup_gather"])
@pytest.mark.parametrize("algo", ["topm", "speedann"])
def test_search_on_card_equals_plain_search_on_cpu(cuda_device, backend,
                                                   algo):
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randint(0, 256, size=(2000, 32))
                         .astype(np.float32))
    q = torch.from_numpy(rng.randint(0, 256, size=(16, 32))
                         .astype(np.float32))
    nbrs = torch.cat([knn_graph(x, 12), torch.from_numpy(
        rng.randint(0, 2000, size=(2000, 4)).astype(np.int32))], dim=1)
    cfg = SearchConfig(k=10, queue_len=32, m_max=4, num_walkers=4,
                       dist_backend=backend)
    fn = {"topm": search_topm_batch, "speedann": search_speedann_batch}[algo]
    want = fn(make_padded_csr(nbrs, x, device="cpu"), q, cfg)
    got = fn(make_padded_csr(nbrs, x, device="cuda"), q.cuda(), cfg)
    for w, g in zip(want[:2], got[:2]):
        assert torch.equal(w, g.cpu())
    for w, g in zip(want[2], got[2]):
        assert torch.equal(w, g.cpu())


# -- int8 kernels and the bitonic co-sort --------------------------------------

def _int8_inputs(n, d, b, c, seed):
    """Per-vector int8 codes of N(0, 3) rows, queries with a zero row,
    ids with padding (>= n) and negative ids."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(n, d) * 3).astype(np.float32))
    spec = QuantSpec("int8")
    scales = fit_scales(x, spec)
    codes = quantize(x, spec, scales)
    q = rng.randn(b, d).astype(np.float32)
    q[0] = 0.0
    ids = rng.randint(-3, n + 4, size=(b, c)).astype(np.int32)
    return (codes.cuda(), scales.cuda(), torch.from_numpy(ids).cuda(),
            torch.from_numpy(q).cuda())


INT8_KERNELS = {"int8dist_rowgather": int8dist_rowgather,
                "dedupdist_int8": dedupdist_int8}


@pytest.mark.parametrize("kernel", list(INT8_KERNELS))
@pytest.mark.parametrize("n,d,b,c", [(5000, 128, 512, 32),
                                     (5000, 128, 64, 256), (300, 32, 4, 9),
                                     (200, 960, 3, 40), (100, 20, 5, 7)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_int8_kernel_bit_identical_to_plain(cuda_device, kernel, n, d, b, c,
                                            metric):
    codes, scales, ids, q = _int8_inputs(n, d, b, c, seed=d + c)
    before = _cuda.LAUNCHES[kernel]
    got = INT8_KERNELS[kernel](codes, scales, ids, q, metric=metric)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[kernel] == before + 1
    assert torch.equal(got, int8dist_ref(codes, scales, ids, q, metric))
    assert bool(torch.isinf(got[ids >= n]).all())
    assert torch.equal(got[ids < 0], int8dist_ref(
        codes, scales, torch.zeros_like(ids), q, metric)[ids < 0])


@pytest.mark.parametrize("overlap", ["all_duplicate", "no_overlap",
                                     "collide", "successive", "b1c1"])
@pytest.mark.parametrize("d", [128, 960])
def test_dedup_int8_overlap_extremes(cuda_device, overlap, d):
    n = 50_000
    codes, scales, ids, q = _int8_inputs(n, d, 64, 64, seed=21)
    if overlap == "no_overlap":
        grids = [torch.randperm(n, device="cuda")[:64 * 64].reshape(
            64, 64).to(torch.int32)]
    elif overlap == "successive":
        grids = [ids, _dedup_ids("walkers", n, 64, 64, 22)]
    else:
        grids = [_dedup_ids(overlap, n, 64, 64, 23)]
    for metric in ("l2", "ip"):
        got = [dedupdist_int8(codes, scales, g, q[:g.shape[0]].contiguous(),
                              metric=metric) for g in grids]
        for g, out in zip(grids, got):
            qg = q[:g.shape[0]].contiguous()
            assert torch.equal(out, int8dist_rowgather(codes, scales, g, qg,
                                                       metric=metric))
            assert torch.equal(out, int8dist_ref(codes, scales, g, qg,
                                                 metric))


@pytest.mark.parametrize("b,n", [(3, 1), (4, 2), (5, 8), (64, 1024),
                                 (512, 512), (2, 16384)])
def test_sort_pairs_exact_on_ties(cuda_device, b, n):
    gen = torch.Generator(device="cuda").manual_seed(n)
    keys = torch.randint(0, 5, (b, n), generator=gen, device="cuda").float()
    keys[torch.rand((b, n), generator=gen, device="cuda") < 0.2] = \
        float("inf")
    p0 = torch.randint(0, 3, (b, n), generator=gen, device="cuda",
                       dtype=torch.int32)
    p1 = torch.randint(-9, 9, (b, n), generator=gen, device="cuda",
                       dtype=torch.int32)
    before = _cuda.LAUNCHES["sort_pairs"]
    got = sort_pairs(keys, p0, p1)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["sort_pairs"] == before + 1
    for g, w in zip(got, sort_pairs_ref(keys, p0, p1)):
        assert torch.equal(g, w)


def test_topl_merge_equals_queue_insert_on_card(cuda_device):
    rng = np.random.RandomState(4)
    b, ln, c = 64, 128, 256
    d = np.sort(rng.uniform(0, 10, size=(b, ln)).astype(np.float32), 1)
    ids = np.stack([rng.choice(100_000, ln, replace=False)
                    for _ in range(b)]).astype(np.int32)
    d[:, 100:] = np.inf
    ids[:, 100:] = INVALID_ID
    checked = rng.rand(b, ln) < 0.5
    checked[:, 100:] = True
    cd = rng.uniform(0, 10, size=(b, c)).astype(np.float32)
    ci = rng.choice(100_000, size=(b, c)).astype(np.int32)
    ci[:, :20] = ids[:, :20]
    cd[:, :20] = d[:, :20]
    ci[:, -40:] = INVALID_ID
    cd[:, -40:] = np.inf
    t = [torch.from_numpy(a).cuda() for a in (d, ids, checked, cd, ci)]
    f = Frontier(ids=t[1], dists=t[0], checked=t[2])
    f2, up, _ = insert(f, t[4], t[3])
    d2, i2, m2, up2 = topl_merge(t[0], t[1], t[2].to(torch.int32), t[3],
                                 t[4])
    assert torch.equal(i2, f2.ids) and torch.equal(d2, f2.dists)
    assert torch.equal(up2, up)
    assert torch.equal((m2 == 1) | (i2 == INVALID_ID), f2.checked)


def test_codec_on_card_equals_cpu(cuda_device):
    """Scales, codes and query codes are correctly rounded on the card
    too (a division by a Python scalar on CUDA would multiply by the
    reciprocal and part by an ulp)."""
    rng = np.random.RandomState(8)
    x = torch.from_numpy((rng.randn(20000, 128) * 3).astype(np.float32))
    for spec in (QuantSpec("int8"), QuantSpec("int8", per_dim=True)):
        s_cpu, s_gpu = fit_scales(x, spec), fit_scales(x.cuda(), spec)
        assert torch.equal(s_gpu.cpu(), s_cpu)
        assert torch.equal(quantize(x.cuda(), spec, s_gpu).cpu(),
                           quantize(x, spec, s_cpu))
    for got, want in zip(quantize_query(x.cuda()), quantize_query(x)):
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("backend", ["dedup_gather", "dedup_gather_int8"])
@pytest.mark.parametrize("walkers", [1, 8])
def test_dedup_speedann_on_card_equals_plain_search_on_cpu(cuda_device,
                                                           backend, walkers):
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randint(0, 256, size=(3000, 32))
                         .astype(np.float32))
    q = torch.from_numpy(rng.randint(0, 256, size=(24, 32))
                         .astype(np.float32))
    nbrs = torch.cat([knn_graph(x, 12), torch.from_numpy(
        rng.randint(0, 3000, size=(3000, 4)).astype(np.int32))], dim=1)
    cfg = SearchConfig(k=10, queue_len=32, m_max=4, num_walkers=walkers,
                       dist_backend=backend)
    plain = "ref"
    graphs = [make_padded_csr(nbrs, x, device=dev) for dev in ("cpu", "cuda")]
    if backend.endswith("int8"):
        plain = "ref_int8"
        graphs = [quantize_graph(g, QuantSpec("int8")) for g in graphs]
    want = search_speedann_batch(graphs[0], q,
                                 cfg.with_(dist_backend=plain))
    kernel = "dedupdist_int8" if backend.endswith("int8") else "dedupdist"
    before = _cuda.LAUNCHES[kernel]
    got = search_speedann_batch(graphs[1], q.cuda(), cfg)
    assert _cuda.LAUNCHES[kernel] > before
    for w, g in zip(want[:2], got[:2]):
        assert torch.equal(w, g.cpu())
    for w, g in zip(want[2], got[2]):
        assert torch.equal(w, g.cpu())


@pytest.mark.parametrize("backend", ["rowgather_int8", "dedup_gather_int8"])
def test_int8_search_on_card_equals_plain_search_on_cpu(cuda_device,
                                                        backend):
    # integer coordinates: the f32 seed distances and ||q||^2 are exact
    # sums, so the CPU and the card agree on them whatever the order
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randint(0, 256, size=(2000, 32))
                         .astype(np.float32))
    q = torch.from_numpy(rng.randint(0, 256, size=(16, 32))
                         .astype(np.float32))
    nbrs = torch.cat([knn_graph(x, 12), torch.from_numpy(
        rng.randint(0, 2000, size=(2000, 4)).astype(np.int32))], dim=1)
    cfg = SearchConfig(k=10, queue_len=32, m_max=4, num_walkers=4,
                       dist_backend=backend)
    spec = QuantSpec("int8")
    want = search_speedann_batch(
        quantize_graph(make_padded_csr(nbrs, x, device="cpu"), spec), q,
        cfg.with_(dist_backend="ref_int8"))
    got = search_speedann_batch(
        quantize_graph(make_padded_csr(nbrs, x, device="cuda"), spec),
        q.cuda(), cfg)
    for w, g in zip(want[:2], got[:2]):
        assert torch.equal(w, g.cpu())
    for w, g in zip(want[2], got[2]):
        assert torch.equal(w, g.cpu())


# -- the one-wave dma and the segmented int8 rowgather --------------------------

# (B, C, d): C not a multiple of 32 or of the dma tile g, C = 1, C >= 1000
# (at d = 960 f32 a dma block copies its run in chunks through two
# buffers), and d from 16 to 960 (d = 100: the int8 table's element path)
REDESIGN_SHAPES = [(5, 37, 16), (3, 250, 100), (512, 32, 128), (64, 256, 128),
                   (7, 1, 128), (300, 1000, 128), (300, 1000, 960),
                   (2, 1000, 960), (9, 5, 960)]


def _small_int_inputs(n, d, b, c, seed, dtype=torch.float32):
    """Integer coordinates in [-31, 32]: every f32 sum of both kernels and
    of their plain versions is exact, whatever its order."""
    rng = np.random.RandomState(seed)
    table = rng.randint(-31, 33, size=(n, d)).astype(np.float32)
    q = rng.randint(-31, 33, size=(b, d)).astype(np.float32)
    ids = rng.randint(-2, n + 3, size=(b, c)).astype(np.int32)
    return (torch.from_numpy(table).to("cuda", dtype),
            torch.from_numpy(ids).cuda(), torch.from_numpy(q).cuda())


def _misaligned(t):
    """``t``'s values in a contiguous view whose data starts 4 bytes (one
    element of an int8 table) past a 16-byte boundary."""
    shift = max(1, 4 // t.element_size())
    flat = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
    view = flat[shift:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    return view


@pytest.mark.parametrize("b,c,d", REDESIGN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_dma_exact_on_integer_data_at_plan_shapes(cuda_device, b, c, d, dtype,
                                                  metric):
    table, ids, q = _small_int_inputs(3000, d, b, c, seed=b + c + d,
                                      dtype=dtype)
    before = _cuda.LAUNCHES["l2dist_dma"]
    got = l2dist_dma(table, ids, q, metric=metric)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["l2dist_dma"] == before + 1
    assert torch.equal(got, ref.dist_expanded_ref(table, ids, q, metric))
    assert torch.equal(got, l2dist_rowgather(table, ids, q, metric=metric))


@pytest.mark.parametrize("b,c,d", REDESIGN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dma_matches_plain_at_plan_shapes(cuda_device, b, c, d, dtype):
    table, ids, q = _inputs(3000, d, b, c, seed=b * c + d, dtype=dtype)
    got = l2dist_dma(table, ids, q, metric="l2")
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got, ref.dist_expanded_ref(table, ids, q,
                                                          "l2"),
                               rtol=tol, atol=tol)
    assert bool(torch.isinf(got[ids >= 3000]).all())


@pytest.mark.parametrize("b,c,d", REDESIGN_SHAPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_int8_rowgather_bit_identical_at_plan_shapes(cuda_device, b, c, d,
                                                     metric):
    codes, scales, ids, q = _int8_inputs(3000, d, b, c, seed=b + c + d)
    before = _cuda.LAUNCHES["int8dist_rowgather"]
    got = int8dist_rowgather(codes, scales, ids, q, metric=metric)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["int8dist_rowgather"] == before + 1
    assert torch.equal(got, int8dist_ref(codes, scales, ids, q, metric))
    assert torch.equal(got, dedupdist_int8(codes, scales, ids, q,
                                           metric=metric))


@pytest.mark.parametrize("case", ["all_padding", "negative", "misaligned"])
@pytest.mark.parametrize("d", [16, 100, 128])
def test_redesigned_kernels_edge_ids_and_fallback(cuda_device, case, d):
    n, b, c = 500, 33, 70
    table, ids, q = _small_int_inputs(n, d, b, c, seed=d)
    codes, scales, _, q8 = _int8_inputs(n, d, b, c, seed=d + 1)
    if case == "all_padding":
        ids = torch.full_like(ids, n + 5)
    elif case == "negative":
        ids[:, ::2] = -1 - ids[:, ::2].abs()
    else:
        table, codes = _misaligned(table), _misaligned(codes)
        assert not _cuda.vec_ok(table, q)
        assert not _cuda.int8_vec_ok(codes, q8)
    for metric in ("l2", "ip"):
        got = l2dist_dma(table, ids, q, metric=metric)
        assert torch.equal(got, ref.dist_expanded_ref(table, ids, q, metric))
        got8 = int8dist_rowgather(codes, scales, ids, q8, metric=metric)
        assert torch.equal(got8, int8dist_ref(codes, scales, ids, q8,
                                              metric))
        if case == "all_padding":
            assert bool(torch.isinf(got).all() and torch.isinf(got8).all())


# -- the register-resident rowgather and co-sort; no grid limit on B -----------

@pytest.mark.parametrize("b,c,d", REDESIGN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_rowgather_exact_on_integer_data_at_plan_shapes(cuda_device, b, c, d,
                                                        dtype, metric):
    table, ids, q = _small_int_inputs(3000, d, b, c, seed=b + c + d + 1,
                                      dtype=dtype)
    before = _cuda.LAUNCHES["l2dist_rowgather"]
    got = l2dist_rowgather(table, ids, q, metric=metric)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["l2dist_rowgather"] == before + 1
    assert torch.equal(got, ref.dist_ref(table, ids, q, metric))
    assert torch.equal(got, dedupdist(table, ids, q, metric=metric))


@pytest.mark.parametrize("case", ["d30", "misaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_rowgather_element_path_bitwise_equals_dedup(cuda_device, case, dtype,
                                                     metric):
    # the element path (vec = 0): d not a multiple of the 16-byte vector,
    # or a table that is not 16-byte aligned; N(0, 1) data, so the two
    # kernels agree only if each lane sums its elements in one order
    d = 30 if case == "d30" else 128
    table, ids, q = _inputs(4000, d, 512, 32, seed=17, dtype=dtype)
    ids[:, ::5] = -2
    if case == "misaligned":
        table = _misaligned(table)
    assert not _cuda.vec_ok(table, q)
    got = l2dist_rowgather(table, ids, q, metric=metric)
    assert torch.equal(got, dedupdist(table, ids, q, metric=metric))
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    want = ref.dist_ref(table, ids, q, metric)
    fin = ids < 4000
    torch.testing.assert_close(got[fin], want[fin], rtol=tol, atol=tol)
    assert bool(torch.isinf(got[~fin]).all())


@pytest.mark.parametrize("kernel", ["l2dist_rowgather", "l2dist_dma",
                                    "int8dist_rowgather"])
def test_gather_kernels_past_the_grid_y_limit(cuda_device, kernel):
    # 65,573 query rows: more than a grid's y dimension (65,535) holds
    b, c, d = 65_573, 32, 16
    before = _cuda.LAUNCHES[kernel]
    if kernel == "int8dist_rowgather":
        codes, scales, ids, q = _int8_inputs(1000, d, b, c, seed=31)
        got = int8dist_rowgather(codes, scales, ids, q, metric="l2")
        want = int8dist_ref(codes, scales, ids, q, "l2")
    else:
        table, ids, q = _small_int_inputs(1000, d, b, c, seed=31)
        fn, plain = KERNELS[kernel]
        got = fn(table, ids, q, metric="l2")
        want = plain(table, ids, q, "l2")
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[kernel] == before + 1
    assert torch.equal(got, want)
    assert bool(torch.isinf(got[ids >= 1000]).all())


KERNEL_OF = {"rowgather": "l2dist_rowgather", "dma": "l2dist_dma"}


@pytest.mark.parametrize("backend", ["rowgather", "dma"])
def test_speedann_of_8200_queries_equals_ref(cuda_device, backend):
    # 8,200 queries at W = 8 walkers: each distance call has 65,600 query
    # rows (B·W), past the 65,535 of a grid's y dimension
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randint(0, 256, size=(1500, 16))
                         .astype(np.float32)).cuda()
    q = torch.from_numpy(rng.randint(0, 256, size=(8200, 16))
                         .astype(np.float32)).cuda()
    nbrs = torch.cat([knn_graph(x, 8), torch.from_numpy(
        rng.randint(0, 1500, size=(1500, 4)).astype(np.int32)).cuda()],
        dim=1)
    graph = make_padded_csr(nbrs, x, device="cuda")
    cfg = SearchConfig(k=10, queue_len=16, m_max=2, num_walkers=8,
                       dist_backend=backend)
    want = search_speedann_batch(graph, q, cfg.with_(dist_backend="ref"))
    kernel = KERNEL_OF[backend]
    before = _cuda.LAUNCHES[kernel]
    got = search_speedann_batch(graph, q, cfg)
    assert _cuda.LAUNCHES[kernel] > before
    for w, g in zip(want[:2], got[:2]):
        assert torch.equal(w, g)
    assert len(got[2]) == 8
    for w, g in zip(want[2], got[2]):
        assert torch.equal(w, g)


@pytest.mark.parametrize("n", [2**k for k in range(15)])
def test_sort_pairs_exact_at_every_length(cuda_device, n):
    # heavy key ties, +inf padding, and duplicate (key, p0) pairs that only
    # p1 orders; a 1024-element row is one warp's registers, a longer one
    # merges runs of 1024 through shared memory
    b = max(1, min(300, 2**16 // n))
    gen = torch.Generator(device="cuda").manual_seed(100 + n)
    keys = torch.randint(0, 4, (b, n), generator=gen, device="cuda").float()
    keys[torch.rand((b, n), generator=gen, device="cuda") < 0.3] = \
        float("inf")
    p0 = torch.randint(0, 2, (b, n), generator=gen, device="cuda",
                       dtype=torch.int32)
    p1 = torch.randperm(b * n, generator=gen, device="cuda").reshape(
        b, n).to(torch.int32) % max(2, n // 2)
    before = _cuda.LAUNCHES["sort_pairs"]
    got = sort_pairs(keys, p0, p1)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["sort_pairs"] == before + 1
    for g, w in zip(got, sort_pairs_ref(keys, p0, p1)):
        assert torch.equal(g, w)


# -- graph construction, live updates and the hnsw descent on the card --------

BUILD_N = 2048


@pytest.fixture(scope="module")
def cpu_built():
    """The CPU build (plain ``ref`` backend, build_batch 32) of 2,048
    integer vectors, its 1% add and its deletes: what every card build must
    equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card build is compared with "
                    "the CPU build")
    rng = np.random.RandomState(21)
    x = rng.randint(0, 256, size=(BUILD_N, 16)).astype(np.float32)
    extra = rng.randint(0, 256, size=(BUILD_N // 100, 16)).astype(np.float32)
    dead = rng.choice(BUILD_N, size=BUILD_N // 100, replace=False)
    idx = AnnIndex.build(x, IndexSpec(degree=16, build_batch=32),
                         device="cpu")
    graph = (idx.graph.nbrs.clone(), int(idx.graph.medoid))
    idx.add(extra)
    added = idx.graph.nbrs.clone()
    idx.delete(dead)
    return x, extra, dead, graph, added, (idx.graph.nbrs.clone(),
                                          int(idx.graph.medoid))


@pytest.mark.parametrize("backend", ["rowgather", "dma", "dedup_gather"])
def test_build_on_card_equals_cpu_build(cuda_device, cpu_built, backend):
    x, extra, dead, (nbrs, medoid), added, (after, medoid2) = cpu_built
    kernel = {"rowgather": "l2dist_rowgather", "dma": "l2dist_dma",
              "dedup_gather": "dedupdist"}[backend]
    _cuda.reset_launches()
    idx = AnnIndex.build(x, IndexSpec(degree=16, build_batch=512,
                                      build_backend=backend))
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[kernel] > 0
    assert sum(_cuda.LAUNCHES.values()) == _cuda.LAUNCHES[kernel]
    assert idx.device.type == "cuda"
    assert torch.equal(idx.graph.nbrs.cpu(), nbrs)
    assert int(idx.graph.medoid) == medoid
    idx.add(extra)
    assert torch.equal(idx.graph.nbrs.cpu(), added)
    idx.delete(dead)
    assert torch.equal(idx.graph.nbrs.cpu(), after)
    assert int(idx.graph.medoid) == medoid2


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_robust_prune_on_card_equals_cpu(cuda_device, metric):
    rng = np.random.RandomState(22)
    x = torch.from_numpy(rng.randint(0, 256, size=(5000, 128))
                         .astype(np.float32))
    nodes = torch.from_numpy(rng.randint(0, 5000, size=300))
    cand = torch.from_numpy(np.sort(rng.randint(0, 5600, size=(300, 700)),
                                    axis=1).astype(np.int32))
    cand = torch.where(cand >= 5000, 5000, cand)
    want = robust_prune_batch(x, nodes, cand, 32, 1.2, metric=metric)
    got = robust_prune_batch(x.cuda(), nodes.cuda(), cand.cuda(), 32, 1.2,
                             metric=metric)
    assert torch.equal(got.cpu(), want)


def test_hnsw_on_card_equals_cpu(cuda_device):
    rng = np.random.RandomState(23)
    x = rng.randint(0, 256, size=(1500, 32)).astype(np.float32)
    q = torch.from_numpy(rng.randint(0, 256, size=(64, 32))
                         .astype(np.float32))
    kw = dict(degree=16, upper_degree=8, ml=0.5, build_batch=256,
              build_backend="rowgather")
    want = build_hnsw(x, device="cpu", **kw)
    got = build_hnsw(x, **kw)
    assert got.entry == want.entry
    for a, b in zip(want.level_nbrs + want.level_nodes,
                    got.level_nbrs + got.level_nodes):
        assert torch.equal(b.cpu(), a)
    assert torch.equal(got.base.nbrs.cpu(), want.base.nbrs)
    cfg = SearchConfig(k=10, queue_len=32, dist_backend="rowgather")
    a = hnsw_search_batch(want, q, cfg)
    b = hnsw_search_batch(got, q.cuda(), cfg)
    for w, g in zip(a[:2] + tuple(a[2]), b[:2] + tuple(b[2])):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("allow", ["allow_tf32", "precision_high"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_exact_knn_on_card_ignores_tf32(cuda_device, metric, allow):
    # exact_knn's products run at full f32 precision even where the process
    # allows TF32 (by either of torch's switches), so the hnsw upper levels
    # do not depend on that setting; the setting is given back
    rng = np.random.RandomState(24)
    x = torch.from_numpy(rng.normal(size=(4096, 128)).astype(np.float32)
                         ).cuda()
    assert not torch.backends.cuda.matmul.allow_tf32
    want = exact_knn(x, x[:512], 24, metric=metric)
    try:
        if allow == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        got = exact_knn(x, x[:512], 24, metric=metric)
        assert torch.backends.cuda.matmul.allow_tf32
        if allow == "precision_high":
            assert torch.get_float32_matmul_precision() == "high"
    finally:
        if allow == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = False
        else:
            torch.set_float32_matmul_precision("highest")
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


# -- serving on the card ---------------------------------------------------

SERVE_STREAM = (1, 3, 7, 4, 2, 8, 11)
SERVE_PARAMS = dict(k=10, queue_len=32, m_max=4, num_walkers=4)


def _serve_index(quant: bool = False):
    """An index of 2,000 integer vectors on the card (kNN-12 plus 4 random
    out-edges), int8-quantized with ``quant``, and the stream's queries."""
    rng = np.random.RandomState(31)
    x = torch.from_numpy(rng.randint(0, 256, size=(2000, 32))
                         .astype(np.float32))
    q = rng.randint(0, 256, size=(sum(SERVE_STREAM), 32)).astype(np.float32)
    nbrs = torch.cat([knn_graph(x, 12), torch.from_numpy(
        rng.randint(0, 2000, size=(2000, 4)).astype(np.int32))], dim=1)
    graph = make_padded_csr(nbrs, x, device="cuda")
    spec = IndexSpec(metric="l2", degree=16)
    if quant:
        graph = quantize_graph(graph, QuantSpec("int8"))
        spec = spec.with_(quant="int8")
    return AnnIndex(spec, graph), q


def _same_served(served, direct):
    assert np.array_equal(served.ids, direct.ids.cpu().numpy())
    assert np.array_equal(served.dists, direct.dists.cpu().numpy())
    for name, d, s in zip(direct.stats._fields, direct.stats, served.stats):
        if name not in direct.stats.BATCH_RELATIVE:
            assert np.array_equal(s, d.cpu().numpy()), name
    assert np.array_equal(served.stats.uniq_comps
                          + served.stats.batch_dup_comps,
                          served.stats.dist_comps)


def test_engine_on_card_equals_search(cuda_device):
    index, q = _serve_index()
    params = SearchParams(**SERVE_PARAMS, backend="rowgather")
    engine = index.serve(params, bucket_sizes=(1, 2, 4, 8))
    assert set(engine.warmup()) == {1, 2, 4, 8}
    lo = 0
    for n in SERVE_STREAM:
        before = dict(_cuda.LAUNCHES)
        served = engine.search(q[lo:lo + n])
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["l2dist_rowgather"] > \
            before["l2dist_rowgather"]
        _same_served(served, index.search(q[lo:lo + n], params))
        lo += n
    assert engine.stats()["padded_queries"] == 3.0


def test_serve_async_on_card_equals_search(cuda_device):
    index, q = _serve_index()
    params = SearchParams(**SERVE_PARAMS, backend="rowgather")
    with index.serve_async(params, bucket_sizes=(1, 2, 4, 8),
                           max_wait_ms=1.0) as srv:
        futs = [srv.submit(v) for v in q[:16]]
        results = [f.result(timeout=120) for f in futs]
    for v, res in zip(q, results):
        want = index.search(v[None], params)
        assert np.array_equal(res.ids, want.ids[0].cpu().numpy())
        assert np.array_equal(res.dists, want.dists[0].cpu().numpy())
    assert srv.stats()["served"] == 16.0


@pytest.mark.parametrize("path", ["facade", "legacy"])
def test_int8_replicas_from_threads_equal_one_engine(cuda_device, path):
    """Two replicas of one int8 index, each searched by two threads at
    once: every request equals the single engine's answer.  The legacy
    engines share one DistFn (and its query-side memo) across threads."""
    index, q = _serve_index(quant=True)
    if path == "facade":
        def engine():
            return index.serve(SearchParams(**SERVE_PARAMS,
                                            backend="rowgather_int8",
                                            rerank_k=20),
                               bucket_sizes=(1, 2, 4, 8))
    else:
        def engine():
            cfg = SearchConfig(**SERVE_PARAMS,
                               dist_backend="rowgather_int8")
            return AnnEngine(index, cfg, bucket_sizes=(1, 2, 4, 8))
    single = engine()
    reqs = [q[i:i + 1 + i % 5] for i in range(24)]
    want = [single.search(r) for r in reqs]
    replicas = [engine(), engine()]
    start = threading.Barrier(4)
    got = [None] * len(reqs)

    def client(t):
        start.wait(timeout=30)
        for i in range(t, len(reqs), 4):
            got[i] = replicas[t % 2].search(reqs[i])
    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for w, g in zip(want, got):
        assert np.array_equal(g.ids, w.ids)
        assert np.array_equal(g.dists, w.dists)
        for name, a, b in zip(w.stats._fields, w.stats, g.stats):
            assert np.array_equal(a, b), name
