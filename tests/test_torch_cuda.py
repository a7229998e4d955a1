"""The CUDA kernels on the card, against their plain versions.

The f32 gather-distance kernels to 1e-5 (exact on integer data); the int8
kernels bit for bit; the bitonic co-sort exactly at every row length, and
the frontier merge on it equal to ``queue.insert``; the gather kernels and
searches through them past 65,535 query rows; index builds, live updates,
the α-prune and the hnsw descent on the card equal to the CPU's; the
walker-sharded search on (1, 1) and (1, 4) meshes through every f32
backend, and a 4-shard partitioned build, its corpus search and its engine,
equal to the CPU's; the LMs (dense, vlm, moe: ``moe_ffn`` and its lane
paths on (2, 4) and (1, 3) meshes; ssm, hybrid and encdec, and their
in-place decode step), kNN-LM and the train step equal to the CPU's.

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
from repro_torch.core.distributed import (ShardedIndex,
                                          build_partitioned_index,
                                          corpus_engine_searcher,
                                          make_search_mesh,
                                          walker_sharded_search)
from repro_torch.core.metrics import SearchStats
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


# -- distribution on the card ----------------------------------------------

def _on_cpu(graph):
    return graph._replace(**{f: t.cpu() for f, t in graph._asdict().items()
                             if isinstance(t, torch.Tensor)})


@pytest.mark.parametrize("backend", ["ref", "rowgather", "dma",
                                     "dedup_gather"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 4)])
def test_walker_sharded_on_card_equals_cpu(cuda_device, backend, shape):
    index, q = _serve_index()
    q = torch.from_numpy(q[:16])
    cfg = SearchConfig(k=10, queue_len=32, m_max=4, global_rounds=6,
                       dist_backend=backend)
    _cuda.reset_launches()
    got = walker_sharded_search(index.graph, q.cuda(), cfg,
                                make_search_mesh(shape))
    torch.cuda.synchronize()
    kernel = {"ref": None, "rowgather": "l2dist_rowgather",
              "dma": "l2dist_dma", "dedup_gather": "dedupdist"}[backend]
    assert sum(_cuda.LAUNCHES.values()) == _cuda.LAUNCHES.get(kernel, 0)
    assert kernel is None or _cuda.LAUNCHES[kernel] > 0
    want = walker_sharded_search(_on_cpu(index.graph), q, cfg,
                                 make_search_mesh(shape, device="cpu"))
    for name, g, w in zip(("ids", "dists") + SearchStats._fields,
                          (got[0], got[1], *got[2]),
                          (want[0], want[1], *want[2])):
        assert torch.equal(g.cpu(), w), name


def test_corpus_on_card_equals_cpu(cuda_device):
    """A 4-shard partition built on the card equals the CPU build, and its
    corpus search and engine on a (1, 4) mesh equal the CPU's."""
    rng = np.random.RandomState(41)
    x = rng.randint(0, 256, size=(2000, 32)).astype(np.float32)
    q = x[rng.choice(2000, 16, replace=False)] + 1
    spec = IndexSpec(degree=16, build_batch=512, build_backend="rowgather")
    card = build_partitioned_index(x, 4, spec)
    cpu = build_partitioned_index(x, 4, spec.with_(build_batch=32,
                                                   build_backend="ref"),
                                  device="cpu")
    for f in ShardedIndex._fields:
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    params = SearchParams(k=10, queue_len=32, backend="rowgather")
    _cuda.reset_launches()
    got = corpus_engine_searcher(card, params, make_search_mesh((1, 4)))(q)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["l2dist_rowgather"] > 0
    want = corpus_engine_searcher(cpu, params, make_search_mesh(
        (1, 4), device="cpu"))(q)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    engine = AnnEngine(card, params, mesh=make_search_mesh((2, 4)),
                       bucket_sizes=(2, 4, 8, 16))
    served = engine.search(q[:5])
    assert np.array_equal(served.ids, want[0][:5].numpy())
    assert np.array_equal(served.dists, want[1][:5].numpy())


# -- the LM's width and the kNN-LM path on the card --------------------------

@pytest.mark.parametrize("kernel", list(KERNELS))
def test_gather_kernels_exact_at_model_width(cuda_device, kernel):
    """d = 2048 (qwen2.5-3b's hidden states): the dedup tile shrinks and
    dma copies its runs in chunks.  Integer data in [0, 15] keeps every
    sum exact, so each kernel equals its plain version and rowgather, for
    a f32 and a bf16 table, at the datastore build's widest call."""
    rng = np.random.RandomState(51)
    x = rng.randint(0, 16, size=(4096, 2048)).astype(np.float32)
    ids = torch.from_numpy(rng.randint(-2, 4100, size=(1024, 64))
                           .astype(np.int32)).cuda()
    q = torch.from_numpy(rng.randint(0, 16, size=(1024, 2048))
                         .astype(np.float32)).cuda()
    fn, plain = KERNELS[kernel]
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.from_numpy(x).to("cuda", dtype)
        for metric in ("l2", "ip"):
            got = fn(table, ids, q, metric=metric)
            assert torch.equal(got, plain(table, ids, q, metric))
            assert torch.equal(got, l2dist_rowgather(table, ids, q,
                                                     metric=metric))


def _lm(arch, dtype):
    """A smoke model on the CPU and a copy of it on the card."""
    import copy
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    return cfg, cpu, copy.deepcopy(cpu).to("cuda")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen2-vl-7b"])
def test_causal_lm_on_card_equals_cpu(cuda_device, arch, dtype, tol):
    cfg, cpu, card = _lm(arch, dtype)
    toks = torch.from_numpy(np.random.RandomState(52).randint(
        0, cfg.vocab_size, size=(3, 12)))
    want, _ = cpu.forward(cpu, toks)
    got, _ = card.forward(card, toks.cuda())
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=tol,
                               atol=tol)
    lp_c, st_c = cpu.prefill(cpu, toks[:, :10], 14)
    lp_g, st_g = card.prefill(card, toks[:, :10].cuda(), 14)
    torch.testing.assert_close(lp_g.float().cpu(), lp_c.float(), rtol=tol,
                               atol=tol)
    for i in (10, 11):
        ld_c, st_c = cpu.decode_step(cpu, st_c, toks[:, i:i + 1])
        ld_g, st_g = card.decode_step(card, st_g, toks[:, i:i + 1].cuda())
    dtol = 3e-2 if dtype == "bfloat16" else tol
    torch.testing.assert_close(ld_g.float().cpu(), ld_c.float(), rtol=dtol,
                               atol=dtol)


@pytest.mark.parametrize("backend", ["rowgather", "dma", "dedup_gather"])
def test_knnlm_on_card_equals_cpu(cuda_device, backend, tmp_path):
    """A datastore built on the card (through rowgather), saved and loaded
    on the CPU: ``knnlm_logits`` through each kernel backend on the card
    equals the CPU's on the same hidden states and logits, ids exactly and
    log-probs to 1e-4 + 2e-5 · max(dist) / τ (a 1e-5 relative distance
    error's share of the exponent, either side)."""
    from repro_torch.data.tokens import TokenStream, _batch_at
    from repro_torch.serve import knnlm as tk

    cfg, cpu, card = _lm("qwen2.5-3b", "bfloat16")
    stream = TokenStream(cfg.vocab_size, 40, 4, 5, 0, 1)
    corpus = [_batch_at(stream, s)["tokens"] for s in range(4)]
    _cuda.reset_launches()
    ds_g = tk.build_datastore(card, card, corpus, cfg.vocab_size, degree=8,
                              build_batch=256, build_backend="rowgather")
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["l2dist_rowgather"] > 0
    ds_c = tk.KNNLMDatastore(
        AnnIndex.load(ds_g.index.save(str(tmp_path / "ds.npz")),
                      device="cpu"), ds_g.values.cpu(), cfg.vocab_size)
    q = torch.from_numpy(_batch_at(stream, 9)["tokens"])
    hidden = tk._final_hidden(card, card, q.cuda())[:, -1]
    lm = card.forward(card, q.cuda())[0][:, -1]
    p = SearchParams(k=8, queue_len=32, m_max=4, num_walkers=4,
                     backend=backend)
    _cuda.reset_launches()
    got, ids = tk.knnlm_logits(ds_g, hidden, lm, p)
    torch.cuda.synchronize()
    kernel = {"rowgather": "l2dist_rowgather", "dma": "l2dist_dma",
              "dedup_gather": "dedupdist"}[backend]
    assert _cuda.LAUNCHES[kernel] > 0
    assert sum(_cuda.LAUNCHES.values()) == _cuda.LAUNCHES[kernel]
    want, ids_c = tk.knnlm_logits(ds_c, hidden.cpu(), lm.cpu(), p)
    assert torch.equal(ids.cpu(), ids_c)
    dmax = float(ds_c.index.search(hidden.cpu().float(), p).dists.max())
    tol = 1e-4 + 2e-5 * dmax / 10.0
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=tol)


# -- the LM's decode past the cache and its training on the card -----------

def test_decode_past_s_max_on_card_equals_cpu(cuda_device):
    """Positions past a 10-slot cache write nothing (no device-side
    assert): the card's greedy tokens equal the CPU's."""
    from repro_torch.serve import ServeEngine
    _, cpu, card = _lm("qwen2.5-3b", "float32")
    prompt = np.random.RandomState(1).randint(0, 128, size=(3, 8))
    want, _ = ServeEngine(cpu, cpu, s_max=10).generate(prompt, steps=5)
    got, _ = ServeEngine(card, card, s_max=10).generate(prompt, steps=5)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def _train_case(device):
    import dataclasses
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import TokenStream, _batch_at
    from repro_torch.models import build_model
    from repro_torch.train.train_step import init_train_state
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"), dtype="float32")
    tcfg = TrainConfig(total_steps=10, warmup_steps=2, learning_rate=3e-3)
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0), tcfg)
    batch = _batch_at(TokenStream(cfg.vocab_size, 17, 4, 0, 0, 1), 0)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return build_model(cfg, device=device), tcfg, state, batch


def test_train_step_on_card_equals_cpu(cuda_device):
    """The gradients and loss of a smoke step on the card equal the CPU's
    (f32, 1e-5 of each leaf's largest); AdamW fed the CPU's gradients gives
    the CPU's update (1e-6); a whole step's metrics agree (1e-5)."""
    from repro_torch.optim import adamw_update
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import _zeros, loss_and_grad
    from repro_torch.treepath import flatten_with_path, tree_map
    model_c, tcfg, state, batch = _train_case("cpu")
    model_g, _, _, _ = _train_case("cuda")
    on_card = tree_map(lambda t: t.cuda(), state)
    batch_g = {k: v.cuda() for k, v in batch.items()}
    g_c, g_g = _zeros(state.params), _zeros(on_card.params)
    loss_c = loss_and_grad(model_c, state.params, batch, True, g_c)
    loss_g = loss_and_grad(model_g, on_card.params, batch_g, True, g_g)
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    for (p, a), (_, b) in zip(flatten_with_path(g_g), flatten_with_path(g_c)):
        tol = 1e-5 * float(b.abs().max())
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=tol, msg=str(p))
    u_c, o_c = adamw_update(g_c, state.opt, state.params, tcfg)
    u_g, o_g = adamw_update(tree_map(lambda t: t.cuda(), g_c), on_card.opt,
                            on_card.params, tcfg)
    for (p, a), (_, b) in zip(flatten_with_path((u_g, o_g)),
                              flatten_with_path((u_c, o_c))):
        tol = 1e-6 * float(b.abs().max().float())
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=tol,
                                   msg=str(p))
    _, m_c = make_train_step(model_c, tcfg)(state, batch)
    _, m_g = make_train_step(model_g, tcfg)(on_card, batch_g)
    for k in ("loss", "grad_norm"):
        assert abs(float(m_g[k]) - float(m_c[k])) <= 1e-5 * abs(float(m_c[k]))


def test_checkpoint_written_on_card_loads_on_cpu(cuda_device, tmp_path):
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.treepath import flatten_with_path, tree_map
    _, _, state, _ = _train_case("cpu")
    on_card = tree_map(lambda t: (t * 1.5 if t.is_floating_point() else t + 1)
                       .cuda(), state)
    save_checkpoint(str(tmp_path), 2, on_card)
    back = load_checkpoint(str(tmp_path), 2, state)
    for (p, a), (_, b) in zip(flatten_with_path(back),
                              flatten_with_path(on_card)):
        assert a.device.type == "cpu" and torch.equal(a, b.cpu()), p


def _moe_case(experts: int, cf: float, d_ff: int = 48):
    from repro_torch.config import FAMILY_MOE, ModelConfig, MoEConfig
    from repro_torch.models import moe
    cfg = ModelConfig(name="moe-t", family=FAMILY_MOE, num_layers=1,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=d_ff,
                      vocab_size=128, dtype="float32",
                      moe=MoEConfig(num_experts=experts, top_k=2,
                                    capacity_factor=cf))
    p = moe.moe_init(torch.Generator().manual_seed(experts), cfg,
                     torch.float32)
    x = torch.randn((4, 24, 64), generator=torch.Generator().manual_seed(9))
    return cfg, p, x


@pytest.mark.parametrize("cf", [4.0, 1.0])
def test_moe_ffn_on_card_equals_cpu(cuda_device, cf):
    """``moe_ffn`` and its gradients on the card equal the CPU's (f32,
    1e-5), with the same tokens dropped at cf 1.0; two runs on the card
    agree bit for bit, gradients included (no float atomics)."""
    from repro_torch.models import moe
    cfg, p, x = _moe_case(8, cf)
    w = torch.randn(x.shape, generator=torch.Generator().manual_seed(4))

    def run(device):
        pp = {k: v.detach().to(device).requires_grad_(True)
              for k, v in p.items()}
        xx = x.detach().to(device).requires_grad_(True)
        y, aux = moe.moe_ffn(pp, xx, cfg)
        (torch.sum(y * w.to(device)) + aux).backward()
        grads = {k: v.grad for k, v in pp.items()}
        return y.detach(), aux.detach(), xx.grad, grads
    y_c, aux_c, gx_c, g_c = run("cpu")
    y_g, aux_g, gx_g, g_g = run("cuda")
    torch.testing.assert_close(y_g.cpu(), y_c, rtol=1e-5, atol=1e-5)
    assert abs(float(aux_g) - float(aux_c)) <= 1e-6
    for k in g_c:
        tol = 1e-5 * float(g_c[k].abs().max())
        torch.testing.assert_close(g_g[k].cpu(), g_c[k], rtol=1e-5,
                                   atol=tol, msg=k)
    torch.testing.assert_close(gx_g.cpu(), gx_c, rtol=1e-5,
                               atol=1e-5 * float(gx_c.abs().max()))
    y2, aux2, gx2, g2 = run("cuda")
    assert torch.equal(y2, y_g) and torch.equal(aux2, aux_g)
    assert torch.equal(gx2, gx_g)
    assert all(torch.equal(g2[k], g_g[k]) for k in g_g)


@pytest.mark.parametrize("shape,experts", [((2, 4), 8), ((1, 3), 4)],
                         ids=["a2a-2x4", "tp-1x3"])
@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_moe_lane_paths_on_card_equal_cpu(cuda_device, shape, experts, cf):
    """``moe_ffn_sharded`` over a mesh of lanes on the card equals the
    same on the CPU (1e-5); where nothing drops (cf 8) it equals
    ``moe_ffn``."""
    from repro_torch.models import moe, moe_a2a
    from repro_torch.sharding import DEFAULT_RULES, use_rules
    cfg, p, x = _moe_case(experts, cf)
    out = {}
    for dev in ("cpu", "cuda"):
        mesh = make_search_mesh(shape, device=dev)
        pp = {k: v.to(dev) for k, v in p.items()}
        with use_rules(DEFAULT_RULES, mesh):
            out[dev] = moe_a2a.moe_ffn_sharded(pp, x.to(dev), cfg)
        if cf == 8.0:
            y0, aux0 = moe.moe_ffn(pp, x.to(dev), cfg)
            torch.testing.assert_close(out[dev][0], y0, rtol=1e-5, atol=1e-5)
            assert abs(float(out[dev][1]) - float(aux0)) <= 1e-6
    torch.testing.assert_close(out["cuda"][0].cpu(), out["cpu"][0],
                               rtol=1e-5, atol=1e-5)
    assert abs(float(out["cuda"][1]) - float(out["cpu"][1])) <= 1e-6


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "grok-1-314b"])
def test_moe_lm_on_card_equals_cpu(cuda_device, arch):
    """The moe smoke models (f32) on the card: forward logits and aux,
    prefill and two decode steps equal the CPU's (1e-4)."""
    cfg, cpu, card = _lm(arch, "float32")
    toks = torch.from_numpy(np.random.RandomState(53).randint(
        0, cfg.vocab_size, size=(3, 12)))
    want, aux_c = cpu.forward(cpu, toks)
    got, aux_g = card.forward(card, toks.cuda())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert abs(float(aux_g) - float(aux_c)) <= 1e-6
    lp_c, st_c = cpu.prefill(cpu, toks[:, :10], 14)
    lp_g, st_g = card.prefill(card, toks[:, :10].cuda(), 14)
    torch.testing.assert_close(lp_g.cpu(), lp_c, rtol=1e-4, atol=1e-4)
    for i in (10, 11):
        ld_c, st_c = cpu.decode_step(cpu, st_c, toks[:, i:i + 1])
        ld_g, st_g = card.decode_step(card, st_g, toks[:, i:i + 1].cuda())
    torch.testing.assert_close(ld_g.cpu(), ld_c, rtol=1e-4, atol=1e-4)


def test_moe_top_k_ties_on_card(cuda_device):
    """Among equal probabilities the lowest experts come first, as
    ``jax.lax.top_k`` orders them: a router of zeros routes every token to
    experts 0..k−1, and one expert above a tie leads it."""
    from repro_torch.models import moe
    x = torch.randn((4096, 64), generator=torch.Generator().manual_seed(5))
    _, _, top_e = moe.route(x.cuda(), torch.zeros((64, 128), device="cuda"),
                            8)
    assert torch.equal(top_e.cpu(), torch.arange(8).expand(4096, 8))
    probs = torch.full((4096, 128), 1 / 256, device="cuda")
    probs[:, 77] = 0.5
    _, idx = moe.top_k(probs, 8)
    assert torch.equal(idx.cpu(), torch.tensor([77, 0, 1, 2, 3, 4, 5, 6]
                                               ).expand(4096, 8))


# -- the ssm and hybrid families on the card --------------------------------

@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_ssm_lm_on_card_equals_cpu(cuda_device, arch):
    """The ssm and hybrid smoke models (f32) on the card: forward logits,
    prefill and two decode steps, and the decode state, equal the CPU's
    (1e-4)."""
    from repro_torch.treepath import tree_leaves
    cfg, cpu, card = _lm(arch, "float32")
    toks = torch.from_numpy(np.random.RandomState(54).randint(
        0, cfg.vocab_size, size=(3, 12)))
    torch.testing.assert_close(card.forward(card, toks.cuda()).cpu(),
                               cpu.forward(cpu, toks), rtol=1e-4, atol=1e-4)
    lp_c, st_c = cpu.prefill(cpu, toks[:, :10], 14)
    lp_g, st_g = card.prefill(card, toks[:, :10].cuda(), 14)
    torch.testing.assert_close(lp_g.cpu(), lp_c, rtol=1e-4, atol=1e-4)
    for i in (10, 11):
        ld_c, st_c = cpu.decode_step(cpu, st_c, toks[:, i:i + 1])
        ld_g, st_g = card.decode_step(card, st_g, toks[:, i:i + 1].cuda())
    torch.testing.assert_close(ld_g.cpu(), ld_c, rtol=1e-4, atol=1e-4)
    for g, c in zip(tree_leaves(st_g), tree_leaves(st_c)):
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_ssm_decode_inplace_on_card(cuda_device, arch):
    """A decode step with ``inplace=True`` on the card gives the logits
    and state of the pure step bit for bit, writing into the state it is
    given; the pure step leaves its input as it was."""
    from repro_torch.treepath import tree_leaves
    cfg, _, card = _lm(arch, "float32")
    toks = torch.from_numpy(np.random.RandomState(55).randint(
        0, cfg.vocab_size, size=(3, 9))).cuda()
    _, st = card.prefill(card, toks[:, :8], 12)
    before = [t.clone() for t in tree_leaves(st)]
    l_pure, s_pure = card.decode_step(card, st, toks[:, 8:])
    for a, b in zip(tree_leaves(st), before):
        assert torch.equal(a, b)
    l_in, s_in = card.decode_step(card, st, toks[:, 8:], inplace=True)
    assert torch.equal(l_in, l_pure)
    for a, b, c in zip(tree_leaves(s_in), tree_leaves(s_pure),
                       tree_leaves(st)):
        assert torch.equal(a, b)
        assert a is c or a.dim() == 1          # pos is a new tensor


# -- the encdec family on the card -------------------------------------------

def _whisper_inputs(cfg, seed, rows, seq):
    rs = np.random.RandomState(seed)
    frames = torch.from_numpy(rs.normal(size=(rows, cfg.encoder_ctx,
                                              cfg.d_model)).astype(np.float32))
    return frames, torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                               size=(rows, seq)))


def test_whisper_on_card_equals_cpu(cuda_device):
    """The whisper smoke model (f32) on the card: encoder states, forward
    logits, prefill and two decode steps, and the decode state (self
    caches, cross K/V, positions), equal the CPU's (1e-4)."""
    from repro_torch.treepath import tree_leaves
    cfg, cpu, card = _lm("whisper-large-v3", "float32")
    frames, toks = _whisper_inputs(cfg, 56, 3, 12)
    fg, tg = frames.cuda(), toks.cuda()
    torch.testing.assert_close(card.encode(card, fg).cpu(),
                               cpu.encode(cpu, frames), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(card.forward(card, fg, tg).cpu(),
                               cpu.forward(cpu, frames, toks), rtol=1e-4,
                               atol=1e-4)
    lp_c, st_c = cpu.prefill(cpu, frames, toks[:, :10], 14)
    lp_g, st_g = card.prefill(card, fg, tg[:, :10], 14)
    torch.testing.assert_close(lp_g.cpu(), lp_c, rtol=1e-4, atol=1e-4)
    for i in (10, 11):
        ld_c, st_c = cpu.decode_step(cpu, st_c, toks[:, i:i + 1])
        ld_g, st_g = card.decode_step(card, st_g, tg[:, i:i + 1])
    torch.testing.assert_close(ld_g.cpu(), ld_c, rtol=1e-4, atol=1e-4)
    for g, c in zip(tree_leaves(st_g), tree_leaves(st_c)):
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-4)


def test_whisper_decode_inplace_on_card(cuda_device):
    """A whisper decode step with ``inplace=True`` on the card gives the
    logits and state of the pure step bit for bit, writing into the self
    caches it is given; the pure step leaves its input as it was."""
    from repro_torch.treepath import tree_leaves
    cfg, _, card = _lm("whisper-large-v3", "float32")
    frames, toks = _whisper_inputs(cfg, 57, 3, 9)
    toks = toks.cuda()
    _, st = card.prefill(card, frames.cuda(), toks[:, :8], 12)
    before = [t.clone() for t in tree_leaves(st)]
    l_pure, s_pure = card.decode_step(card, st, toks[:, 8:])
    for a, b in zip(tree_leaves(st), before):
        assert torch.equal(a, b)
    l_in, s_in = card.decode_step(card, st, toks[:, 8:], inplace=True)
    assert torch.equal(l_in, l_pure)
    for a, b, c in zip(tree_leaves(s_in), tree_leaves(s_pure),
                       tree_leaves(st)):
        assert torch.equal(a, b)
        assert a is c or a.dim() == 1          # pos is a new tensor


def test_nccl_ranks_equal_lanes_on_card(cuda_device, tmp_path):
    """NCCL, one rank a card (``tests/torch_ranks_worker.py``): the walker
    path ((1, 4) bitmap and hash, (2, 4)), the partitioned build and the
    corpus search, two compressed DP steps, the ``Trainer`` resumed from
    a checkpoint the ranks wrote, and ``reshard_state`` over the ranks
    equal the same runs as lanes of each rank's card bit for bit.
    On one card the world is 1: the lanes travel through the NCCL code
    path."""
    import torch_ranks_worker as worker
    outs = worker.spawn_cards(str(tmp_path))
    for r, out in enumerate(outs):
        assert out["backend"] == "nccl" and out["device"] == f"cuda:{r}"
        assert out["ran"] and not out["diff"], out
