"""The launch plans of the ``rowgather``, ``dma`` and ``rowgather_int8``
kernels on the CPU.

``kernels.l2dist.rowgather_plan``, ``kernels.l2dist.dma_plan`` and
``quant.kernels.rowgather_int8_plan`` give the 1-D grid, the candidates of a
warp or block and the shared-memory bytes that the three CUDA kernels take
(``csrc/rowgather.cu``, ``csrc/dma.cu``, ``csrc/rowgather_int8.cu``).  Over
a sweep of (B up to 2^20, past the 65,535 that a grid's y dimension would
allow, C, d <= 960, f32/bf16/int8) each plan must fit a Hopper block's
227 KB of shared memory and cover every candidate of the (B, C) grid exactly
once, with blocks decoded from their 1-D index as the kernels decode them.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.l2dist import (DMA_HEADER, DMA_RUN_MAX,
                                        DMA_SMEM_BUDGET, DMA_THREADS,
                                        ROWGATHER_ROWS, ROWGATHER_WARPS,
                                        dma_plan, l2dist_dma, rowgather_plan)
from repro_torch.quant.kernels import INT8_ROWS, rowgather_int8_plan

BS = [1, 2, 7, 64, 263, 512, 4097, 65535, 65536, 65573, 2**20]
CS = [1, 5, 31, 32, 33, 250, 256, 1000, 4097, 100_000]
DS = [1, 16, 100, 128, 960]
SMEM_MAX = 227 * 1024
COVERAGE_MAX = 400_000        # grids whose (B, C) counts are checked cell by cell


def _align16(x):
    return (x + 15) // 16 * 16


def _rowgather_coverage(p, b, c):
    """How often each candidate is reduced: warp task t of the 1-D grid
    (block t // 8, warp t % 8) takes candidates [c0, c0 + rows) ∩ [0, C)
    of query t // tasks, c0 = (t % tasks)·rows; tasks past B·tasks
    return."""
    counts = np.zeros((b, c), np.int64)
    t = np.arange(p.blocks * ROWGATHER_WARPS)
    t = t[t < b * p.tasks]
    q, c0 = t // p.tasks, (t % p.tasks) * p.rows
    for r in range(p.rows):
        live = c0 + r < c
        np.add.at(counts, (q[live], c0[live] + r), 1)
    return counts


def _dma_coverage(p, b, c):
    """How often each candidate is reduced: block k of the 1-D grid takes
    candidates [x·run, min(x·run + run, C)) of query k // runs, x =
    k % runs, in chunks of ``chunk`` rows."""
    counts = np.zeros((b, c), np.int64)
    k = np.arange(p.blocks)
    q, x = k // p.runs, k % p.runs
    for xr in range(p.runs):
        c0 = xr * p.run
        rows = min(p.run, c - c0)
        for base in range(0, rows, p.chunk):
            n_rows = min(p.chunk, rows - base)
            counts[q[x == xr], c0 + base:c0 + base + n_rows] += 1
    return counts


def _int8_coverage(p, b, c):
    """How often each candidate is reduced: lane t of block k takes query
    (k // slices)·queries + t // slice, candidate (k % slices)·slice +
    t % slice."""
    counts = np.zeros((b, c), np.int64)
    t = np.arange(INT8_ROWS)
    qi, ci = t // p.slice, t % p.slice
    for k in range(p.blocks):
        y, x = divmod(k, p.slices)
        bq, cc = y * p.queries + qi, x * p.slice + ci
        live = (qi < p.queries) & (bq < b) & (cc < c)
        np.add.at(counts, (bq[live], cc[live]), 1)
    return counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", BS)
def test_rowgather_plan_fits_and_covers_once(dtype, b):
    elt = torch.empty((), dtype=dtype).element_size()
    for c in CS:
        for d in DS:
            p = rowgather_plan(b, c, d, dtype)
            assert p.smem == 0
            assert 1 <= p.rows <= ROWGATHER_ROWS
            assert p.tasks == -(-c // p.rows)
            assert p.blocks == -(-b * p.tasks // ROWGATHER_WARPS)
            # a warp keeps at most ROWGATHER_ROWS x ROWGATHER_WORDS chunks
            # a lane in flight; a wide row spreads over more warps
            if d * elt > 2 * 16 * 32:
                assert p.rows < ROWGATHER_ROWS
            # a block for every SM where B·C allows it
            assert p.blocks >= min(_cuda.H100_SMS,
                                   -(-b * c // (ROWGATHER_ROWS
                                                * ROWGATHER_WARPS)))
            if b * c <= COVERAGE_MAX:
                assert (_rowgather_coverage(p, b, c) == 1).all(), (b, c, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", BS)
def test_dma_plan_fits_and_covers_once(dtype, b):
    elt = torch.empty((), dtype=dtype).element_size()
    for c in CS:
        for d in DS:
            p = dma_plan(b, c, d, dtype)
            assert p.smem <= SMEM_MAX
            assert p.smem == (_align16(4 * d) + _align16(4 * p.run)
                              + DMA_HEADER + p.buffers * p.chunk * d * elt)
            assert 1 <= p.chunk <= p.run <= DMA_RUN_MAX <= DMA_THREADS
            assert p.buffers == 2 or p.chunk == p.run
            if p.buffers == 2:
                assert p.smem <= DMA_SMEM_BUDGET + 2 * d * elt
            assert p.blocks == p.runs * b
            assert p.runs * p.run >= c > (p.runs - 1) * p.run
            # a block for every SM where C allows it
            assert p.blocks >= min(_cuda.H100_SMS, b * c)
            if b * c <= COVERAGE_MAX:
                assert (_dma_coverage(p, b, c) == 1).all(), (b, c, d)


@pytest.mark.parametrize("b", BS)
def test_int8_plan_fits_and_covers_once(b):
    for c in CS:
        for d in DS:
            p = rowgather_int8_plan(b, c, d)
            assert p.smem == 4 * d * p.queries <= SMEM_MAX
            assert p.slice * p.queries <= INT8_ROWS
            assert p.queries == 1 or p.slice == c
            assert p.slices == -(-c // p.slice)
            # one 1-D grid over (slice, query group): the last block takes
            # the last group, however many groups B makes
            assert p.blocks == p.slices * -(-b // p.queries)
            assert (p.blocks - 1) // p.slices == -(-b // p.queries) - 1
            if b * c <= COVERAGE_MAX:
                assert (_int8_coverage(p, b, c) == 1).all(), (b, c, d)


def test_plans_at_the_search_steps():
    # speedann (B·W = 512 lanes x R = 32) and topm (64 x M·R = 256), d = 128
    for b, c in ((512, 32), (64, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            p = rowgather_plan(b, c, 128, dtype)
            assert (p.blocks, p.rows, p.tasks) == (512, 4, c // 4)
    # d = 960: one row a warp in f32 (four windows), two in bf16
    assert rowgather_plan(300, 1000, 960, torch.float32).rows == 1
    assert rowgather_plan(300, 1000, 960, torch.bfloat16).rows == 2
    p = dma_plan(512, 32, 128, torch.float32)
    assert (p.blocks, p.runs, p.run, p.chunk, p.buffers) == (512, 1, 32, 32,
                                                             1)
    p = dma_plan(64, 256, 128, torch.float32)
    assert (p.blocks, p.runs, p.run, p.buffers) == (512, 8, 32, 1)
    # rows too wide for one buffer of 32: chunks through two
    p = dma_plan(300, 1000, 960, torch.float32)
    assert (p.run, p.chunk, p.buffers) == (32, 12, 2)
    assert rowgather_int8_plan(512, 32, 128)[:2] == (512, 1)
    assert rowgather_int8_plan(64, 256, 128)[:2] == (512, 8)
    # few candidates: several queries share a block's 32 lanes
    p = rowgather_int8_plan(512, 8, 128)
    assert (p.slice, p.queries, p.blocks, p.slices) == (8, 4, 128, 1)


@pytest.mark.parametrize("b", [65535, 65536, 65573, 8192 * 8])
def test_plans_past_the_grid_y_limit(b):
    # speedann's distance call at 8,192+ queries and W = 8 walkers: B·W
    # query rows, once over the 65,535 a grid's y dimension allows
    p = rowgather_plan(b, 32, 128, torch.float32)
    assert p.blocks == b and (p.blocks * ROWGATHER_WARPS - 1) // p.tasks \
        == b - 1
    p = dma_plan(b, 32, 128, torch.float32)
    assert p.blocks == b and (p.blocks - 1) // p.runs == b - 1
    p = rowgather_int8_plan(b, 32, 128)
    assert p.blocks == b and (p.blocks - 1) // p.slices == b - 1


def test_dma_plan_takes_fewer_blocks_on_a_smaller_card():
    assert dma_plan(4, 1000, 128, torch.float32, sms=66).blocks < \
        dma_plan(4, 1000, 128, torch.float32).blocks
    assert rowgather_plan(4, 1000, 128, torch.float32, sms=66).blocks < \
        rowgather_plan(4, 1000, 128, torch.float32).blocks


@pytest.mark.parametrize("fn,args", [
    (dma_plan, (0, 32, 128, torch.float32)),
    (dma_plan, (4, 32, 60_000, torch.float32)),
    (rowgather_int8_plan, (4, 0, 128)),
    (rowgather_int8_plan, (4, 32, 60_000)),
    (rowgather_plan, (0, 32, 128, torch.float32)),
    (rowgather_plan, (4, 32, 0, torch.bfloat16)),
])
def test_plans_reject_what_no_block_holds(fn, args):
    with pytest.raises(ValueError):
        fn(*args)


@pytest.mark.parametrize("g", [1, 2, 8, 33, 64])
def test_dma_accepts_tiles_1_to_64(g):
    rng = np.random.RandomState(g)
    table = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, 41, size=(3, 11)).astype(np.int32))
    q = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    assert l2dist_dma(table, ids, q, g=g).shape == (3, 11)


@pytest.mark.parametrize("g", [0, 65, -8])
def test_dma_rejects_tiles_outside_1_to_64(g):
    table = torch.zeros((10, 8))
    ids = torch.zeros((2, 4), dtype=torch.int32)
    q = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="outside"):
        l2dist_dma(table, ids, q, g=g)
