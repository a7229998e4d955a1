"""The launch plans of the ``dma`` and ``rowgather_int8`` kernels on the CPU.

``kernels.l2dist.dma_plan`` and ``quant.kernels.rowgather_int8_plan`` give
the grid, the candidates of a block and the shared-memory bytes that the
two CUDA kernels take (``csrc/dma.cu``, ``csrc/rowgather_int8.cu``).  Over
a sweep of (B <= 65535, C, d <= 960, f32/bf16/int8) each plan must fit a
Hopper block's 227 KB of shared memory and cover every candidate of the
(B, C) grid exactly once, with blocks laid out as the kernels read them.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.l2dist import (DMA_HEADER, DMA_RUN_MAX,
                                        DMA_SMEM_BUDGET, DMA_THREADS,
                                        dma_plan, l2dist_dma)
from repro_torch.quant.kernels import INT8_ROWS, rowgather_int8_plan

BS = [1, 2, 7, 64, 263, 512, 4097, 65535]
CS = [1, 5, 31, 32, 33, 250, 256, 1000, 4097, 100_000]
DS = [1, 16, 100, 128, 960]
SMEM_MAX = 227 * 1024


def _align16(x):
    return (x + 15) // 16 * 16


def _dma_coverage(p, b, c):
    """How often each candidate is reduced: every block (x, y) takes
    candidates [x·run, min(x·run + run, C)) of query y, in chunks of
    ``chunk`` rows."""
    counts = np.zeros((b, c), np.int64)
    for x in range(p.grid[0]):
        c0 = x * p.run
        rows = min(p.run, c - c0)
        for base in range(0, rows, p.chunk):
            n_rows = min(p.chunk, rows - base)
            counts[:, c0 + base:c0 + base + n_rows] += 1
    return counts


def _int8_coverage(p, b, c):
    """How often each candidate is reduced: lane t of block (x, y) takes
    query y·queries + t // slice, candidate x·slice + t % slice."""
    counts = np.zeros((b, c), np.int64)
    t = np.arange(INT8_ROWS)
    qi, ci = t // p.slice, t % p.slice
    for y in range(p.grid[1]):
        for x in range(p.grid[0]):
            bq, cc = y * p.queries + qi, x * p.slice + ci
            live = (qi < p.queries) & (bq < b) & (cc < c)
            np.add.at(counts, (bq[live], cc[live]), 1)
    return counts


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
            assert p.grid[1] == b
            assert p.grid[0] * p.run >= c > (p.grid[0] - 1) * p.run
            # a block for every SM where C allows it
            assert p.grid[0] * b >= min(_cuda.H100_SMS, b * c)
            if b * c <= 400_000:
                assert (_dma_coverage(p, b, c) == 1).all(), (b, c, d)


@pytest.mark.parametrize("b", BS)
def test_int8_plan_fits_and_covers_once(b):
    for c in CS:
        for d in DS:
            p = rowgather_int8_plan(b, c, d)
            assert p.smem == 4 * d * p.queries <= SMEM_MAX
            assert p.slice * p.queries <= INT8_ROWS
            assert p.queries == 1 or p.slice == c
            assert p.grid == (-(-c // p.slice), -(-b // p.queries))
            assert p.grid[1] <= 65535
            if b * c <= 400_000:
                assert (_int8_coverage(p, b, c) == 1).all(), (b, c, d)


def test_plans_at_the_search_steps():
    # speedann (B·W = 512 lanes x R = 32) and topm (64 x M·R = 256), d = 128
    p = dma_plan(512, 32, 128, torch.float32)
    assert (p.grid, p.run, p.chunk, p.buffers) == ((1, 512), 32, 32, 1)
    p = dma_plan(64, 256, 128, torch.float32)
    assert (p.grid, p.run, p.buffers) == ((8, 64), 32, 1)
    # rows too wide for one buffer of 32: chunks through two
    p = dma_plan(300, 1000, 960, torch.float32)
    assert (p.run, p.chunk, p.buffers) == (32, 12, 2)
    assert rowgather_int8_plan(512, 32, 128).grid == (1, 512)
    assert rowgather_int8_plan(64, 256, 128).grid == (8, 64)
    # few candidates: several queries share a block's 32 lanes
    p = rowgather_int8_plan(512, 8, 128)
    assert (p.slice, p.queries, p.grid) == (8, 4, (1, 128))


def test_dma_plan_takes_fewer_blocks_on_a_smaller_card():
    assert dma_plan(4, 1000, 128, torch.float32, sms=66).grid[0] < \
        dma_plan(4, 1000, 128, torch.float32).grid[0]


@pytest.mark.parametrize("fn,args", [
    (dma_plan, (0, 32, 128, torch.float32)),
    (dma_plan, (4, 32, 60_000, torch.float32)),
    (rowgather_int8_plan, (4, 0, 128)),
    (rowgather_int8_plan, (4, 32, 60_000)),
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
