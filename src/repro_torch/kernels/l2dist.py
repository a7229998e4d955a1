"""Fused gather + distance: the ``rowgather`` and ``dma`` kernels.

Wrappers of ``csrc/rowgather.cu`` and ``csrc/dma.cu`` (the Hopper ports of
``repro.kernels.l2dist.l2dist_rowgather`` / ``l2dist_dma``).  Both take a
(N, d) f32 or bf16 table, (B, C) int32 ids and (B, d) f32 queries and return
(B, C) f32 distances (l2 = squared L2; ip/cosine = negative inner product;
ids >= N give +inf; negative ids read row 0).  The batch-major engine calls them ONCE per global
step over the whole candidate grid.

For CPU tensors a wrapper returns its kernel's plain version
(``kernels.ref``); for CUDA tensors it launches the kernel or raises.
:func:`rowgather_plan` and :func:`dma_plan` are the two kernels' launch
layouts, in Python so that the CPU tests reach them.  Both grids are 1-D,
so no grid dimension limits B.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels import ref as _ref
from repro_torch.launch import op_profile


def _ip(metric: str) -> int:
    if metric not in ("l2", "ip", "cosine"):
        raise ValueError(f"unknown metric {metric!r}")
    return int(metric != "l2")


ROWGATHER_WARPS = 8   # kWarps: warps of a block, one task each
ROWGATHER_ROWS = 4    # kRows: candidates of a warp, at most
ROWGATHER_WORDS = 2   # kWords: 16-byte chunks of a row a lane loads at once


class RowgatherPlan(NamedTuple):
    """Launch layout of ``csrc/rowgather.cu``: a 1-D grid of ``blocks``
    blocks of :data:`ROWGATHER_WARPS` warps; warp task t takes ``rows``
    consecutive candidates of query t // ``tasks`` (``tasks`` warps a
    query); ``smem`` dynamic shared-memory bytes (0: rows and queries go
    straight to registers)."""
    blocks: int
    rows: int
    tasks: int
    smem: int


def rowgather_plan(b: int, c: int, d: int, dtype: torch.dtype,
                   sms: int = _cuda.H100_SMS) -> RowgatherPlan:
    """The ``rowgather`` kernel's layout for (B, C) candidates of a (N, d)
    ``dtype`` table on a card with ``sms`` SMs.  A warp takes up to
    :data:`ROWGATHER_ROWS` candidates of one query, all in flight at once:
    fewer where the grid would hold less than two blocks per SM, and fewer
    where a row is so wide that a lane reads it in several windows of
    :data:`ROWGATHER_WORDS` 16-byte chunks (one row a warp at d = 960 f32),
    so that the windows of a wide row spread over more warps (512 blocks of
    four-row warps at the speedann step, 512 x 32, and at the topm step,
    64 x 256)."""
    if b < 1 or c < 1 or d < 1:
        raise ValueError(f"l2dist_rowgather: empty launch B={b}, C={c}, "
                         f"d={d}")
    chunks = -(-d * torch.empty((), dtype=dtype).element_size() // 16)
    windows = -(-chunks // (32 * ROWGATHER_WORDS))
    rows = max(1, min(ROWGATHER_ROWS, ROWGATHER_ROWS // windows,
                      -(-b * c // (2 * sms * ROWGATHER_WARPS))))
    tasks = -(-c // rows)
    return RowgatherPlan(-(-b * tasks // ROWGATHER_WARPS), rows, tasks, 0)


DMA_THREADS = 256            # kDmaThreads: 8 warps
DMA_HEADER = 32              # kDmaHeader: two mbarriers and |q|^2
DMA_SMEM_BUDGET = 96 * 1024  # a block's buffers fit two blocks on an SM
DMA_RUN_MAX = 32             # candidates of a block: 4 for each of 8 warps


class DmaPlan(NamedTuple):
    """Launch layout of ``csrc/dma.cu``: a 1-D grid of ``blocks`` =
    ``runs`` × B blocks of :data:`DMA_THREADS`; block k takes ``run``
    consecutive candidates (the (k % runs)-th run) of query k // runs and
    copies them ``chunk`` rows at a time through ``buffers`` shared-memory
    buffers; ``smem`` dynamic shared-memory bytes."""
    blocks: int
    runs: int
    run: int
    chunk: int
    buffers: int
    smem: int


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def dma_plan(b: int, c: int, d: int, dtype: torch.dtype,
             sms: int = _cuda.H100_SMS) -> DmaPlan:
    """The ``dma`` kernel's layout for (B, C) candidates of a (N, d)
    ``dtype`` table on a card with ``sms`` SMs.  Each query's C candidates
    are split into runs of at most :data:`DMA_RUN_MAX`, and into more
    until the grid holds two blocks per SM, so that every row is in flight
    at once and each warp reduces its rows in one pass (512 blocks at the
    speedann step, 512 x 32, and at the topm step, 64 x 256).  A run whose
    rows fit :data:`DMA_SMEM_BUDGET` is one buffer; a wider one is copied
    in chunks through two."""
    if b < 1 or c < 1 or d < 1:
        raise ValueError(f"l2dist_dma: empty launch B={b}, C={c}, d={d}")
    row = d * torch.empty((), dtype=dtype).element_size()
    splits = min(c, max(-(-2 * sms // b), -(-c // DMA_RUN_MAX)))
    run = -(-c // splits)
    splits = -(-c // run)
    fixed = _align16(4 * d) + _align16(4 * run) + DMA_HEADER
    if fixed + run * row <= DMA_SMEM_BUDGET:
        chunk, buffers = run, 1
    else:
        chunk = min(run, max(1, (DMA_SMEM_BUDGET - fixed) // (2 * row)))
        buffers = 2
    smem = fixed + buffers * chunk * row
    if smem > _cuda.SMEM_MAX:
        raise ValueError(f"l2dist_dma: d = {d} rows do not fit a block's "
                         f"shared memory ({smem} > {_cuda.SMEM_MAX} bytes)")
    return DmaPlan(splits * b, splits, run, chunk, buffers, smem)


def l2dist_rowgather(table: torch.Tensor, ids: torch.Tensor,
                     queries: torch.Tensor, *, metric: str = "l2"
                     ) -> torch.Tensor:
    """Up to four candidates a warp, laid out by :func:`rowgather_plan`;
    see ``csrc/rowgather.cu``."""
    _cuda.check_inputs("l2dist_rowgather", table, ids, queries)
    ip = _ip(metric)
    if table.device.type == "cpu":
        return _ref.dist_ref(table, ids, queries, metric)
    out = torch.empty(ids.shape, dtype=torch.float32, device=table.device)
    if out.numel():
        if op_profile.ACTIVE is not None:
            op_profile.report_gather("l2dist_rowgather", table, ids,
                                     queries, out, 3 - ip, "f32")
        if _cuda.traced(out):
            return out
        plan = rowgather_plan(ids.shape[0], ids.shape[1], table.shape[1],
                              table.dtype, _cuda.sm_count(table.device))
        _cuda.launch("rowgather", "l2dist_rowgather",
                     table, int(table.dtype == torch.bfloat16),
                     table.shape[0], table.shape[1], ids, ids.shape[0],
                     ids.shape[1], queries, out, ip,
                     _cuda.vec_ok(table, queries), plan.blocks, plan.rows,
                     plan.tasks, plan.smem)
    return out


def l2dist_dma(table: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor,
               *, g: int = 8, metric: str = "l2") -> torch.Tensor:
    """Runs of a query's rows gathered by bulk async copies, expanded-form
    distances; see ``csrc/dma.cu``.  ``g`` (the reference's tile, checked
    here) does not shape the kernel, which takes any C."""
    _cuda.check_inputs("l2dist_dma", table, ids, queries)
    ip = _ip(metric)
    if not 1 <= g <= 64:
        raise ValueError(f"l2dist_dma: tile g={g} outside [1, 64]")
    if table.device.type == "cpu":
        return _ref.dist_expanded_ref(table, ids, queries, metric)
    out = torch.empty(ids.shape, dtype=torch.float32, device=table.device)
    if out.numel():
        if op_profile.ACTIVE is not None:
            op_profile.report_gather("l2dist_dma", table, ids, queries,
                                     out, 3 - ip, "f32")
        if _cuda.traced(out):
            return out
        plan = dma_plan(ids.shape[0], ids.shape[1], table.shape[1],
                        table.dtype, _cuda.sm_count(table.device))
        _cuda.launch("dma", "l2dist_dma",
                     table, int(table.dtype == torch.bfloat16),
                     table.shape[0], table.shape[1], ids, ids.shape[0],
                     ids.shape[1], queries, out, ip,
                     _cuda.vec_ok(table, queries), plan.blocks, plan.runs,
                     plan.run, plan.chunk, plan.buffers, plan.smem)
    return out
