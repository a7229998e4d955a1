"""Fused gather + distance: the ``rowgather`` and ``dma`` kernels.

Wrappers of ``csrc/rowgather.cu`` and ``csrc/dma.cu`` (the Hopper ports of
``repro.kernels.l2dist.l2dist_rowgather`` / ``l2dist_dma``).  Both take a
(N, d) f32 or bf16 table, (B, C) int32 ids and (B, d) f32 queries and return
(B, C) f32 distances (l2 = squared L2; ip/cosine = negative inner product;
ids >= N give +inf; negative ids read row 0).  The batch-major engine calls them ONCE per global
step over the whole candidate grid.

For CPU tensors a wrapper returns its kernel's plain version
(``kernels.ref``); for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels import ref as _ref


def _ip(metric: str) -> int:
    if metric not in ("l2", "ip", "cosine"):
        raise ValueError(f"unknown metric {metric!r}")
    return int(metric != "l2")


def l2dist_rowgather(table: torch.Tensor, ids: torch.Tensor,
                     queries: torch.Tensor, *, metric: str = "l2"
                     ) -> torch.Tensor:
    """One warp per candidate; see ``csrc/rowgather.cu``."""
    _cuda.check_inputs("l2dist_rowgather", table, ids, queries)
    ip = _ip(metric)
    if table.device.type == "cpu":
        return _ref.dist_ref(table, ids, queries, metric)
    out = torch.empty(ids.shape, dtype=torch.float32, device=table.device)
    if out.numel():
        _cuda.launch("rowgather", "l2dist_rowgather",
                     table, int(table.dtype == torch.bfloat16),
                     table.shape[0], table.shape[1], ids, ids.shape[0],
                     ids.shape[1], queries, out, ip,
                     _cuda.vec_ok(table, queries))
    return out


def l2dist_dma(table: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor,
               *, g: int = 8, metric: str = "l2") -> torch.Tensor:
    """Tiles of ``g`` rows gathered by cp.async, expanded-form distances;
    see ``csrc/dma.cu``.  A ragged last tile is masked in the kernel."""
    _cuda.check_inputs("l2dist_dma", table, ids, queries)
    ip = _ip(metric)
    if not 1 <= g <= 64:
        raise ValueError(f"l2dist_dma: tile g={g} outside [1, 64]")
    if table.device.type == "cpu":
        return _ref.dist_expanded_ref(table, ids, queries, metric)
    out = torch.empty(ids.shape, dtype=torch.float32, device=table.device)
    if out.numel():
        _cuda.launch("dma", "l2dist_dma",
                     table, int(table.dtype == torch.bfloat16),
                     table.shape[0], table.shape[1], ids, ids.shape[0],
                     ids.shape[1], queries, out, ip,
                     _cuda.vec_ok(table, queries), g)
    return out
