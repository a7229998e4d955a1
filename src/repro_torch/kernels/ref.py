"""Plain-torch versions of the gather-distance kernels.

Every CUDA kernel of this package is held against the functions here: the
wrappers call them for CPU tensors, the CPU tests hold them against the
reference package, and ``chip_smoke.py`` holds each kernel against them on
the card.
"""
from __future__ import annotations

import torch


def _gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, C, d) float32 rows of ``table`` at ``ids`` clamped into
    [0, N-1]: negative ids read row 0 (the kernels do the same)."""
    return table[ids.long().clamp(0, table.shape[0] - 1)].float()


def dist_ref(table: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor,
             metric: str = "l2") -> torch.Tensor:
    """Gather + distance, batch-major.

    table:   (N, d) feature vectors (float32 or bfloat16)
    ids:     (B, C) int32 candidate ids; ids >= N are padding -> +inf;
             negative ids read row 0
    queries: (B, d)
    metric:  "l2" -> squared L2; "ip"/"cosine" -> negative inner product
    returns: (B, C) float32 distances, smaller = closer for every metric
    """
    rows = _gather_rows(table, ids)                       # (B, C, d)
    q = queries.float()[:, None, :]                       # (B, 1, d)
    if metric in ("ip", "cosine"):
        d = -torch.sum(rows * q, dim=-1)
    elif metric == "l2":
        d = torch.sum((rows - q) ** 2, dim=-1)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return torch.where(ids < table.shape[0], d, float("inf"))


def l2dist_ref(table: torch.Tensor, ids: torch.Tensor,
               queries: torch.Tensor) -> torch.Tensor:
    """Squared-L2 special case of :func:`dist_ref`."""
    return dist_ref(table, ids, queries, metric="l2")


def dist_expanded_ref(table: torch.Tensor, ids: torch.Tensor,
                      queries: torch.Tensor,
                      metric: str = "l2") -> torch.Tensor:
    """The ``dma`` kernel's arithmetic: l2 in the expanded form
    ``max(‖x‖² − 2x·q + ‖q‖², 0)``, ip as ``−x·q``; padding -> +inf."""
    rows = _gather_rows(table, ids)                       # (B, C, d)
    q = queries.float()
    xq = torch.sum(rows * q[:, None, :], dim=-1)
    if metric in ("ip", "cosine"):
        d = -xq
    elif metric == "l2":
        x2 = torch.sum(rows * rows, dim=-1)
        q2 = torch.sum(q * q, dim=-1, keepdim=True)
        d = torch.clamp(x2 - 2.0 * xq + q2, min=0.0)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return torch.where(ids < table.shape[0], d, float("inf"))
