"""Plain-torch versions of the gather-distance and bitonic kernels.

The f32 kernels and the co-sort are held against the functions here (the
int8 kernels' plain version is ``quant.kernels.int8dist_ref``): the
wrappers call them for CPU tensors, the CPU tests hold them against the
reference package, and ``chip_smoke.py`` holds each kernel against them on
the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.queue import _sort_by


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



def sort_pairs_ref(keys: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor):
    """Plain version of the bitonic co-sort: rows of (B, n) f32 keys and
    int32 payloads sorted ascending in the kernel's total order (key, p0,
    p1), as three stable sorts: p1, then p0, then key.  ``torch.sort``
    compares -0.0 and +0.0 as equal, as the kernel does."""
    order = torch.sort(p1, dim=-1, stable=True).indices
    return _sort_by(*(t.gather(-1, order) for t in (keys, p0, p1)))


def topl_merge_ref(q_dists: torch.Tensor, q_ids: torch.Tensor,
                   q_meta: torch.Tensor, c_dists: torch.Tensor,
                   c_ids: torch.Tensor, invalid_id: int):
    """Plain frontier merge (``repro.kernels.ref.topl_merge_ref``): queue
    rows (B, L) merge with candidates (B, C); duplicate ids keep the queue
    entry; returns the ascending (dist, id) top-L (dists, ids, meta) and
    the update position per row."""
    qlen = q_ids.shape[-1]
    ids = torch.cat([q_ids, c_ids], dim=-1)
    dists = torch.cat([q_dists, c_dists], dim=-1)
    meta = torch.cat([q_meta, torch.zeros_like(c_ids)], dim=-1)
    is_new = torch.cat([torch.zeros_like(q_ids), torch.ones_like(c_ids)],
                       dim=-1)
    # pass 1: by (id, is_new); drop dups
    ids, is_new, dists, meta = _sort_by(ids, is_new, dists, meta)
    dup = torch.cat([torch.zeros_like(ids[..., :1], dtype=torch.bool),
                     (ids[..., 1:] == ids[..., :-1])
                     & (ids[..., 1:] != invalid_id)], dim=-1)
    ids = torch.where(dup, invalid_id, ids)
    dists = torch.where(dup, float("inf"), dists)
    # pass 2: by (dist, id)
    dists, ids, meta, is_new = _sort_by(dists, ids, meta, is_new)
    rank = torch.arange(ids.shape[-1], dtype=torch.int32, device=ids.device)
    surv = (is_new == 1) & (ids != invalid_id) & (rank < qlen)
    up = torch.where(surv, rank, qlen).amin(dim=-1).to(torch.int32)
    return dists[..., :qlen], ids[..., :qlen], meta[..., :qlen], up
