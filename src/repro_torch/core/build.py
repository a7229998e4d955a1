"""Exact kNN and the kNN graph (the first part of ``repro.core.build``).

Blocked brute force: one ``torch.matmul`` per query block and
``torch.topk`` — the reference also computes these outside any Pallas
kernel (``_dist_block`` and ``lax.top_k`` under XLA).  Graph construction
proper (robust prune, NSG/HNSW builders, live updates) is not ported yet.

``torch.topk`` and ``lax.top_k`` may order exact distance ties
differently; compare them by distance, or on data without ties.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.asarray(x, np.float32))


def normalize_rows(x) -> torch.Tensor:
    """Unit-normalize rows (cosine = inner product on normalized vectors)."""
    x = _tensor(x).float()
    return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True),
                           min=1e-12)


def _dist_block(q: torch.Tensor, x: torch.Tensor, x2: torch.Tensor,
                metric: str) -> torch.Tensor:
    """(b, N) distances between a query block and the data; smaller =
    closer ("ip" = negative inner product)."""
    if metric == "ip":
        return -(q @ x.T)
    q2 = torch.sum(q * q, dim=1, keepdim=True)
    return q2 + x2[None, :] - 2.0 * (q @ x.T)


def exact_knn(data, queries, k: int, block: int = 2048,
              metric: str = "l2") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest neighbors of ``queries`` within ``data`` (tensors or
    arrays; the work runs on ``data``'s device).

    ``metric`` is "l2" (squared L2), "ip" (negative inner product), or
    "cosine" (ip after normalizing BOTH sides here).  Returns (ids (Q, k)
    int32, dists (Q, k) float32) sorted ascending, on ``data``'s device."""
    x = _tensor(data).float()
    q_all = _tensor(queries).float().to(x.device)
    if metric == "cosine":
        x, q_all = normalize_rows(x), normalize_rows(q_all)
        metric = "ip"
    x2 = torch.sum(x * x, dim=1)
    out_ids, out_d = [], []
    for s in range(0, q_all.shape[0], block):
        d = _dist_block(q_all[s:s + block], x, x2, metric)
        top_d, top_i = torch.topk(d, k, dim=1, largest=False, sorted=True)
        out_ids.append(top_i.to(torch.int32))
        out_d.append(top_d)
        del d
    return torch.cat(out_ids), torch.cat(out_d)


def knn_graph(data, k: int, block: int = 2048,
              metric: str = "l2") -> torch.Tensor:
    """(N, k) int32 kNN graph excluding self-edges, padded with the
    sentinel N (on ``data``'s device).  A stable sort on the self-edge mask
    compacts each row's non-self entries to the front, preserving distance
    order; slots past the row's valid count become the sentinel."""
    ids, _ = exact_knn(data, data, k + 1, block, metric=metric)
    n = ids.shape[0]
    self_id = torch.arange(n, dtype=torch.int32, device=ids.device)[:, None]
    valid = ids != self_id                                   # (N, k+1)
    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True).indices
    rows = ids.gather(1, order)[:, :k]
    cnt = valid.sum(dim=1).clamp(max=k)
    slot = torch.arange(k, device=ids.device)[None, :]
    return torch.where(slot < cnt[:, None], rows, n).to(torch.int32)
