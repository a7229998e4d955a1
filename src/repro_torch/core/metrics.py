"""Search-quality and search-work metrics (port of ``repro.core.metrics``)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# sentinel for masked-out candidate slots in first-toucher counting; real
# graph ids are always < n_nodes < 2**31 - 1
_UNIQ_SENTINEL = 2**31 - 1


def recall_at_k(found_ids, gt_ids, k: int) -> float:
    """Recall@K (Eq. 1): |found ∩ true| / K, averaged over queries."""
    found = _host(found_ids)[:, :k]
    gt = _host(gt_ids)[:, :k]
    hits = 0
    for f, g in zip(found, gt):
        hits += len(set(int(x) for x in f) & set(int(x) for x in g))
    return hits / (found.shape[0] * k)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class SearchStats(NamedTuple):
    """Per-query work counters (paper Figures 5–9, 16, 18); every leaf is a
    (B,) int32 tensor.  See ``repro.core.metrics.SearchStats`` for the
    definitions; ``uniq_comps + batch_dup_comps == dist_comps`` per lane."""
    steps: torch.Tensor
    local_steps: torch.Tensor
    dist_comps: torch.Tensor
    dup_comps: torch.Tensor
    syncs: torch.Tensor
    crit_rounds: torch.Tensor
    uniq_comps: torch.Tensor
    batch_dup_comps: torch.Tensor

    @staticmethod
    def zero_batch(batch: int, device=None) -> "SearchStats":
        """Per-query counters stacked on a leading (B,) axis."""
        return SearchStats(*(torch.zeros((batch,), dtype=torch.int32,
                                         device=device)
                             for _ in range(8)))

    BATCH_RELATIVE = ("uniq_comps", "batch_dup_comps")

    def summary(self) -> dict:
        return {k: float(v.double().mean())
                for k, v in self._asdict().items()}


# the fields the serving stack surfaces as per-lane distributions
TELEMETRY = ("steps", "crit_rounds", "dist_comps", "uniq_comps",
             "batch_dup_comps")


def telemetry_per_lane(stats: SearchStats) -> dict:
    """Host-side view of the TELEMETRY leaves: field -> (B,) float64 array."""
    return {field: _host(getattr(stats, field)).astype(
        np.float64).reshape(-1) for field in TELEMETRY}


def batch_unique_counts(ids: torch.Tensor,
                        counted: torch.Tensor) -> torch.Tensor:
    """First-toucher attribution of one step's expansion across lanes.

    ``ids`` (B, C) candidate ids, ``counted`` (B, C) bool.  Returns (B,)
    int32: per lane, how many of its counted candidates were NOT counted by
    any lower-index lane.  A stable sort by id keeps the flattened row-major
    (= lane) order inside every id group, so the group's first element
    belongs to the first touching lane."""
    b, c = ids.shape
    flat = torch.where(counted, ids, _UNIQ_SENTINEL).reshape(-1)
    lane = torch.arange(b, dtype=torch.int64,
                        device=ids.device).repeat_interleave(c)
    sorted_ids, order = torch.sort(flat, stable=True)
    sorted_lane = lane[order]
    prev = torch.cat([sorted_ids.new_full((1,), _UNIQ_SENTINEL - 1),
                      sorted_ids[:-1]])
    first = (sorted_ids != _UNIQ_SENTINEL) & (sorted_ids != prev)
    out = torch.zeros((b,), dtype=torch.int32, device=ids.device)
    return out.index_add_(0, sorted_lane, first.to(torch.int32))
