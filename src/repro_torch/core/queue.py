"""Bounded sorted frontier ("priority queue S" of Algorithm 1/3).

Port of ``repro.core.queue``.  Every op here is leading-dims agnostic: a
single query's frontier is ``(L,)``, the batch-major engine's is ``(B, L)``
and a walker pool's ``(B, W, L)``; the ops work on the last axis, so the
``*_batch`` names are the same functions (the reference vmaps the
single-query forms; writing the batch axis out is the same computation).

Sort order is (dist, id) ascending; empty slots carry dist=+inf /
id=INVALID_ID so they sort last.  The reference's stable two-key co-sort
(``lax.sort(num_keys=2, is_stable=True)``) is two stable ``torch.sort``
passes: the minor key first, then the major key.  ``lax.sort`` compares
-0.0 and +0.0 as equal, as ``torch.sort`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

INVALID_ID = 2**31 - 1
INF = float("inf")


class Frontier(NamedTuple):
    ids: torch.Tensor      # (..., L) int32, INVALID_ID for empty slots
    dists: torch.Tensor    # (..., L) float32, +inf for empty slots
    checked: torch.Tensor  # (..., L) bool, True for empty slots


def make_frontier(capacity: int, device=None) -> Frontier:
    return make_frontier_batch(capacity, (), device)


def make_frontier_batch(capacity: int, batch, device=None) -> Frontier:
    """A stacked (*batch, L) frontier; every row is ``make_frontier``."""
    shape = (tuple(batch) if isinstance(batch, (tuple, list)) else (batch,))
    shape = shape + (capacity,)
    return Frontier(
        ids=torch.full(shape, INVALID_ID, dtype=torch.int32, device=device),
        dists=torch.full(shape, INF, dtype=torch.float32, device=device),
        checked=torch.ones(shape, dtype=torch.bool, device=device),
    )


def frontier_valid(f: Frontier) -> torch.Tensor:
    return f.ids != INVALID_ID


def _sort_by(keys1, keys2, *payload):
    """Stable co-sort by (keys1, keys2) ascending along the last axis."""
    order = torch.sort(keys2, dim=-1, stable=True).indices
    order = order.gather(-1, torch.sort(keys1.gather(-1, order), dim=-1,
                                        stable=True).indices)
    return tuple(t.gather(-1, order) for t in (keys1, keys2) + payload)


def _dup_of_previous(ids: torch.Tensor) -> torch.Tensor:
    """Mask of slots whose (sorted) id repeats the previous slot's."""
    same = (ids[..., 1:] == ids[..., :-1]) & (ids[..., 1:] != INVALID_ID)
    return torch.cat([torch.zeros_like(ids[..., :1], dtype=torch.bool),
                      same], dim=-1)


def insert(f: Frontier, new_ids: torch.Tensor, new_dists: torch.Tensor
           ) -> Tuple[Frontier, torch.Tensor, torch.Tensor]:
    """Merge (..., C) candidates into a (..., L) frontier.

    Candidates with id >= INVALID_ID or dist == +inf are ignored.  Duplicate
    ids collapse to a single entry, preferring an existing (possibly checked)
    queue entry over a fresh one.  Returns ``(frontier', update_position,
    n_inserted)``: ``update_position`` is the best rank among surviving new
    entries, saturating at L when nothing improved (the §4.3 sync metric).
    """
    cap = f.ids.shape[-1]
    new_ids = new_ids.to(torch.int32)
    new_dists = new_dists.to(torch.float32)
    bad = (new_ids < 0) | (new_ids == INVALID_ID) | ~torch.isfinite(new_dists)
    new_ids = torch.where(bad, INVALID_ID, new_ids)
    new_dists = torch.where(bad, INF, new_dists)

    ids = torch.cat([f.ids, new_ids], dim=-1)
    dists = torch.cat([f.dists, new_dists], dim=-1)
    checked = torch.cat([f.checked.to(torch.int32),
                         torch.zeros_like(new_ids)], dim=-1)
    is_new = torch.cat([torch.zeros_like(f.ids),
                        torch.ones_like(new_ids)], dim=-1)

    # Pass 1: group by id (old entries first within a group), drop duplicates.
    ids, is_new, dists, checked = _sort_by(ids, is_new, dists, checked)
    dup = _dup_of_previous(ids)
    ids = torch.where(dup, INVALID_ID, ids)
    dists = torch.where(dup, INF, dists)

    # Pass 2: re-sort by (dist, id); truncate to capacity.
    dists, ids, checked, is_new = _sort_by(dists, ids, checked, is_new)
    kept = Frontier(ids=ids[..., :cap], dists=dists[..., :cap],
                    checked=(checked[..., :cap] == 1)
                    | (ids[..., :cap] == INVALID_ID))

    rank = torch.arange(ids.shape[-1], dtype=torch.int32, device=ids.device)
    surviving_new = (is_new == 1) & (ids != INVALID_ID) & (rank < cap)
    update_pos = torch.where(surviving_new, rank, cap).amin(dim=-1)
    n_inserted = surviving_new.sum(dim=-1, dtype=torch.int32)
    return kept, update_pos.to(torch.int32), n_inserted


def select_unchecked(f: Frontier, m_max: int, m=None
                     ) -> Tuple[Frontier, torch.Tensor, torch.Tensor]:
    """Select and mark-checked the first ``m`` unchecked entries (Line 6/12).

    ``m_max`` is the slot count; ``m`` (<= m_max, scalar or per-query over
    the leading dims) masks the dynamic expansion width for staged search.
    Returns ``(frontier', active_ids (..., m_max), active_valid)``;
    inactive slots carry INVALID_ID."""
    if m is None:
        m = m_max
    m = torch.as_tensor(m, dtype=torch.int32, device=f.ids.device)
    m = m.expand(f.ids.shape[:-1])
    unchecked = ~f.checked & (f.ids != INVALID_ID)
    # stable argsort puts unchecked slots first, preserving dist order
    order = torch.sort((~unchecked).to(torch.uint8), dim=-1,
                       stable=True).indices
    sel_pos = order[..., :m_max]
    in_budget = torch.arange(m_max, device=m.device) < m[..., None]
    active_valid = unchecked.gather(-1, sel_pos) & in_budget
    active_ids = torch.where(active_valid, f.ids.gather(-1, sel_pos),
                             INVALID_ID)
    new_checked = f.checked.scatter(
        -1, sel_pos, f.checked.gather(-1, sel_pos) | active_valid)
    return f._replace(checked=new_checked), active_ids, active_valid


def has_unchecked(f: Frontier) -> torch.Tensor:
    """Per-query: is any valid entry still unchecked? (reduces the last
    axis, so a (B, L) frontier gives (B,))."""
    return torch.any(~f.checked & (f.ids != INVALID_ID), dim=-1)


def top_k_stable(f: Frontier, k: int) -> torch.Tensor:
    """First K entries are all checked — Algorithm 1's convergence test."""
    head = Frontier(f.ids[..., :k], f.dists[..., :k], f.checked[..., :k])
    return ~has_unchecked(head)


def results(f: Frontier, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first K (id, dist) pairs — Algorithm 1 Line 14."""
    return f.ids[..., :k], f.dists[..., :k]


# ---------------------------------------------------------------------------
# Multi-queue (walker) operations — Algorithm 3 Lines 7 and 23
# ---------------------------------------------------------------------------

def scatter_round_robin(f: Frontier, num_walkers: int, active=None
                        ) -> Frontier:
    """Divide unchecked candidates among walkers (Line 7): (..., L) ->
    (..., W, L).

    Walker w receives the unchecked entries whose unchecked-rank ≡ w (mod
    ``active``) plus every checked entry (read-only context).  ``active``
    (<= num_walkers, scalar or per-query) is the staged worker count."""
    if active is None:
        active = num_walkers
    active = torch.as_tensor(active, dtype=torch.int32, device=f.ids.device)
    active = active.expand(f.ids.shape[:-1]).clamp(min=1)
    valid = f.ids != INVALID_ID
    unchecked = ~f.checked & valid
    ranks = torch.cumsum(unchecked.to(torch.int32), dim=-1) - 1
    owner = torch.where(unchecked, ranks % active[..., None], -1)
    w = torch.arange(num_walkers, device=f.ids.device)[:, None]
    keep = owner.unsqueeze(-2) == w                        # (..., W, L)
    # checked entries are shared (read-only) context; unchecked entries go
    # to their owner only
    take = keep | (f.checked & valid).unsqueeze(-2)
    ids = torch.where(take, f.ids.unsqueeze(-2), INVALID_ID)
    dists = torch.where(take, f.dists.unsqueeze(-2), INF)
    checked = (~keep).to(torch.int32)
    # re-sort so each local queue is contiguous / ordered
    dists, ids, checked = _sort_by(dists, ids, checked)
    return Frontier(ids=ids, dists=dists,
                    checked=(checked == 1) | (ids == INVALID_ID))


def merge_frontiers(fs: Frontier) -> Tuple[Frontier, torch.Tensor]:
    """Merge stacked walker frontiers (..., W, L) into a global queue
    (..., L) (Line 23), preferring checked entries among duplicate ids.
    Also returns the number of duplicate entries dropped."""
    cap = fs.ids.shape[-1]
    lead = fs.ids.shape[:-2]
    ids = fs.ids.reshape(lead + (-1,))
    dists = fs.dists.reshape(lead + (-1,))
    not_checked = (~fs.checked).to(torch.int32).reshape(lead + (-1,))
    ids, not_checked, dists = _sort_by(ids, not_checked, dists)
    dup = _dup_of_previous(ids)
    n_dups = dup.sum(dim=-1, dtype=torch.int32)
    ids = torch.where(dup, INVALID_ID, ids)
    dists = torch.where(dup, INF, dists)
    dists, ids, not_checked = _sort_by(dists, ids, not_checked)
    out = Frontier(ids=ids[..., :cap], dists=dists[..., :cap],
                   checked=(not_checked[..., :cap] == 0)
                   | (ids[..., :cap] == INVALID_ID))
    return out, n_dups


# the batch-major names of the reference: the ops above already take any
# leading (B,) / (B, W) axes
insert_batch = insert
select_unchecked_batch = select_unchecked
has_unchecked_batch = has_unchecked
results_batch = results
