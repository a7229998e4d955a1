"""Visited-set structures (§4.4, port of ``repro.core.visited``).

Three modes, all with the paper's correctness model: a false-negative
lookup merely causes a duplicate distance computation (benign — the queue
merge dedups); a false *positive* is never produced.

* ``bitmap`` — exact dense boolean map over the N vertices, per lane.
* ``hash``   — fixed 2**bits open-addressed set with bounded linear probing.
* ``loose``  — no structure; dedup only within a batch of candidates.

Every table carries leading lane axes ``(B, ...)`` or ``(B, W, ...)``.

**In place.**  Unlike the reference (functional JAX arrays), the port
updates tables IN PLACE: :func:`check_and_insert_batch` writes only the
lanes of ``write_mask``, so a lane the caller will discard (converged or
out of budget) is never written and the engine needs no copy-and-select of
the (B, W, N) bitmap per step (512 MB at 64 queries × 8 walkers × 1M
vertices).  The results of the lanes that are written are exactly the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_EMPTY = -1
_PROBES = 8


@dataclasses.dataclass
class Visited:
    table: torch.Tensor  # bitmap: (..., N) bool | hash: (..., 2**bits) int32
    mode_bitmap: bool
    mask: int            # hash: 2**bits - 1; loose: 0

    def _replace(self, **kw) -> "Visited":
        return dataclasses.replace(self, **kw)


def make_visited(mode: str, n_nodes: int, hash_bits: int = 14,
                 device=None) -> Visited:
    return make_visited_batch(mode, n_nodes, (), hash_bits, device)


def make_visited_batch(mode: str, n_nodes: int, batch, hash_bits: int = 14,
                       device=None) -> Visited:
    """A stacked visited map with leading ``batch`` axes (an int or a
    tuple such as ``(B, W)``)."""
    lead = tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)
    if mode == "bitmap":
        return Visited(torch.zeros(lead + (n_nodes,), dtype=torch.bool,
                                   device=device), True, 0)
    if mode == "hash":
        size = 1 << hash_bits
        return Visited(torch.full(lead + (size,), _EMPTY, dtype=torch.int32,
                                  device=device), False, size - 1)
    if mode == "loose":
        return Visited(torch.full(lead + (1,), _EMPTY, dtype=torch.int32,
                                  device=device), False, 0)
    raise ValueError(f"unknown visited mode {mode!r}")


def _hash(ids: torch.Tensor, mask: int) -> torch.Tensor:
    """Knuth multiplicative hash; the reference's uint32 wrap-around is
    emulated in int64 with a 32-bit mask."""
    u = ids.to(torch.int64) & 0xFFFFFFFF
    h = ((u * 2654435761) & 0xFFFFFFFF) >> 16
    return ((h ^ u) & mask).to(torch.int64)


def _first_occurrence(ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mask keeping only the first occurrence of each id among valid slots
    of every row ((..., n) -> (..., n) via an (n, n) mask per row)."""
    n = ids.shape[-1]
    eq = ids.unsqueeze(-2) == ids.unsqueeze(-1)           # [i, j]: id_i == id_j
    earlier = torch.ones((n, n), dtype=torch.bool,
                         device=ids.device).tril(-1)       # j < i
    dup_of_earlier = torch.any(eq & earlier & valid.unsqueeze(-2), dim=-1)
    return valid & ~dup_of_earlier


def check_and_insert_batch(v: Visited, ids: torch.Tensor, valid: torch.Tensor,
                           write_mask: Optional[torch.Tensor] = None
                           ) -> Tuple[Visited, torch.Tensor]:
    """Batch test-and-set over (B, X) tables and (B, C) ids.  Returns
    (visited, fresh_mask); ``fresh[b, i]`` is True when ids[b, i] was valid
    and not previously marked.  The table is updated in place, for the
    lanes of ``write_mask`` (B,) only (all lanes when None)."""
    writable = valid if write_mask is None else valid & write_mask[:, None]
    if v.mode_bitmap:
        n = v.table.shape[-1]
        safe = ids.to(torch.int64).clamp(0, n - 1)
        already = v.table.gather(-1, safe) & valid
        fresh = valid & ~already
        # in-batch duplicates: keep first occurrence only (exact dedup)
        fresh = fresh & _first_occurrence(ids, fresh)
        # scatter-max (commutative OR): duplicate indices in the batch can
        # never erase a True write
        v.table.view(torch.uint8).scatter_reduce_(
            -1, safe, (fresh & writable).to(torch.uint8), reduce="amax")
        return v, fresh

    if v.mask == 0:  # loose mode: no memory; only in-batch dedup
        return v, valid & _first_occurrence(ids, valid)

    # hash mode: bounded linear probing.  The reference scatters one write
    # per lane (a claim of an empty slot; slot 0's own value back from a
    # lane that claims nothing) and the last lane of a row wins.  The port
    # writes the winning claims only, so its tables are the reference's and
    # do not depend on a scatter's order: a claim is lost when a later lane
    # of its row writes the same slot.  The loser reads back a different
    # key and probes on — benign.
    table = v.table
    ids32 = ids.to(torch.int32)
    found = torch.zeros_like(valid)
    inserted = torch.zeros_like(valid)
    slot = _hash(ids, v.mask)
    rows = torch.arange(table.shape[0], device=ids.device)[:, None]
    rows = rows.expand_as(slot)
    c = ids.shape[-1]
    later = torch.ones((c, c), dtype=torch.bool,
                       device=ids.device).triu(1)          # [i, j]: j > i
    for _ in range(_PROBES):
        cur = table.gather(-1, slot)
        # a lane that already claimed its slot must not read its own insert
        # back as a pre-existing hit
        hit = (cur == ids32) & valid & ~inserted
        empty = (cur == _EMPTY) & writable & ~found & ~inserted
        target = torch.where(empty, slot, 0)
        overwritten = torch.any(
            (target.unsqueeze(-1) == target.unsqueeze(-2)) & later, dim=-1)
        won = empty & ~overwritten
        table[rows[won], slot[won]] = ids32[won]
        claimed = empty & (table.gather(-1, slot) == ids32)
        inserted = inserted | claimed
        found = found | hit
        done = found | inserted
        slot = torch.where(done, slot, (slot + 1) & v.mask)
    # ids that neither hit nor found a slot are treated as fresh (duplicate
    # compute possible — benign)
    fresh = valid & ~found
    return v, fresh & _first_occurrence(ids, fresh)


def check_and_insert(v: Visited, ids: torch.Tensor, valid: torch.Tensor
                     ) -> Tuple[Visited, torch.Tensor]:
    """Single-query form: a (X,) table and (C,) ids (in place)."""
    vb = v._replace(table=v.table.unsqueeze(0))
    _, fresh = check_and_insert_batch(vb, ids[None], valid[None])
    return v, fresh[0]


def popcount(v: Visited) -> torch.Tensor:
    """Per query, the number of marked vertices in walker 0's table of a
    (B, W, X) walker-stacked map — the reference's ``vmap(popcount)``.

    On an OR-merged map this is the exact union size (bitmap) or table
    occupancy (hash); loose mode counts 0."""
    t0 = v.table[:, 0]
    if v.mode_bitmap:
        return t0.sum(dim=-1, dtype=torch.int32)
    if v.mask == 0:
        return torch.zeros(t0.shape[0], dtype=torch.int32,
                           device=t0.device)
    return (t0 != _EMPTY).sum(dim=-1, dtype=torch.int32)


def merge_visited(vs: Visited, walkers=None) -> Visited:
    """OR-merge the walker maps of a (B, W, X) stacked map at a global sync,
    in place.  Bitmap: exact OR.  Hash: walker 0's table, with empty slots
    filled from walkers 1.. in order (losses are benign).  Loose: no-op.

    ``walkers`` (a ``ranks.RankAxis``) spreads the walker axis over ranks,
    each holding W / r walkers as lanes: the lanes are reduced first, then
    the bitmap is a uint8 max over the ranks, and the hash tables are
    gathered and folded in rank order ("first non-empty wins" is
    associative, so this is the fold over walkers 0..W-1)."""
    if vs.mode_bitmap:
        merged = vs.table.any(dim=1)
        if walkers is not None:
            merged = walkers.all_reduce(merged.view(torch.uint8),
                                        "max").view(torch.bool)
        vs.table.copy_(merged[:, None].expand_as(vs.table))
        return vs
    if vs.mask == 0:
        return vs
    merged = _fold(vs.table)
    if walkers is not None:
        merged = _fold(walkers.gather(merged[:, None], 1))
    vs.table.copy_(merged[:, None].expand_as(vs.table))
    return vs


def _fold(tables: torch.Tensor) -> torch.Tensor:
    """(B, W, X) hash tables -> (B, X): table 0 with its empty slots filled
    from tables 1.. in order."""
    merged = tables[:, 0].clone()
    for w in range(1, tables.shape[1]):
        t = tables[:, w]
        merged = torch.where((merged == _EMPTY) & (t != _EMPTY), t, merged)
    return merged
