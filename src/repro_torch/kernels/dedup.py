"""Batch-deduplicating gather + distance: the ``dedup_gather`` and
``dedup_gather_int8`` backends.

Port of ``repro.kernels.dedup`` (f32/bf16 tables through ``csrc/dedup.cu``,
int8 codes with per-vector scales through ``csrc/dedup_int8.cu``).  A vertex
on several walkers' (or queries') frontiers is gathered once per tile of
lanes: each call is ONE launch on the (B, C) ids as they are.  A block takes
:func:`tile_lanes` consecutive flat lanes, dedups their ids in a shared-memory
hash table, stages each distinct row once and reduces every lane against it
(``csrc/dedup_tile.cuh``); duplicates across tiles meet in the L2.

The per-pair reduction is the one ``rowgather`` uses (and for int8 the
exact integer sums and the epilogue of ``rowgather_int8``), so the two
kernels agree bit for bit on the card.  For CPU tensors
:func:`dedupdist` returns the plain version (``kernels.ref.dist_ref``) and
:func:`dedupdist_int8` its own (``quant.kernels.int8dist_ref``).
:func:`unique_ids_inverse` is the port of the reference's sort/unique pass;
no kernel path uses it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.registry import pad_ids_to_tile, register_backend
from repro_torch.launch import op_profile
from repro_torch.quant import kernels as _qk

TILE = 8                      # unique_ids_inverse's sentinel padding
# lanes per block, at most (kMaxTile in csrc/dedup_tile.cuh): at the speedann
# (512 x 32) step on an H100, 32-lane tiles ran faster than 64- or 128-lane
# ones (more blocks in flight; PERF.md) though they stage ~10% more rows
TILE_LANES = 32
# dynamic shared memory a block may take so that two fit on one SM (228 KB
# each), and the most one block may take beside its static table
SMEM_BUDGET = 96 * 1024
SMEM_MAX = 227 * 1024 - 4 * 1024


def unique_ids_inverse(ids: torch.Tensor, n_nodes: int, tile: int = TILE
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static-shape sort/unique pass over a (B, C) candidate grid.

    Returns ``uniq`` (T,) int32 — the distinct ids at the front, the rest
    the sentinel, T = B·C rounded up to ``tile``; ``inv`` (B, C) int32 with
    ``uniq[inv[b, c]] == min(ids[b, c], n_nodes)``; ``n_uniq`` () int32,
    the number of real (non-sentinel) distinct ids."""
    bsz, c = ids.shape
    t = bsz * c
    flat = torch.where(ids < n_nodes, ids, n_nodes).to(torch.int32)
    sorted_ids, order = torch.sort(flat.reshape(-1), stable=True)
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    rank = torch.cumsum(first, dim=0) - 1
    uniq = torch.full((t,), n_nodes, dtype=torch.int32, device=ids.device)
    uniq.scatter_(0, rank, sorted_ids)
    inv = torch.zeros((t,), dtype=torch.int32, device=ids.device)
    inv.scatter_(0, order, rank.to(torch.int32))
    n_uniq = (first & (sorted_ids < n_nodes)).sum(dtype=torch.int32)
    return pad_ids_to_tile(uniq, tile, n_nodes), inv.reshape(bsz, c), n_uniq


def tile_lanes(d: int, row_bytes: int, b: int, c: int) -> int:
    """Lanes per block for a (B, C) grid over rows of ``row_bytes``: the
    largest power of two up to :data:`TILE_LANES` whose distinct rows and
    query rows (at most 4·d + 8 bytes each) fit :data:`SMEM_BUDGET`; 1 when
    none does.  Raises ``ValueError`` when one lane's row and query do not
    fit a block."""
    def smem(tile):
        nq = min(b, (tile + c - 2) // c + 1)
        return nq * (4 * d + 8) + tile * (row_bytes + 4) + 16
    if smem(1) > SMEM_MAX:
        raise ValueError(f"dedup kernels: d = {d} leaves no room for one row "
                         f"and its query in a block's shared memory")
    tile = 1
    while tile * 2 <= TILE_LANES and smem(tile * 2) <= SMEM_BUDGET:
        tile *= 2
    return tile


def dedupdist(table: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor,
              *, metric: str = "l2") -> torch.Tensor:
    """(N,d) table, (B,C) ids, (B,d) queries -> (B,C) f32 distances with
    each distinct candidate row of a tile of :func:`tile_lanes` lanes
    gathered once.  Same contract as
    ``l2dist_rowgather`` and bit-identical to it."""
    _cuda.check_inputs("dedupdist", table, ids, queries)
    if metric not in ("l2", "ip", "cosine"):
        raise ValueError(f"unknown metric {metric!r}")
    n, d = table.shape
    tile = tile_lanes(d, d * table.element_size(), *ids.shape)
    if table.device.type == "cpu":
        return _ref.dist_ref(table, ids, queries, metric)
    out = torch.empty(ids.shape, dtype=torch.float32, device=table.device)
    if out.numel():
        if op_profile.ACTIVE is not None:
            op_profile.report_gather("dedupdist", table, ids, queries, out,
                                     3 - int(metric != "l2"), "f32")
        if _cuda.traced(out):
            return out
        _cuda.launch("dedup", "dedupdist", table,
                     int(table.dtype == torch.bfloat16), n, d, ids,
                     ids.shape[0], ids.shape[1], tile, queries, out,
                     int(metric != "l2"), _cuda.vec_ok(table, queries))
    return out


def dedupdist_int8(codes: torch.Tensor, scales: torch.Tensor,
                   ids: torch.Tensor, queries: torch.Tensor, *,
                   metric: str = "l2", qmeta=None) -> torch.Tensor:
    """int8 variant of :func:`dedupdist`: (N, d) int8 codes with (N, 1)
    per-vector scales; the distinct code rows of a tile are gathered once.
    ``qmeta`` is ``quant.kernels.query_meta(queries)`` when the caller has
    it (computed here otherwise).  Same contract as
    ``quant.kernels.int8dist_rowgather`` and bit-identical to it and to
    ``ref_int8``."""
    _qk._check_per_vector("dedupdist_int8", codes, scales)
    _cuda.check_int8_inputs("dedupdist_int8", codes, scales, ids, queries)
    kmetric = _qk._kmetric(metric)
    n, d = codes.shape
    tile = tile_lanes(d, d, *ids.shape)
    if codes.device.type == "cpu":
        return _qk.int8dist_ref(codes, scales, ids, queries, metric,
                                qmeta=qmeta)
    qc, qs, q2 = _qk.query_side(queries, qmeta)
    out = torch.empty(ids.shape, dtype=torch.float32, device=codes.device)
    if out.numel():
        if op_profile.ACTIVE is not None:
            op_profile.report_gather("dedupdist_int8", codes, ids, queries,
                                     out, 4, "int8", pair_bytes=4)
        if _cuda.traced(out):
            return out
        _cuda.launch("dedup_int8", "dedupdist_int8", codes, n, d, scales,
                     ids, ids.shape[0], ids.shape[1], tile, qc, qs, q2, out,
                     int(kmetric == "ip"), _cuda.int8_vec_ok(codes, qc))
    return out


def make_dedup_dist_fn(metric: str = "l2"):
    """Batch-major dedup DistFn: the step's whole (B, M·R) candidate grid
    in ONE launch."""
    def dist_fn(graph, active_ids, nbr_ids, queries):
        b, m, r = nbr_ids.shape
        d = dedupdist(graph.vectors, nbr_ids.reshape(b, m * r),
                      queries.contiguous(), metric=metric)
        return d.reshape(b, m, r)
    return dist_fn


def make_dedup_int8_dist_fn(metric: str = "l2"):
    """Batch-major int8 dedup DistFn: the step's grid in ONE launch, with
    the query side computed once per queries tensor (a search hands the
    same tensor to every step that shares it).  Per-vector scales only,
    like ``rowgather_int8``."""
    qmeta = _qk.QueryMetaMemo()

    def dist_fn(graph, active_ids, nbr_ids, queries):
        codes, scales = _qk.require_codes(graph, "int8")
        if scales.shape[0] == 1:
            raise NotImplementedError(
                "dedup_gather_int8 implements the per-vector-scale integer "
                "path; per-dimension scales are served by 'ref_int8'")
        b, m, r = nbr_ids.shape
        d = dedupdist_int8(codes, scales,
                           nbr_ids.reshape(b, m * r).contiguous(),
                           queries.contiguous(), metric=metric,
                           qmeta=qmeta(queries))
        return d.reshape(b, m, r)
    return dist_fn


@register_backend("dedup_gather")
def _dedup_backend(cfg):
    return make_dedup_dist_fn(getattr(cfg, "metric", "l2") or "l2")


@register_backend("dedup_gather_int8")
def _dedup_int8_backend(cfg):
    return make_dedup_int8_dist_fn(getattr(cfg, "metric", "l2") or "l2")
