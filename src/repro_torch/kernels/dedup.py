"""Batch-deduplicating gather + distance: the ``dedup_gather`` and
``dedup_gather_int8`` backends.

Port of ``repro.kernels.dedup`` (f32/bf16 tables through ``csrc/dedup.cu``,
int8 codes with per-vector scales through ``csrc/dedup_int8.cu``).  A hot
vertex on several queries' (or walkers') frontiers is gathered ONCE per
step:

  1. **dedup** (plain torch, as in the reference): a stable sort of the
     flattened (B·C,) ids makes equal ids contiguous runs; ids >= N fold
     onto the sentinel N first.
  2. **gather + reduce** (``csrc/dedup.cu``): one block per distinct id
     stages the row in shared memory once and reduces it against exactly
     the lanes of its run, writing ``out[b, c]`` directly.

The per-pair reduction is the one ``rowgather`` (``rowgather_int8``) uses,
so the two kernels agree bit for bit on the card.  For CPU tensors
:func:`dedupdist` returns the plain version (``kernels.ref.dist_ref``) and
:func:`dedupdist_int8` its own (``quant.kernels.int8dist_ref``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.registry import pad_ids_to_tile, register_backend
from repro_torch.quant import kernels as _qk

TILE = 8


def _sorted_runs(ids: torch.Tensor, n_nodes: int):
    """Stable sort of the flattened ids (padding folded onto ``n_nodes``):
    (sorted_ids, order, first-of-run mask, run index per sorted slot)."""
    flat = torch.where(ids < n_nodes, ids, n_nodes).to(torch.int32)
    sorted_ids, order = torch.sort(flat.reshape(-1), stable=True)
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    rank = torch.cumsum(first, dim=0) - 1
    return sorted_ids, order, first, rank


def unique_ids_inverse(ids: torch.Tensor, n_nodes: int, tile: int = TILE
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static-shape sort/unique pass over a (B, C) candidate grid.

    Returns ``uniq`` (T,) int32 — the distinct ids at the front, the rest
    the sentinel, T = B·C rounded up to ``tile``; ``inv`` (B, C) int32 with
    ``uniq[inv[b, c]] == min(ids[b, c], n_nodes)``; ``n_uniq`` () int32,
    the number of real (non-sentinel) distinct ids."""
    bsz, c = ids.shape
    t = bsz * c
    sorted_ids, order, first, rank = _sorted_runs(ids, n_nodes)
    uniq = torch.full((t,), n_nodes, dtype=torch.int32, device=ids.device)
    uniq.scatter_(0, rank, sorted_ids)
    inv = torch.zeros((t,), dtype=torch.int32, device=ids.device)
    inv.scatter_(0, order, rank.to(torch.int32))
    n_uniq = (first & (sorted_ids < n_nodes)).sum(dtype=torch.int32)
    return pad_ids_to_tile(uniq, tile, n_nodes), inv.reshape(bsz, c), n_uniq


def dedupdist(table: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor,
              *, metric: str = "l2") -> torch.Tensor:
    """(N,d) table, (B,C) ids, (B,d) queries -> (B,C) f32 distances with
    each distinct candidate row gathered once for the whole batch.  Same
    contract as ``l2dist_rowgather`` and bit-identical to it."""
    _cuda.check_inputs("dedupdist", table, ids, queries)
    if metric not in ("l2", "ip", "cosine"):
        raise ValueError(f"unknown metric {metric!r}")
    if table.device.type == "cpu":
        return _ref.dist_ref(table, ids, queries, metric)
    out = torch.empty(ids.shape, dtype=torch.float32, device=table.device)
    if ids.numel():
        dedup_launch(table, dedup_plan(ids, table.shape[0]), queries, out,
                     metric)
    return out


def dedup_plan(ids: torch.Tensor, n_nodes: int):
    """The kernel's inputs from a (B, C) id grid: (sorted_ids, run_start,
    order) as int32 tensors, plus C.  ``run_start[u]`` is the first sorted
    slot of the u-th distinct id; slots past the last distinct id (and
    ``run_start[B·C]``) hold B·C, i.e. empty runs."""
    t = ids.numel()
    sorted_ids, order, _, rank = _sorted_runs(ids, n_nodes)
    run_start = torch.full((t + 1,), t, dtype=torch.int32, device=ids.device)
    run_start.scatter_reduce_(
        0, rank, torch.arange(t, dtype=torch.int32, device=ids.device),
        reduce="amin")
    return sorted_ids, run_start, order.to(torch.int32), ids.shape[1]


def dedup_launch(table: torch.Tensor, plan, queries: torch.Tensor,
                 out: torch.Tensor, metric: str) -> None:
    """Launch ``csrc/dedup.cu`` on a :func:`dedup_plan` into ``out``."""
    sorted_ids, run_start, order, c = plan
    _cuda.launch("dedup", "dedupdist",
                 table, int(table.dtype == torch.bfloat16), table.shape[0],
                 table.shape[1], sorted_ids, run_start, order,
                 sorted_ids.numel(), c, queries, out, int(metric != "l2"),
                 _cuda.vec_ok(table, queries))


def dedupdist_int8(codes: torch.Tensor, scales: torch.Tensor,
                   ids: torch.Tensor, queries: torch.Tensor, *,
                   metric: str = "l2") -> torch.Tensor:
    """int8 variant of :func:`dedupdist`: (N, d) int8 codes with (N, 1)
    per-vector scales; the distinct code rows of the batch are gathered once.
    Same contract as ``quant.kernels.int8dist_rowgather`` and bit-identical
    to it and to ``ref_int8``."""
    _qk._check_per_vector("dedupdist_int8", codes, scales)
    _cuda.check_int8_inputs("dedupdist_int8", codes, scales, ids, queries)
    kmetric = _qk._kmetric(metric)
    if codes.device.type == "cpu":
        return _qk.int8dist_ref(codes, scales, ids, queries, metric)
    out = torch.empty(ids.shape, dtype=torch.float32, device=codes.device)
    if ids.numel():
        dedup_int8_launch(codes, scales, dedup_plan(ids, codes.shape[0]),
                          _qk.query_meta(queries), out, kmetric)
    return out


def dedup_int8_launch(codes: torch.Tensor, scales: torch.Tensor, plan,
                      qmeta, out: torch.Tensor, metric: str) -> None:
    """Launch ``csrc/dedup_int8.cu`` on a :func:`dedup_plan` and a
    ``query_meta`` into ``out``."""
    sorted_ids, run_start, order, c = plan
    qc, qs, q2 = qmeta
    _cuda.launch("dedup_int8", "dedupdist_int8",
                 codes, codes.shape[0], codes.shape[1], scales, sorted_ids,
                 run_start, order, sorted_ids.numel(), c, qc, qs, q2, out,
                 int(metric != "l2"), _cuda.int8_vec_ok(codes, qc))


def make_dedup_dist_fn(metric: str = "l2"):
    """Batch-major dedup DistFn: the step's whole (B, M·R) candidate grid
    in ONE unique-row gather launch."""
    def dist_fn(graph, active_ids, nbr_ids, queries):
        b, m, r = nbr_ids.shape
        d = dedupdist(graph.vectors, nbr_ids.reshape(b, m * r),
                      queries.contiguous(), metric=metric)
        return d.reshape(b, m, r)
    return dist_fn


def make_dedup_int8_dist_fn(metric: str = "l2"):
    """Batch-major int8 dedup DistFn: the step's distinct code rows in ONE
    launch.  Per-vector scales only, like ``rowgather_int8``."""
    def dist_fn(graph, active_ids, nbr_ids, queries):
        codes, scales = _qk.require_codes(graph, "int8")
        if scales.shape[0] == 1:
            raise NotImplementedError(
                "dedup_gather_int8 implements the per-vector-scale integer "
                "path; per-dimension scales are served by 'ref_int8'")
        b, m, r = nbr_ids.shape
        d = dedupdist_int8(codes, scales,
                           nbr_ids.reshape(b, m * r).contiguous(),
                           queries.contiguous(), metric=metric)
        return d.reshape(b, m, r)
    return dist_fn


@register_backend("dedup_gather")
def _dedup_backend(cfg):
    return make_dedup_dist_fn(getattr(cfg, "metric", "l2") or "l2")


@register_backend("dedup_gather_int8")
def _dedup_int8_backend(cfg):
    return make_dedup_int8_dist_fn(getattr(cfg, "metric", "l2") or "l2")
