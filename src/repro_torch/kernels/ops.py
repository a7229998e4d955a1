"""Public dispatch over the gather-distance and co-sort kernels.

Port of ``repro.kernels.ops``: ``l2dist``, and the frontier merge on the
bitonic kernel, ``sort_pairs`` and ``topl_merge``.  As in the reference,
``topl_merge`` is an entry point of its own: the traversal's frontier
(``core.queue.insert``) keeps its two stable sorts.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.queue import INVALID_ID
from repro_torch.kernels import bitonic as _bitonic
from repro_torch.kernels import l2dist as _l2
from repro_torch.kernels import ref as _ref


def l2dist(table: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor,
           impl: str = "rowgather", g: int = 8,
           metric: str = "l2") -> torch.Tensor:
    """Fused gather + distance: (N,d), (B,C), (B,d) -> (B,C) f32.

    ``metric`` "l2" (squared L2) or "ip"/"cosine" (negative inner product;
    cosine callers pre-normalize).  ``g`` is the DMA tile ("dma" only)."""
    kmetric = "ip" if metric in ("ip", "cosine") else metric
    if impl == "ref":
        return _ref.dist_ref(table, ids, queries, metric=kmetric)
    if impl == "rowgather":
        return _l2.l2dist_rowgather(table, ids, queries, metric=kmetric)
    if impl == "dma":
        return _l2.l2dist_dma(table, ids, queries, g=g, metric=kmetric)
    raise ValueError(impl)


def sort_pairs(keys: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-wise (B, n) ascending co-sort by (key, p0, p1); n = 2**k."""
    return _bitonic.sort_pairs(keys.float(), p0.to(torch.int32),
                               p1.to(torch.int32))


def topl_merge(q_dists: torch.Tensor, q_ids: torch.Tensor,
               q_meta: torch.Tensor, c_dists: torch.Tensor,
               c_ids: torch.Tensor):
    """Frontier merge on the bitonic kernel (B-batched, the semantics of
    ``core.queue.insert``).

    Queue (B, L) sorted rows + candidates (B, C) -> top-L (dists, ids, meta)
    and the per-row update position.  L + C is padded to the next power of
    two.  Pass 1 groups by (id, is_new): the high 23 bits of the id ride as
    an exact f32 key, the low 8 bits and is_new in p0, the slot in p1; pass
    2 sorts by (dist, id)."""
    big = float("inf")
    bsz, qlen = q_ids.shape
    c = c_ids.shape[1]
    dev = q_ids.device
    n = 1
    while n < qlen + c:
        n *= 2
    pad = n - (qlen + c)
    i32 = torch.int32

    ids = torch.cat([q_ids.to(i32), c_ids.to(i32),
                     torch.full((bsz, pad), INVALID_ID, dtype=i32,
                                device=dev)], dim=1)
    dists = torch.cat([q_dists.float(), c_dists.float(),
                       torch.full((bsz, pad), big, device=dev)], dim=1)
    is_new = torch.cat([torch.zeros((bsz, qlen), dtype=i32, device=dev),
                        torch.ones((bsz, c), dtype=i32, device=dev),
                        torch.zeros((bsz, pad), dtype=i32, device=dev)],
                       dim=1)
    meta = torch.cat([q_meta.to(i32),
                      torch.zeros((bsz, c + pad), dtype=i32, device=dev)],
                     dim=1)
    # pack (meta, is_new) into one payload so the 3-array kernel suffices
    packed = meta * 2 + is_new

    # pass 1: group by (id, is_new), existing entries before fresh dups
    key_hi = (ids >> 8).float()
    p0 = ((ids & 0xFF) << 1) | (packed & 1)
    positions = torch.arange(n, dtype=i32, device=dev).expand(bsz, n)
    _, _, pos = sort_pairs(key_hi, p0, positions)
    pos = pos.long()
    ids_g = ids.gather(1, pos)
    dists_g = dists.gather(1, pos)
    packed_g = packed.gather(1, pos)
    dup = torch.cat([torch.zeros((bsz, 1), dtype=torch.bool, device=dev),
                     (ids_g[:, 1:] == ids_g[:, :-1])
                     & (ids_g[:, 1:] != INVALID_ID)], dim=1)
    ids_g = torch.where(dup, INVALID_ID, ids_g)
    dists_g = torch.where(dup, big, dists_g)

    # pass 2: by (dist, id)
    d2, i2, pk2 = sort_pairs(dists_g, ids_g, packed_g)
    rank = torch.arange(n, dtype=i32, device=dev)[None, :]
    surv = ((pk2 & 1) == 1) & (i2 != INVALID_ID) & (rank < qlen)
    up = torch.where(surv, rank, qlen).amin(dim=1).to(i32)
    return d2[:, :qlen], i2[:, :qlen], pk2[:, :qlen] >> 1, up
