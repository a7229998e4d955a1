"""Public dispatch over the gather-distance kernels.

Port of ``repro.kernels.ops.l2dist`` (``sort_pairs``/``topl_merge`` wait
for the bitonic kernel).
"""
from __future__ import annotations

import torch

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
