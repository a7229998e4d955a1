"""Pluggable distance-backend registry for the search hot path.

Port of ``repro.kernels.registry``: the seam between the search algorithms
(``core.bfis``, ``core.speedann``) and the distance implementations.  A
``SearchConfig.dist_backend`` string resolves here to a BATCH-MAJOR
``DistFn(graph, active_ids (B,M), nbr_ids (B,M,R), queries (B,d)) ->
(B,M,R)`` — one kernel launch per global step for the whole batch.

Registered backends:

* ``ref``          — plain-torch two-level gather (``core.bfis.dist_l2``);
* ``rowgather``    — ``csrc/rowgather.cu``, one warp per candidate;
* ``dma``          — ``csrc/dma.cu``, runs of a query's rows by bulk async
  copy (C padded to ``dma_group``, as the reference pads it);
* ``dedup_gather`` — ``csrc/dedup.cu``, each distinct row of the step once;
* ``ref_int8``, ``rowgather_int8`` (``csrc/rowgather_int8.cu``), ``ref_bf16``
  — the quantized backends of ``quant.kernels``, on an index built with
  ``IndexSpec(quant=...)``;
* ``dedup_gather_int8`` — ``csrc/dedup_int8.cu``, ``dedup_gather`` over int8
  codes.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels import ops

DistFactory = Callable[..., Callable]

_REGISTRY: Dict[str, DistFactory] = {}


def register_backend(name: str):
    """Decorator: register ``factory(cfg) -> DistFn`` under ``name``."""
    def deco(factory: DistFactory) -> DistFactory:
        _REGISTRY[name] = factory
        return factory
    return deco


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_backend(cfg) -> Callable:
    """``SearchConfig.dist_backend`` -> DistFn (raises on unknown names)."""
    name = getattr(cfg, "dist_backend", "ref") or "ref"
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown dist_backend {name!r}; available: "
            f"{available_backends()}") from None
    return factory(cfg)


def pad_ids_to_tile(ids: torch.Tensor, tile: int,
                    n_nodes: int) -> torch.Tensor:
    """Pad a (..., C) id tensor along its LAST axis to a multiple of
    ``tile`` with the sentinel ``n_nodes``."""
    pad = (-ids.shape[-1]) % tile
    if pad == 0:
        return ids
    return torch.cat([ids, ids.new_full(ids.shape[:-1] + (pad,), n_nodes)],
                     dim=-1)


def make_dist_fn(impl: str = "rowgather", *, metric: str = "l2",
                 dma_group: int = 8) -> Callable:
    """Adapter producing a batch-major DistFn that routes the whole
    batch's (B, M, R) expansion through ONE (B, C) kernel launch (C = M·R,
    padded to the DMA tile for ``impl="dma"``, as the reference does)."""
    if impl == "ref":
        from repro_torch.core.bfis import make_ref_dist_fn
        return make_ref_dist_fn(metric)

    def dist_fn(graph, active_ids, nbr_ids, queries):
        b, m, r = nbr_ids.shape
        flat = nbr_ids.reshape(b, m * r)
        if impl == "dma":
            flat = pad_ids_to_tile(flat, dma_group, graph.n_nodes)
        d = ops.l2dist(graph.vectors, flat.contiguous(),
                       queries.contiguous(), impl=impl, g=dma_group,
                       metric=metric)
        return d[:, :m * r].reshape(b, m, r)
    return dist_fn


def _cfg_metric(cfg) -> str:
    return getattr(cfg, "metric", "l2") or "l2"


@register_backend("ref")
def _ref_backend(cfg):
    from repro_torch.core.bfis import make_ref_dist_fn
    return make_ref_dist_fn(_cfg_metric(cfg))


@register_backend("rowgather")
def _rowgather_backend(cfg):
    return make_dist_fn("rowgather", metric=_cfg_metric(cfg))


@register_backend("dma")
def _dma_backend(cfg):
    return make_dist_fn("dma", metric=_cfg_metric(cfg),
                        dma_group=int(getattr(cfg, "dma_group", 8)))


# the quantized and batch-dedup backends self-register on import
import repro_torch.quant.kernels as _quant_kernels  # noqa: E402,F401
import repro_torch.kernels.dedup as _dedup_kernels  # noqa: E402,F401
