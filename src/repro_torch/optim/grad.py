"""Gradient utilities: global-norm clipping and int8 compression with error
feedback (port of ``repro.optim.grad``).

``compressed_psum`` is the reference's all-reduce over a ``data`` mesh
axis.  Every leaf carries a leading lane axis, one row per position of
the axis on this device; over ranks (``axis``, a ``ranks.RankAxis``) the
lanes are reduced first and then the ranks: the scale by a float max, the
payload by an int32 sum, both exact in any order.  The int8 payload, its
common scale and each lane's residual are the reference's.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.sharding import is_dtensor, replicas
from repro_torch.treepath import tree_leaves, tree_map, tree_unzip


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, leaf sums
    added in the reference's leaf order.  Over ranks (DTensor leaves on a
    mesh of more than one rank) each rank adds its own blocks' sums, a
    replicated block's over its count of holders (a power of two: exact),
    and one all-reduce adds the ranks' partial sums, as the reference's
    norm over sharded leaves is one all-reduce."""
    leaves = tree_leaves(tree)
    if leaves and is_dtensor(leaves[0]) and leaves[0].device_mesh.size() > 1:
        return _global_norm_over_ranks(leaves)
    leaves = [torch.sum(torch.square(x.float())) for x in leaves]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _global_norm_over_ranks(leaves) -> torch.Tensor:
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate
    part = torch.sum(torch.stack([
        torch.sum(torch.square(x.to_local().float())) / replicas(x)
        for x in leaves]))
    # a mesh over ranks spans the whole group (make_search_mesh)
    total = funcol.wait_tensor(funcol.all_reduce(part, "sum",
                                                 dist.group.WORLD))
    mesh = leaves[0].device_mesh
    return DTensor.from_local(torch.sqrt(total), mesh,
                              (Replicate(),) * mesh.ndim, run_check=False)


def clip_by_global_norm(tree, max_norm: float, inplace: bool = False):
    """(``tree`` scaled so its global norm is at most ``max_norm``, the
    norm before).  ``inplace`` writes the scaled leaves into ``tree``'s
    own tensors (a caller that owns them) and returns ``tree``."""
    n = global_norm(tree)
    # a tensor numerator: Python-scalar / tensor is a reciprocal product
    scale = torch.clamp(n.new_full((), max_norm) / torch.clamp(n, min=1e-6),
                        max=1.0)

    def one(g):
        out = (g.float() * scale).to(g.dtype)
        return g.copy_(out) if inplace else out
    return tree_map(one, tree), n


def _int8(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def int8_compress(tree) -> Tuple:
    """Per-leaf symmetric int8 quantization. Returns (q_tree, scales)."""
    def scale(g):
        return torch.clamp(g.float().abs().max(), min=1e-12) / 127.0
    scales = tree_map(scale, tree)
    return tree_map(lambda g, s: _int8(g.float(), s), tree, scales), scales


def int8_decompress(q_tree, scales):
    return tree_map(lambda q, s: q.float() * s, q_tree, scales)


def compressed_psum(grads, error=None, axis=None):
    """int8-quantized all-reduce over lanes (and ``axis``'s ranks), with
    error feedback.

    Every leaf of ``grads`` is (n, ...): one row per position of the
    ``data`` axis on this rank.  ``error`` (optional) holds each lane's
    residual from the last step, (n, ...) or broadcast from one (...)
    residual.  All lanes of all ranks share one per-leaf scale (the
    reference's scalar ``pmax``), quantize their residual-corrected grads
    against it, and the int8 payloads are summed in int32 and dequantized.
    Returns (the mean grads, (...) per leaf; each of this rank's lanes'
    new residual, (n, ...))."""
    if error is not None:
        grads = tree_map(lambda g, e: g.float() + e, grads, error)
    grads = tree_map(lambda g: g.float(), grads)
    ranks = 1 if axis is None else axis.size

    def one(g):
        n = g.shape[0]
        per_lane = torch.clamp(g.abs().reshape(n, -1).amax(dim=1), min=1e-12)
        top = per_lane.max()
        if axis is not None:
            top = axis.all_reduce(top, "max")
        scale = top / 127.0
        q = _int8(g, scale)
        total = q.to(torch.int32).sum(dim=0)
        if axis is not None:
            total = axis.all_reduce(total, "sum")
        mean = total.float() * scale / (n * ranks)
        return mean, g - q.float() * scale
    return tree_unzip(one, 2, grads)
