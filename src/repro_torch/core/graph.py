"""Similarity-graph index structures (port of ``repro.core.graph``).

The index is a *padded* CSR — a dense ``(N, R)`` int32 neighbor table
(padding = sentinel ``N``) — plus the ``(N, d)`` embedding table, both as
tensors on one device.  Neighbor grouping (§4.4) re-labels vertices by
in-degree (or measured access frequency) and adds the flattened
``flat[(n_top, R, d)]`` neighbor embeddings of the ``n_top`` hottest
vertices, so expanding a hot vertex reads one contiguous block.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


class PaddedCSR(NamedTuple):
    """Dense padded adjacency + vectors. ``nbrs[i, j] == n_nodes`` is padding."""
    nbrs: torch.Tensor       # (N, R) int32, padded with N
    vectors: torch.Tensor    # (N, d) float32/bfloat16 feature vectors
    medoid: torch.Tensor     # () int32, default entry point
    n_top: int               # number of top-level (flattened) vertices
    flat: torch.Tensor       # (n_top, R, d) flattened neighbor embeddings
    codes: Optional[torch.Tensor] = None    # (N, d) int8 | bfloat16
    scales: Optional[torch.Tensor] = None   # (N, 1) per-vector | (1, d)

    @property
    def n_nodes(self) -> int:
        return self.nbrs.shape[0]

    @property
    def degree(self) -> int:
        return self.nbrs.shape[1]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.nbrs.device


def _as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=dtype or t.dtype)


def make_padded_csr(
    nbrs,
    vectors,
    medoid: Optional[int] = None,
    n_top: int = 0,
    metric: str = "l2",
    device=None,
) -> PaddedCSR:
    """Build a PaddedCSR from host arrays or tensors; optionally flatten the
    top vertices.  ``nbrs`` entries >= N or < 0 normalize to the sentinel N.
    ``metric`` only affects the default medoid choice when ``medoid`` is
    None.  ``device`` defaults to CUDA (raises when it is absent)."""
    dev = resolve_device(device)
    nbrs = _as_tensor(nbrs, dev, torch.int32)
    n = nbrs.shape[0]
    nbrs = torch.where((nbrs < 0) | (nbrs >= n), n, nbrs).to(torch.int32)
    vectors = _as_tensor(vectors, dev)
    if medoid is None:
        medoid = compute_medoid(vectors, metric=metric)
    return PaddedCSR(
        nbrs=nbrs,
        vectors=vectors,
        medoid=torch.tensor(int(medoid), dtype=torch.int32, device=dev),
        n_top=int(n_top),
        flat=_flatten_top(nbrs, vectors, int(n_top)),
    )


def _flatten_top(nbrs: torch.Tensor, vectors: torch.Tensor,
                 n_top: int) -> torch.Tensor:
    """Materialize neighbor embeddings of the ``n_top`` hottest vertices
    (padding rows are +inf)."""
    r, d = nbrs.shape[1], vectors.shape[1]
    if n_top <= 0:
        return vectors.new_zeros((0, r, d))
    ids = nbrs[:n_top].long()                               # (n_top, R)
    flat = vectors[ids.clamp(max=vectors.shape[0] - 1)]      # (n_top, R, d)
    return torch.where((ids < vectors.shape[0])[..., None], flat,
                       torch.tensor(float("inf"), dtype=vectors.dtype,
                                    device=vectors.device))


def compute_medoid(vectors, metric: str = "l2",
                   alive: Optional[np.ndarray] = None) -> int:
    """Vertex closest to the dataset centroid (NSG's navigating node); for
    "ip" the vertex with the largest inner product against the centroid.

    Host numpy, exactly as the reference computes it (the centroid's
    summation order decides near-ties, so both packages must share it).
    ``alive`` restricts both the centroid and the argmin/argmax."""
    if isinstance(vectors, torch.Tensor):
        vectors = vectors.detach().float().cpu().numpy()
    v = np.asarray(vectors, np.float32)
    if alive is not None:
        alive = np.asarray(alive, bool)
        if not alive.any():
            raise ValueError("compute_medoid: no live vertices")
        centroid = v[alive].mean(axis=0)
        if metric == "ip":
            score = np.where(alive, v @ centroid, -np.inf)
            return int(np.argmax(score))
        d = np.where(alive, np.linalg.norm(v - centroid, axis=1), np.inf)
        return int(np.argmin(d))
    centroid = v.mean(axis=0)
    if metric == "ip":
        return int(np.argmax(v @ centroid))
    d = np.linalg.norm(v - centroid, axis=1)
    return int(np.argmin(d))


# ---------------------------------------------------------------------------
# Device-side neighbor-vector fetch (two-level)
# ---------------------------------------------------------------------------

def gather_neighbor_ids(graph: PaddedCSR,
                        active_ids: torch.Tensor) -> torch.Tensor:
    """(..., M) active vertex ids -> (..., M, R) int32 neighbor ids; invalid
    or sentinel actives yield fully padded rows."""
    n = graph.n_nodes
    nbrs = graph.nbrs[active_ids.long().clamp(max=n - 1)]
    return torch.where((active_ids < n)[..., None], nbrs,
                       n).to(torch.int32)


def fetch_neighbor_vectors(graph: PaddedCSR, active_ids: torch.Tensor,
                           nbr_ids: torch.Tensor) -> torch.Tensor:
    """Fetch (..., M, R, d) neighbor embeddings via the two-level layout.

    Hot vertices (< n_top) read their flattened block; cold vertices gather
    rows from the embedding table.  Padding rows are +inf."""
    n = graph.n_nodes
    gathered = graph.vectors[nbr_ids.long().clamp(max=n - 1)]
    inf = torch.tensor(float("inf"), dtype=gathered.dtype,
                       device=gathered.device)
    gathered = torch.where((nbr_ids < n)[..., None], gathered, inf)
    if graph.n_top == 0:
        return gathered
    hot = active_ids < graph.n_top                           # (..., M)
    flat = graph.flat[active_ids.long().clamp(0, graph.n_top - 1)]
    return torch.where(hot[..., None, None], flat, gathered)


def remap_sentinels(nbrs: torch.Tensor, old_n: int,
                    new_n: int) -> torch.Tensor:
    """Rewrite padding entries when the node count changes (incremental
    add): every out-of-range id (>= old_n or < 0) becomes the new sentinel
    ``new_n``.  Must run BEFORE the neighbor table grows.  Returns a new
    int32 tensor."""
    return torch.where((nbrs < 0) | (nbrs >= old_n), new_n,
                       nbrs).to(torch.int32)


# ---------------------------------------------------------------------------
# Neighbor grouping (§4.4): vertex re-labelling strategies
# ---------------------------------------------------------------------------

def _rank_of(score: torch.Tensor) -> torch.Tensor:
    """old_id -> rank (0 = highest score), ties by old id."""
    order = torch.sort(-score, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    return rank


def indegree_rank(nbrs: torch.Tensor) -> torch.Tensor:
    """Degree-centric ranking: permutation old_id -> rank (0 = hottest)."""
    n = nbrs.shape[0]
    return _rank_of(torch.bincount(nbrs[nbrs < n].long(), minlength=n))


def frequency_rank(nbrs: torch.Tensor, access_counts) -> torch.Tensor:
    """Frequency-centric ranking from measured query-time access counts."""
    return _rank_of(torch.as_tensor(access_counts, device=nbrs.device))


def relabel(nbrs: torch.Tensor, vectors: torch.Tensor, rank: torch.Tensor):
    """Apply a vertex re-labelling: new_id = rank[old_id].  Returns
    (new_nbrs int32, new_vectors, old_from_new int64); ``old_from_new`` maps
    search results back to original ids."""
    n = nbrs.shape[0]
    old_from_new = torch.sort(rank, stable=True).indices
    remap = torch.cat([rank.long(), torch.tensor([n], device=rank.device)])
    safe = torch.where((nbrs >= 0) & (nbrs <= n), nbrs, n).long()
    new_nbrs = remap[safe][old_from_new]
    return new_nbrs.to(torch.int32), vectors[old_from_new], old_from_new


def group_by_indegree(nbrs: torch.Tensor, vectors: torch.Tensor,
                      medoid: Optional[int] = None,
                      top_fraction: float = 0.001):
    """Full degree-centric neighbor-grouping pipeline (paper's default), on
    the tensors' device.  Returns (PaddedCSR with flattened top level,
    old_from_new permutation)."""
    rank = indegree_rank(nbrs)
    new_nbrs, new_vectors, old_from_new = relabel(nbrs, vectors, rank)
    n_top = max(1, int(round(nbrs.shape[0] * top_fraction)))
    if medoid is not None:
        medoid = int(rank[medoid])
    csr = make_padded_csr(new_nbrs, new_vectors, medoid=medoid, n_top=n_top,
                          device=nbrs.device)
    return csr, old_from_new


def top_level_hit_fraction(graph: PaddedCSR,
                           active_ids: torch.Tensor) -> torch.Tensor:
    """Fraction of expansions served by the flattened top level
    (profiling)."""
    valid = active_ids < graph.n_nodes
    hits = (active_ids < graph.n_top) & valid
    return hits.sum() / torch.clamp(valid.sum(), min=1)
