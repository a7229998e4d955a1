"""Similarity-graph index construction (port of ``repro.core.build``).

Exact kNN, the α-prune, the NSG builder by prefix-doubling batch insertion,
live updates (:func:`insert_points`, :func:`repair_deleted`) and the
simplified HNSW builder, on tensors on one device.  The reference runs its
rounds on host numpy around device candidate searches; here the whole round
stays on the device:

* points are inserted in prefix-doubling rounds (1, 1, 2, 4, 8, ...); every
  point of a round searches the SAME frozen adjacency ``nbrs`` through the
  batch-major engine (``search_topm_batch_visited`` with the (B, N) bitmap,
  any registered distance backend), ``build_batch`` queries at a time;
* each chunk's candidate pool is canonicalized (ascending unique ids) and
  α-pruned by :func:`robust_prune_batch` right after its search; the pruned
  rows are written once every search of the round has run;
* the reverse pass (:func:`_apply_reverse`) runs as one vectorized pass over
  the round's (target, source) pairs, with the reference's lowest-id-first
  rule.

``nbrs`` lives on the device for the whole build and reaches the host once,
in the returned graph.  ``build_batch`` and the prune tiles are compute
tiles only: the graph is the same for every size, and on integer data it
equals ``repro``'s bit for bit.  ``serial=True`` keeps the reference's
scalar prune and per-target reverse loop: the oracle the tests hold the
vectorized paths against (CPU only).

Exact kNN orders exact distance ties by id, lowest first, both inside the
k and at the k-th boundary, as ``lax.top_k`` does.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.config import SearchConfig
from repro_torch.core.graph import PaddedCSR, compute_medoid, make_padded_csr
from repro_torch.device import resolve_device


def _tensor(x, device=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.asarray(x, np.float32))
    return t if device is None else t.to(device)


def _ids(x, device) -> torch.Tensor:
    """Ids (array, list or tensor) as an int64 tensor on ``device``."""
    t = x if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.asarray(x, np.int64))
    return t.to(device=device, dtype=torch.int64)


# ---------------------------------------------------------------------------
# Exact kNN (blocked brute force) — ground truth + upper-level seeds
# ---------------------------------------------------------------------------

def normalize_rows(x) -> torch.Tensor:
    """Unit-normalize rows (cosine = inner product on normalized vectors)."""
    x = _tensor(x).float()
    return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True),
                           min=1e-12)


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` at full float32 precision: on the card a process may allow
    TF32 products, which would move distances, hence kNN ids and the hnsw
    upper levels, off the CPU's and the reference's.  Only the cuBLAS flag
    is touched, and given back."""
    flags = torch.backends.cuda.matmul
    if not a.is_cuda or not flags.allow_tf32:
        return a @ b
    flags.allow_tf32 = False
    try:
        return a @ b
    finally:
        flags.allow_tf32 = True


def _dist_block(q: torch.Tensor, x: torch.Tensor, x2: torch.Tensor,
                metric: str) -> torch.Tensor:
    """(b, N) distances between a query block and the data; smaller =
    closer ("ip" = negative inner product)."""
    if metric == "ip":
        return -_matmul_f32(q, x.T)
    q2 = torch.sum(q * q, dim=1, keepdim=True)
    return q2 + x2[None, :] - 2.0 * _matmul_f32(q, x.T)


def _smallest_k(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of each row of ``d``, ordered by (value, id):
    exact ties go to the lowest id, inside the k and at its boundary.

    ``topk(k + 1)`` finds each row's k-th and (k+1)-th values; where they
    differ the k smallest are one set and only their order needs the
    (value, id) sort.  Rows where they tie are re-selected by a stable sort
    of the whole row."""
    n = d.shape[1]
    if k >= n:
        top_d, top_i = torch.sort(d, dim=1, stable=True)
        return top_d[:, :k], top_i[:, :k]
    top_d, top_i = torch.topk(d, k + 1, dim=1, largest=False, sorted=True)
    tied = top_d[:, k] == top_d[:, k - 1]
    top_d, top_i = top_d[:, :k], top_i[:, :k]
    order = torch.sort(top_i, dim=1).indices
    top_d, top_i = top_d.gather(1, order), top_i.gather(1, order)
    order = torch.sort(top_d, dim=1, stable=True).indices
    top_d, top_i = top_d.gather(1, order), top_i.gather(1, order)
    rows = torch.nonzero(tied).flatten()
    if rows.numel():
        rd, ri = torch.sort(d[rows], dim=1, stable=True)
        top_d[rows], top_i[rows] = rd[:, :k], ri[:, :k]
    return top_d, top_i


def exact_knn(data, queries, k: int, block: int = 2048,
              metric: str = "l2") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest neighbors of ``queries`` within ``data`` (tensors or
    arrays; the work runs on ``data``'s device).

    ``metric`` is "l2" (squared L2), "ip" (negative inner product), or
    "cosine" (ip after normalizing BOTH sides here).  Returns (ids (Q, k)
    int32, dists (Q, k) float32) sorted ascending, exact ties by id, on
    ``data``'s device."""
    x = _tensor(data).float()
    q_all = _tensor(queries).float().to(x.device)
    if metric == "cosine":
        x, q_all = normalize_rows(x), normalize_rows(q_all)
        metric = "ip"
    x2 = torch.sum(x * x, dim=1)
    out_ids, out_d = [], []
    for s in range(0, q_all.shape[0], block):
        d = _dist_block(q_all[s:s + block], x, x2, metric)
        top_d, top_i = _smallest_k(d, k)
        out_ids.append(top_i.to(torch.int32))
        out_d.append(top_d)
        del d
    return torch.cat(out_ids), torch.cat(out_d)


def knn_graph(data, k: int, block: int = 2048,
              metric: str = "l2") -> torch.Tensor:
    """(N, k) int32 kNN graph excluding self-edges, padded with the
    sentinel N (on ``data``'s device).  A stable sort on the self-edge mask
    compacts each row's non-self entries to the front, preserving distance
    order; slots past the row's valid count become the sentinel."""
    ids, _ = exact_knn(data, data, k + 1, block, metric=metric)
    n = ids.shape[0]
    self_id = torch.arange(n, dtype=torch.int32, device=ids.device)[:, None]
    valid = ids != self_id                                   # (N, k+1)
    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True).indices
    rows = ids.gather(1, order)[:, :k]
    cnt = valid.sum(dim=1).clamp(max=k)
    slot = torch.arange(k, device=ids.device)[None, :]
    return torch.where(slot < cnt[:, None], rows, n).to(torch.int32)


# ---------------------------------------------------------------------------
# α-prune: scalar reference + vectorized batch form
# ---------------------------------------------------------------------------

def prune_dists(vecs: torch.Tensor, point: torch.Tensor,
                metric: str) -> torch.Tensor:
    """Candidate-to-point distances on the builder's pruning scale.

    ``vecs`` is (..., C, d), ``point`` broadcasts as (..., d); returns
    (..., C).  Actual L2 for "l2" (NOT squared), ``sqrt(max(Σ(x−p)², 0))``
    on the difference form as the reference computes it; negative inner
    product for "ip"."""
    if metric == "ip":
        return -torch.sum(vecs * point[..., None, :], dim=-1)
    diff = vecs - point[..., None, :]
    return torch.sqrt(torch.clamp(torch.sum(diff.mul_(diff), dim=-1),
                                  min=0.0))


def _prune_dists(data: torch.Tensor, ids: torch.Tensor, point: torch.Tensor,
                 metric: str) -> torch.Tensor:
    """Distances of data[ids] to ``point`` (scalar-path convenience)."""
    return prune_dists(data[ids.long()], point, metric)


def _robust_prune(
    data: torch.Tensor, node: int, cand_ids: torch.Tensor,
    cand_d: torch.Tensor, degree: int, alpha: float, metric: str = "l2",
) -> torch.Tensor:
    """Monotonic-RNG α-prune, one node at a time (the scalar oracle): keep
    the closest candidate c, then drop every remaining c' with
    α·d(c, c') ≤ d(node, c').  For "ip" α is forced to 1."""
    order = torch.sort(cand_d, stable=True).indices
    cand_ids = cand_ids[order]
    cand_d = cand_d[order]
    eff_alpha = 1.0 if metric == "ip" else alpha
    keep: List[int] = []
    alive = cand_ids != node
    for i in range(cand_ids.shape[0]):
        if not bool(alive[i]):
            continue
        c = int(cand_ids[i])
        keep.append(c)
        if len(keep) >= degree:
            break
        d_cc = _prune_dists(data, cand_ids, data[c], metric)
        alive = alive & ~(eff_alpha * d_cc <= cand_d)
        alive[i] = False
    return torch.tensor(keep, dtype=torch.int32)


def robust_prune_batch(
    data: torch.Tensor, node_ids, cand_ids, degree: int, alpha: float,
    metric: str = "l2",
) -> torch.Tensor:
    """Vectorized :func:`_robust_prune` over a batch of nodes, on
    ``data``'s device.

    ``node_ids`` is (B,), ``cand_ids`` (B, C) padded with the sentinel
    ``len(data)`` (rows need not be sorted; padding and self entries are
    masked).  Returns (B, degree) int32 kept neighbors, sentinel-padded —
    row b equal to ``_robust_prune`` of node b over the same candidates.
    The greedy loop runs over output slots: each slot picks every row's
    first still-alive candidate and applies the occlusion mask as one
    (B, C) update."""
    n = data.shape[0]
    dev = data.device
    node_ids = _ids(node_ids, dev)
    cand_ids = _ids(cand_ids, dev)
    bsz = cand_ids.shape[0]
    cand_d = prune_dists(data[cand_ids.clamp(max=n - 1)], data[node_ids],
                         metric)
    cand_d = torch.where(cand_ids < n, cand_d, float("inf"))
    cand_d, order = torch.sort(cand_d, dim=1, stable=True)
    cand_ids = cand_ids.gather(1, order)
    cvecs = data[cand_ids.clamp(max=n - 1)]                   # (B, C, d)
    eff_alpha = 1.0 if metric == "ip" else alpha
    alive = (cand_ids < n) & (cand_ids != node_ids[:, None])
    rows = torch.arange(bsz, device=dev)
    out = torch.full((bsz, degree), n, dtype=torch.int32, device=dev)
    for slot in range(degree):
        has = alive.any(dim=1)
        if not bool(has.any()):
            break
        idx = alive.to(torch.uint8).argmax(dim=1)            # first alive
        out[:, slot] = torch.where(has, cand_ids[rows, idx], n)
        if slot == degree - 1:
            break
        d_cc = prune_dists(cvecs, cvecs[rows, idx], metric)   # (B, C)
        alive &= ~(eff_alpha * d_cc <= cand_d)
        alive[rows, idx] = False
    return out


# rows per robust_prune_batch call, and the most candidate-vector bytes one
# call may gather (B · C · d · 4; the difference temporary is as large)
_PRUNE_CHUNK = 2048
_PRUNE_BYTES = 1 << 30
_REPAIR_CHUNK = 1 << 15      # affected rows per delete-repair tile


def _prune_tiles(data: torch.Tensor, node_ids: torch.Tensor,
                 counts: torch.Tensor, rows_of, degree: int, alpha: float,
                 metric: str) -> torch.Tensor:
    """:func:`robust_prune_batch` of every row, tiled: rows sorted by
    candidate count, at most ``_PRUNE_CHUNK`` rows and ``_PRUNE_BYTES`` of
    gathered vectors a tile, each tile ``rows_of(sel, width)`` cut to its
    own widest row.  Rows are independent and the prune ignores padding, so
    the tiling changes no output bit.  Returns (B, degree) int32."""
    n, d = data.shape
    out = torch.full((node_ids.shape[0], degree), n, dtype=torch.int32,
                     device=data.device)
    by_count = torch.sort(counts, stable=True).indices
    sorted_counts = counts[by_count].tolist()
    s, total = 0, len(sorted_counts)
    while s < total:
        take = min(_PRUNE_CHUNK, total - s)
        width = max(sorted_counts[s + take - 1], 1)
        rows_fit = max(1, _PRUNE_BYTES // (width * d * 4))
        if rows_fit < take:
            take = rows_fit
            width = max(sorted_counts[s + take - 1], 1)
        sel = by_count[s:s + take]
        out[sel] = robust_prune_batch(data, node_ids[sel],
                                      rows_of(sel, width), degree, alpha,
                                      metric=metric)
        s += take
    return out


def _prune_round(data: torch.Tensor, node_ids: torch.Tensor,
                 cand: torch.Tensor, degree: int, alpha: float, metric: str,
                 serial: bool) -> torch.Tensor:
    """α-prune every row of ``cand`` ((B, C) ascending candidate ids,
    sentinel-padded); returns (B, degree) int32, sentinel-padded."""
    n = data.shape[0]
    if not serial:
        return _prune_tiles(data, node_ids, (cand < n).sum(dim=1),
                            lambda sel, width: cand[sel, :width], degree,
                            alpha, metric)
    out = torch.full((node_ids.shape[0], degree), n, dtype=torch.int32,
                     device=data.device)
    for i in range(node_ids.shape[0]):
        node = int(node_ids[i])
        c = cand[i][cand[i] < n].long()
        kept = _robust_prune(data, node, c,
                             _prune_dists(data, c, data[node], metric),
                             degree, alpha, metric=metric)
        out[i, :kept.shape[0]] = kept.to(out.device)
    return out


def _prune_segments(data: torch.Tensor, node_ids: torch.Tensor,
                    seg: torch.Tensor, val: torch.Tensor, degree: int,
                    alpha: float, metric: str) -> torch.Tensor:
    """α-prune of ragged candidate lists: row i's candidates are the
    ``val`` of the pairs with ``seg == i`` (pairs sorted by (seg, val)).
    Each tile's rows are built at the tile's own width, so one row with
    thousands of candidates widens only its own tile."""
    n = data.shape[0]
    counts = torch.bincount(seg, minlength=node_ids.shape[0])
    starts = torch.cumsum(counts, 0) - counts

    def rows_of(sel, width):
        slot = torch.arange(width, device=seg.device)
        pos = (starts[sel][:, None] + slot).clamp(max=val.numel() - 1)
        return torch.where(slot < counts[sel][:, None], val[pos], n)
    return _prune_tiles(data, node_ids, counts, rows_of, degree, alpha,
                        metric)


# ---------------------------------------------------------------------------
# Candidate search: the batch-major engine over the graph-so-far
# ---------------------------------------------------------------------------

def _build_search_config(ef: int, metric: str, backend: str) -> SearchConfig:
    """The builder's candidate-search beam: top-M staged traversal with an
    ``ef``-deep frontier, through any registered distance backend."""
    return SearchConfig(
        k=ef, metric=metric, queue_len=ef, m_max=4, staged=True,
        stage_every=1, max_steps=4 * ef, dist_backend=backend,
        visited_mode="bitmap")   # the (B, N) mask IS the prune pool


def _visited_to_rows(vis: torch.Tensor, n: int) -> torch.Tensor:
    """(b, N) bool visited masks -> (b, C) int32 ascending visited ids,
    sentinel-padded, C = the chunk's largest visited count (at least 1)."""
    rows, ids = torch.nonzero(vis, as_tuple=True)     # row-major: ids ascend
    counts = torch.bincount(rows, minlength=vis.shape[0])
    width = max(int(counts.max()), 1)
    pos = torch.arange(ids.shape[0], device=ids.device) \
        - (torch.cumsum(counts, 0) - counts)[rows]
    out = torch.full((vis.shape[0], width), n, dtype=torch.int32,
                     device=vis.device)
    out[rows, pos] = ids.to(torch.int32)
    return out


def _candidate_pool(graph: PaddedCSR, queries: torch.Tensor,
                    cfg: SearchConfig, pool: str, build_batch: int,
                    batch_perm: Optional[int], offset: int) -> torch.Tensor:
    """One chunk's candidate search over the frozen ``graph``: (b, C) int32
    sentinel-padded candidate rows.  ``pool`` picks the candidate set:

    * ``"visited"`` — every vertex the traversal scored, as ascending ids
      (Vamana's prune pool V; the insertion pool);
    * ``"results"`` — the top-ef result ids only (the refinement pool).

    With ``batch_perm`` the chunk is padded to ``build_batch`` lanes
    (repeating its first query), permuted by
    ``RandomState(batch_perm + offset)`` before the search and un-permuted
    after, as the reference does: the audit that lane results do not depend
    on batch position.  Without it no padding is needed, since lanes are
    independent."""
    from repro_torch.core.bfis import (search_topm_batch,
                                       search_topm_batch_visited)
    b = queries.shape[0]
    perm = None
    if batch_perm is not None:
        if b < build_batch:
            queries = torch.cat([queries,
                                 queries[:1].expand(build_batch - b, -1)])
        perm = torch.from_numpy(np.random.RandomState(
            batch_perm + offset).permutation(build_batch)).to(queries.device)
        queries = queries[perm]
    if pool == "visited":
        res = search_topm_batch_visited(graph, queries, cfg)[3]
    elif pool == "results":
        res = search_topm_batch(graph, queries, cfg)[0]
    else:
        raise ValueError(f"unknown candidate pool {pool!r}")
    if perm is not None:
        unperm = torch.empty_like(res)
        unperm[perm] = res
        res = unperm[:b]
    if pool == "visited":
        return _visited_to_rows(res, graph.n_nodes)
    return res.to(torch.int32)


def _canonical_candidates(ids: torch.Tensor, cur: torch.Tensor,
                          node_ids: torch.Tensor, n: int) -> torch.Tensor:
    """Merge search results with current neighbors into the canonical
    candidate form: per row ascending unique ids, self and invalid entries
    mapped to the sentinel ``n``, sentinel-padded, cut to the widest row."""
    allc = torch.cat([ids, cur], dim=1).long()
    allc = torch.where((allc < 0) | (allc >= n), n, allc)
    allc = torch.where(allc == node_ids[:, None], n, allc)
    allc = torch.sort(allc, dim=1).values
    dup = torch.zeros_like(allc, dtype=torch.bool)
    dup[:, 1:] = allc[:, 1:] == allc[:, :-1]
    allc = torch.sort(torch.where(dup, n, allc), dim=1).values
    width = max(int((allc < n).sum(dim=1).max()), 1)
    return allc[:, :width].to(torch.int32)


# ---------------------------------------------------------------------------
# Round application: forward prune + deterministic reverse edges
# ---------------------------------------------------------------------------

def _compact_rows(rows: torch.Tensor, n: int):
    """Valid entries (< n) of each row moved to the front in row order:
    (compacted rows, valid counts)."""
    valid = rows < n
    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True).indices
    return rows.gather(1, order), valid.sum(dim=1)


def _apply_reverse(nbrs: torch.Tensor, data: torch.Tensor,
                   round_ids: torch.Tensor, pruned: torch.Tensor,
                   degree: int, alpha: float, metric: str,
                   serial: bool) -> None:
    """Apply a round's reverse edges p -> u for every forward edge u in
    pruned[p], mutating ``nbrs`` rows of the targets u in place.

    Determinism rule: per target u, the fresh in-neighbors (incoming ∖ the
    row ∖ {u}) in ascending p are appended to the row where they fit; on
    overflow past ``degree`` the row is re-pruned ONCE over the ascending
    unique union.  Targets are independent rows, so all of them go in one
    vectorized pass: the (u, p) pairs sorted by (u, p), the fresh test by a
    search in the targets' sorted (u, v) edge keys, appends by one scatter,
    overflow rows through :func:`robust_prune_batch`."""
    n = data.shape[0]
    if serial:
        _apply_reverse_serial(nbrs, data, round_ids, pruned, degree, alpha,
                              metric)
        return
    valid = pruned < n
    if not bool(valid.any()):
        return
    stride = n + 1
    u = pruned[valid].long()
    p = round_ids[:, None].expand_as(pruned)[valid]
    key = torch.sort(u * stride + p).values
    u, p = key // stride, key % stride
    targets = torch.unique_consecutive(u)
    cur = nbrs[targets]                                        # (T, R)
    edge = torch.where(cur < n, targets[:, None] * stride + cur.long(), -1)
    edge = torch.sort(edge.flatten()).values
    hit = edge[torch.searchsorted(edge, key).clamp(max=edge.numel() - 1)]
    fresh = (hit != key) & (p != u)
    u, p = u[fresh], p[fresh]
    if u.numel() == 0:
        return
    targets, n_fresh = torch.unique_consecutive(u, return_counts=True)
    seg = torch.repeat_interleave(
        torch.arange(targets.numel(), device=u.device), n_fresh)
    cur, n_cur = _compact_rows(nbrs[targets], n)
    fits = n_cur + n_fresh <= degree

    # appends: the compacted row, then the fresh ids at n_cur + rank
    rank = torch.arange(u.numel(), device=u.device) \
        - (torch.cumsum(n_fresh, 0) - n_fresh)[seg]
    rows = cur.clone()
    app = fits[seg]
    rows[seg[app], (n_cur[seg] + rank)[app]] = p[app].to(torch.int32)
    nbrs[targets[fits]] = rows[fits]

    # overflow: one prune over the ascending union of row and fresh ids
    over = torch.nonzero(~fits).flatten()
    if over.numel() == 0:
        return
    slot = torch.full_like(fits, -1, dtype=torch.int64)
    slot[over] = torch.arange(over.numel(), device=u.device)
    ocur = cur[over]
    cvalid = (ocur < n) & (ocur.long() != targets[over][:, None])
    oseg = torch.cat([
        torch.arange(over.numel(), device=u.device)[:, None]
        .expand_as(ocur)[cvalid], slot[seg[~app]]])
    oval = torch.cat([ocur[cvalid].long(), p[~app]])
    okey = torch.sort(oseg * stride + oval).values
    nbrs[targets[over]] = _prune_segments(data, targets[over],
                                          okey // stride, okey % stride,
                                          degree, alpha, metric)


def _apply_reverse_serial(nbrs: torch.Tensor, data: torch.Tensor,
                          round_ids: torch.Tensor, pruned: torch.Tensor,
                          degree: int, alpha: float, metric: str) -> None:
    """The reference's per-target loop with the scalar prune (the oracle
    of :func:`_apply_reverse`; CPU tensors)."""
    n = data.shape[0]
    valid = pruned < n
    u_arr = pruned[valid].long()
    p_arr = round_ids[:, None].expand_as(pruned)[valid]
    order = np.lexsort((p_arr.numpy(), u_arr.numpy()))
    u_arr, p_arr = u_arr[order], p_arr[order]
    targets, counts = torch.unique_consecutive(u_arr, return_counts=True)
    bounds = np.concatenate([[0], np.cumsum(counts.numpy())])
    for t, u in enumerate(targets.tolist()):
        incoming = p_arr[bounds[t]:bounds[t + 1]]
        cur = nbrs[u][nbrs[u] < n].long()
        fresh = incoming[~torch.isin(incoming, cur)]
        fresh = fresh[fresh != u]
        if fresh.shape[0] == 0:
            continue
        if cur.shape[0] + fresh.shape[0] <= degree:
            row = torch.cat([cur, fresh])
            nbrs[u, :row.shape[0]] = row.to(torch.int32)
            nbrs[u, row.shape[0]:] = n
            continue
        cand = torch.unique(torch.cat([cur, fresh]))
        cand = cand[cand != u]
        kept = _robust_prune(data, u, cand,
                             _prune_dists(data, cand, data[u], metric),
                             degree, alpha, metric=metric)
        nbrs[u, :kept.shape[0]] = kept
        nbrs[u, kept.shape[0]:] = n


# ---------------------------------------------------------------------------
# Batch insertion (ParlayANN-style) + refinement
# ---------------------------------------------------------------------------

def insert_points(
    nbrs: torch.Tensor,
    data: torch.Tensor,
    entry: int,
    new_ids,
    n_base: int,
    *,
    degree: int,
    alpha: float,
    ef: int,
    metric: str,
    build_batch: int = 32,
    build_backend: str = "ref",
    serial: bool = False,
    batch_perm: Optional[int] = None,
) -> None:
    """Insert ``new_ids`` (in order) into the live padded adjacency
    ``nbrs`` (an (N, degree) int32 tensor on ``data``'s device, mutated in
    place) by prefix-doubling batch insertion.

    Not-yet-inserted rows must be fully sentinel.  ``n_base`` is how many
    points are already live (0 for a fresh build — the first new id then
    bootstraps the graph bare).  Round sizes double from the live count, so
    the graph depends only on the insertion order, never on
    ``build_batch``."""
    new_ids = _ids(new_ids, data.device)
    n = data.shape[0]
    cfg = _build_search_config(ef, metric, build_backend)
    pos, inserted = 0, n_base
    if inserted == 0 and new_ids.shape[0] > 0:
        nbrs[new_ids[0]] = n          # bootstrap: first point, no edges
        pos, inserted = 1, 1
    while pos < new_ids.shape[0]:
        take = min(inserted, new_ids.shape[0] - pos)
        _process_round(nbrs, data, entry, new_ids[pos:pos + take], cfg,
                       degree, alpha, metric, build_batch, serial,
                       batch_perm)
        pos += take
        inserted += take


def _process_round(
    nbrs: torch.Tensor, data: torch.Tensor, entry: int,
    round_ids: torch.Tensor, cfg: SearchConfig, degree: int, alpha: float,
    metric: str, build_batch: int, serial: bool,
    batch_perm: Optional[int], pool: str = "visited",
) -> None:
    """One build round: every chunk of ``build_batch`` points searches the
    frozen adjacency and α-prunes its candidate pool ∪ current row; the
    forward rows are written once all searches have run, then the
    deterministic reverse pass."""
    n, dim = data.shape
    graph = PaddedCSR(
        nbrs=nbrs, vectors=data,
        medoid=torch.tensor(int(entry), dtype=torch.int32,
                            device=data.device),
        n_top=0, flat=data.new_zeros((0, nbrs.shape[1], dim)))
    pruned = []
    for s in range(0, round_ids.shape[0], build_batch):
        ids = round_ids[s:s + build_batch]
        cand = _candidate_pool(graph, data[ids], cfg, pool, build_batch,
                               batch_perm, s)
        cand = _canonical_candidates(cand, nbrs[ids], ids, n)
        pruned.append(_prune_round(data, ids, cand, degree, alpha, metric,
                                   serial))
    pruned = torch.cat(pruned)
    nbrs[round_ids] = pruned
    _apply_reverse(nbrs, data, round_ids, pruned, degree, alpha, metric,
                   serial)


def _refine_pass(
    nbrs: torch.Tensor, data: torch.Tensor, entry: int,
    order: torch.Tensor, *, degree: int, alpha: float, ef: int, metric: str,
    build_batch: int, build_backend: str, serial: bool,
    batch_perm: Optional[int],
) -> None:
    """One refinement pass: every vertex re-processed in the same doubling
    round partition as insertion (1, 1, 2, 4, ...), each round searching
    the graph as the previous rounds left it, and pruning over the narrow
    ``"results"`` pool (top-ef results ∪ current row) so that incumbent
    long-range edges keep their slots (see ``repro.core.build``)."""
    cfg = _build_search_config(ef, metric, build_backend)
    pos, step = 0, 1
    while pos < order.shape[0]:
        take = min(step, order.shape[0] - pos)
        _process_round(nbrs, data, entry, order[pos:pos + take], cfg,
                       degree, alpha, metric, build_batch, serial,
                       batch_perm, pool="results")
        pos += take
        step *= 2


def build_nsg(
    data,
    degree: int = 32,
    knn_k: int = 32,
    alpha: float = 1.2,
    ef_construction: int = 64,
    seed: int = 0,
    passes: int = 2,
    metric: str = "l2",
    build_batch: int = 32,
    build_backend: str = "ref",
    batch_perm: Optional[int] = None,
    serial: bool = False,
    device=None,
) -> PaddedCSR:
    """Vamana/NSG-style construction by batched prefix-doubling insertion
    (medoid-first random order) plus ``passes - 1`` α-pruned refinement
    passes, on ``device`` (default CUDA).  The insertion pass prunes with
    α=1 when refinement follows; a single-pass build prunes with ``alpha``.

    ``metric``: "l2", "ip" (ip-NSW-style pruning on negative inner
    products) or "cosine" (vectors unit-normalized here, graph built with
    l2; the returned index stores the normalized vectors).  ``knn_k`` is
    accepted for signature compatibility and ignored.  ``build_batch``
    tiles the candidate searches and ``build_backend`` picks their distance
    kernel; neither changes an output bit.  ``batch_perm`` shuffles each
    search chunk (the determinism audit); ``serial`` runs the scalar
    reference prune and reverse loop (CPU)."""
    del knn_k
    dev = resolve_device(device)
    x = _tensor(data, dev).float().contiguous()
    n = x.shape[0]
    if metric == "cosine":
        x = normalize_rows(x)
        metric = "l2"
    elif metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    medoid = compute_medoid(x, metric=metric)
    perm = np.random.RandomState(seed).permutation(n)
    order = _ids(np.concatenate([[medoid], perm[perm != medoid]]), dev)
    nbrs = torch.full((n, degree), n, dtype=torch.int32, device=dev)
    kw = dict(degree=degree, ef=ef_construction, metric=metric,
              build_batch=build_batch, build_backend=build_backend,
              serial=serial, batch_perm=batch_perm)
    a_ins = alpha if passes <= 1 else 1.0
    insert_points(nbrs, x, medoid, order, 0, alpha=a_ins, **kw)
    for _ in range(max(passes - 1, 0)):
        _refine_pass(nbrs, x, medoid, order, alpha=alpha, **kw)
    return make_padded_csr(nbrs, x, medoid=medoid, device=dev)


def build_nsg_serial(
    data,
    degree: int = 32,
    knn_k: int = 32,
    alpha: float = 1.2,
    ef_construction: int = 64,
    seed: int = 0,
    passes: int = 2,
    metric: str = "l2",
) -> PaddedCSR:
    """Per-point reference builder on the CPU: the round schedule and
    candidate searches of :func:`build_nsg`, with every prune through the
    scalar :func:`_robust_prune` loop and reverse edges one target at a
    time.  ``build_nsg(..., build_batch=1)`` must equal it bit for bit."""
    return build_nsg(
        data, degree=degree, knn_k=knn_k, alpha=alpha,
        ef_construction=ef_construction, seed=seed, passes=passes,
        metric=metric, build_batch=1, serial=True, device="cpu")


# ---------------------------------------------------------------------------
# Incremental maintenance: tombstone-delete repair
# ---------------------------------------------------------------------------

def repair_deleted(
    nbrs: torch.Tensor,
    data: torch.Tensor,
    tombstone,
    *,
    degree: int,
    alpha: float,
    metric: str,
    serial: bool = False,
) -> int:
    """Repair the neighborhood of tombstoned vertices (FreshDiskANN-style),
    mutating ``nbrs`` (a tensor on ``data``'s device) in place.

    Every live in-neighbor u of a deleted vertex d re-prunes over
    ``(nbrs[u] ∖ deleted) ∪ (nbrs[d] ∖ deleted ∖ {u})``, all against the
    pre-repair snapshot, vectorized in tiles of ``_REPAIR_CHUNK`` rows.
    Deleted rows keep their out-edges.  Returns the number of repaired
    rows."""
    n = data.shape[0]
    dev = data.device
    tomb = (tombstone if isinstance(tombstone, torch.Tensor)
            else torch.from_numpy(np.asarray(tombstone, bool))).to(dev)
    if not bool(tomb.any()):
        return 0
    snapshot = nbrs.clone()
    valid = snapshot < n
    dead = valid & tomb[snapshot.long().clamp(max=n - 1)]
    affected_all = torch.nonzero(dead.any(dim=1) & ~tomb).flatten()
    for s in range(0, affected_all.numel(), _REPAIR_CHUNK):
        affected = affected_all[s:s + _REPAIR_CHUNK]
        rows = snapshot[affected]                              # (A, R)
        rdead = dead[affected]
        keepers = torch.where(valid[affected] & ~rdead, rows, n)
        inherited = snapshot[torch.where(rdead, rows, 0).long()]  # (A, R, R)
        inherited = torch.where(
            rdead[..., None] & (inherited < n)
            & ~tomb[inherited.long().clamp(max=n - 1)], inherited, n)
        cmat = _canonical_candidates(
            keepers, inherited.reshape(affected.numel(), -1), affected, n)
        nbrs[affected] = _prune_round(data, affected, cmat, degree, alpha,
                                      metric, serial)
    return int(affected_all.numel())


# ---------------------------------------------------------------------------
# HNSW-style hierarchical index (the paper's second baseline)
# ---------------------------------------------------------------------------

class HNSWIndex(NamedTuple):
    base: PaddedCSR                         # level-0 graph (BFiS searches it)
    level_nbrs: Tuple[torch.Tensor, ...]    # per upper level: (N, R_l) int32
    level_nodes: Tuple[torch.Tensor, ...]   # per upper level: member ids
    entry: int


def _upper_level_ids(sub_knn: torch.Tensor, members: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Map a sub-index kNN table onto global ids via a lookup table whose
    last entry IS the global sentinel, so sub-sentinel rows land on ``n``."""
    lut = torch.cat([members.long(),
                     torch.tensor([n], dtype=torch.int64,
                                  device=members.device)])
    return lut[sub_knn.long().clamp(max=members.shape[0])].to(torch.int32)


def build_hnsw(
    data,
    degree: int = 32,
    upper_degree: int = 16,
    ml: float = 0.36,                # 1/ln(M) with M=16
    seed: int = 0,
    alpha: float = 1.2,
    metric: str = "l2",
    build_batch: int = 32,
    build_backend: str = "ref",
    device=None,
) -> HNSWIndex:
    """Simplified HNSW on ``device`` (default CUDA): geometric level
    sampling; each upper level is a kNN graph over its members; level 0 is
    :func:`build_nsg`.  ``metric`` as in :func:`build_nsg`."""
    dev = resolve_device(device)
    x = _tensor(data, dev).float().contiguous()
    n = x.shape[0]
    if metric == "cosine":
        x = normalize_rows(x)
        metric = "l2"
    rng = np.random.RandomState(seed)
    levels = np.minimum(
        (-np.log(np.maximum(rng.uniform(size=n), 1e-12)) * ml).astype(int), 6)
    base = build_nsg(x, degree=degree, alpha=alpha, seed=seed, passes=2,
                     metric=metric, build_batch=build_batch,
                     build_backend=build_backend, device=dev)
    level_nbrs, level_nodes = [], []
    for lvl in range(1, int(levels.max()) + 1):
        members = np.where(levels >= lvl)[0].astype(np.int32)
        if members.shape[0] < 2:
            break
        members_t = torch.from_numpy(members).to(dev)
        k = min(upper_degree, members.shape[0] - 1)
        sub_knn = knn_graph(x[members_t.long()], k, metric=metric)
        full = torch.full((n, upper_degree), n, dtype=torch.int32,
                          device=dev)
        full[members_t.long(), :k] = _upper_level_ids(sub_knn, members_t, n)
        level_nbrs.append(full)
        level_nodes.append(members_t)
    return HNSWIndex(base=base, level_nbrs=tuple(level_nbrs),
                     level_nodes=tuple(level_nodes),
                     entry=int(np.argmax(levels)))
