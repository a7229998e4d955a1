"""Best-first search (Algorithm 1) and single-queue top-M relaxation (§4.1).

Port of ``repro.core.bfis``.  ``search_topm_batch`` advances batch-leading
state (``Frontier``/``Visited``/``SearchStats`` with a leading (B,) query
axis) and issues ONE distance call per global step over the whole
(B, M, R) expansion — the call the CUDA kernels serve.

The reference's ``lax.while_loop`` is a Python loop that tests
``any(alive)`` once per step (one host sync per step).  Converged lanes are
exact no-ops: their new state is discarded by :func:`lane_select`, and the
visited maps — updated in place — are never written for them (see
``core.visited``).  On the meta device (the dry run's trace, where nothing
can be read) :func:`loop_test` runs a loop's body once, as the reference's
compiled module holds it once.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import queue as fq
from repro_torch.core import visited as vs
from repro_torch.core.config import SearchConfig
from repro_torch.core.graph import (PaddedCSR, fetch_neighbor_vectors,
                                    gather_neighbor_ids)
from repro_torch.core.metrics import SearchStats, batch_unique_counts

# dist_fn(graph, active_ids (B, M), nbr_ids (B, M, R), queries (B, d))
# -> (B, M, R) float32 distances, smaller = closer, +inf for padded ids.
DistFn = Callable[[PaddedCSR, torch.Tensor, torch.Tensor, torch.Tensor],
                  torch.Tensor]


def resolve_dist_fn(cfg: SearchConfig,
                    dist_fn: Optional[DistFn] = None) -> DistFn:
    """An explicit ``dist_fn`` wins; otherwise ``cfg.dist_backend`` resolves
    through the kernel registry."""
    if dist_fn is not None:
        return dist_fn
    from repro_torch.kernels.registry import resolve_backend
    return resolve_backend(cfg)


def loop_test() -> Callable[[torch.Tensor], bool]:
    """The test of a host-tested loop, ``go(alive)``, for one loop: on any
    device but ``meta`` it is ``bool(alive.any())``, as it always was; on
    the meta device, where no value can be read, it is True on the first
    trip only, so the body is traced exactly once (the dry run's count of
    a loop body, ``launch.dryrun_ann``)."""
    trips = [0]

    def go(alive: torch.Tensor) -> bool:
        trips[0] += 1
        if alive.device.type == "meta":
            return trips[0] == 1
        return bool(alive.any())
    return go


def dist_l2(graph: PaddedCSR, active_ids: torch.Tensor,
            nbr_ids: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Reference squared-L2 distance via the two-level vector fetch
    ((B, M, R) ids with (B, d) queries, or (M, R) with (d,))."""
    vecs = fetch_neighbor_vectors(graph, active_ids, nbr_ids)
    diff = vecs.float() - queries.float()[..., None, None, :]
    return torch.sum(diff * diff, dim=-1)


def dist_ip(graph: PaddedCSR, active_ids: torch.Tensor,
            nbr_ids: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Reference negative-inner-product distance (MIPS; cosine on
    pre-normalized vectors).  Padding is masked by neighbor validity, not
    by inf arithmetic (inf * 0 -> nan)."""
    vecs = fetch_neighbor_vectors(graph, active_ids, nbr_ids)
    d = -torch.sum(vecs.float() * queries.float()[..., None, None, :],
                   dim=-1)
    return torch.where(nbr_ids < graph.n_nodes, d, float("inf"))


def make_ref_dist_fn(metric: str = "l2") -> DistFn:
    """Metric tag -> plain-torch two-level batch-major DistFn."""
    if metric in ("ip", "cosine"):
        return dist_ip
    if metric == "l2":
        return dist_l2
    raise ValueError(f"unknown metric {metric!r}")


def point_dist(v: torch.Tensor, q: torch.Tensor,
               metric: str = "l2") -> torch.Tensor:
    """Point-to-query distance used to seed the frontier ((B, d) -> (B,))."""
    v, q = v.float(), q.float()
    if metric in ("ip", "cosine"):
        return -torch.sum(v * q, dim=-1)
    return torch.sum((v - q) ** 2, dim=-1)


def lane_select(alive: torch.Tensor, new, old):
    """Per-lane carry masking: where ``alive[b]`` take ``new``, else keep
    ``old``, over every tensor leaf of (nested) NamedTuples and Visited
    maps.  A leaf that is the same tensor in both (a visited table updated
    in place, with dead lanes never written) is kept as it is."""
    if isinstance(new, torch.Tensor):
        if new is old:
            return new
        pred = alive.reshape(alive.shape + (1,) * (new.dim() - alive.dim()))
        return torch.where(pred, new, old)
    if isinstance(new, vs.Visited):
        return new._replace(table=lane_select(alive, new.table, old.table))
    return type(new)(*(lane_select(alive, n, o) for n, o in zip(new, old)))


def expand_batch(
    graph: PaddedCSR,
    queries: torch.Tensor,
    frontier: fq.Frontier,
    visited: vs.Visited,
    m_max: int,
    m,
    dist_fn: DistFn = dist_l2,
    lane_mask: Optional[torch.Tensor] = None,
) -> Tuple[fq.Frontier, vs.Visited, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """One batch-major neighbor-expansion round (Algorithm 1 lines 6–13,
    width m, all B queries at once): frontier select, neighbor gather,
    visited test-and-set, ONE ``dist_fn`` call over the (B, m_max, R)
    candidate grid, frontier insert.

    Returns (frontier', visited', update_positions (B,), n_comps (B,),
    n_uniq (B,)).  ``lane_mask`` (B,) names the lanes whose state the caller
    keeps: only they claim first-toucher credit (as in the reference), and
    only their visited maps are written (in place)."""
    frontier, visited, up_pos, fresh, flat = _expand(
        graph, queries, frontier, visited, m_max, m, dist_fn, lane_mask)
    counted = fresh if lane_mask is None else fresh & lane_mask[:, None]
    n_uniq = batch_unique_counts(flat, counted)
    return frontier, visited, up_pos, \
        fresh.sum(dim=-1, dtype=torch.int32), n_uniq


def expand_lanes(
    graph: PaddedCSR,
    queries: torch.Tensor,
    frontier: fq.Frontier,
    visited: vs.Visited,
    m_max: int,
    m,
    dist_fn: DistFn = dist_l2,
    lane_mask: Optional[torch.Tensor] = None,
) -> Tuple[fq.Frontier, vs.Visited, torch.Tensor, torch.Tensor]:
    """:func:`expand` for B independent lanes at once (a (B, d) queries
    tensor, one lane per row, such as the walker lanes of a sharded
    search), with ONE ``dist_fn`` call over the (B, m_max, R) grid.  Lane
    b's results equal ``expand`` on lane b alone.  Returns (frontier',
    visited', update_positions (B,), n_comps (B,)); ``lane_mask`` (B,)
    names the lanes whose visited maps are written (in place)."""
    frontier, visited, up_pos, fresh, _ = _expand(
        graph, queries, frontier, visited, m_max, m, dist_fn, lane_mask)
    return frontier, visited, up_pos, fresh.sum(dim=-1, dtype=torch.int32)


def expand(
    graph: PaddedCSR,
    q: torch.Tensor,
    frontier: fq.Frontier,
    visited: vs.Visited,
    m_max: int,
    m,
    dist_fn: DistFn = dist_l2,
) -> Tuple[fq.Frontier, vs.Visited, torch.Tensor, torch.Tensor]:
    """Per-query expansion round (the ``core.distributed`` walker building
    block): a (d,) query, an (L,) frontier and an (X,) visited table,
    lifted to a B = 1 batch.  Returns (frontier', visited', update_position,
    n_distance_comps); the table is updated in place.  A single lane has
    no cross-lane overlap, so no first-toucher count is returned."""
    lane = fq.Frontier(*(t[None] for t in frontier))
    table = visited._replace(table=visited.table[None])   # a view
    lane, _, up, n = expand_lanes(graph, q[None], lane, table, m_max, m,
                                  dist_fn)
    return fq.Frontier(*(t[0] for t in lane)), visited, up[0], n[0]


def _expand(graph: PaddedCSR, queries: torch.Tensor, frontier: fq.Frontier,
            visited: vs.Visited, m_max: int, m, dist_fn: DistFn,
            lane_mask: Optional[torch.Tensor]):
    """The expansion round shared by :func:`expand_batch` and
    :func:`expand_lanes`; also returns the fresh mask and the (B, C)
    candidate ids."""
    bsz = queries.shape[0]
    frontier, active_ids, active_valid = fq.select_unchecked(
        frontier, m_max, m)
    nbrs = gather_neighbor_ids(graph, active_ids)          # (B, m_max, R)
    flat = nbrs.reshape(bsz, -1)
    valid = (flat < graph.n_nodes) \
        & active_valid.repeat_interleave(graph.degree, dim=-1)
    visited, fresh = vs.check_and_insert_batch(visited, flat, valid,
                                               write_mask=lane_mask)
    dists = dist_fn(graph, active_ids, nbrs, queries).float()
    dists = torch.where(fresh, dists.reshape(bsz, -1), float("inf"))
    cand_ids = torch.where(fresh, flat, fq.INVALID_ID)
    frontier, up_pos, _ = fq.insert(frontier, cand_ids, dists)
    return frontier, visited, up_pos, fresh, flat


class _TopMState(NamedTuple):
    frontier: fq.Frontier     # leaves (B, L)
    visited: vs.Visited       # table (B, ...)
    stats: SearchStats        # leaves (B,)


def _seed_ids(graph: PaddedCSR, start: Optional[torch.Tensor],
              batch: int) -> torch.Tensor:
    """(B,) int32 traversal entry points: the medoid unless the caller
    provides per-query starts."""
    src = graph.medoid if start is None else start
    src = torch.as_tensor(src, dtype=torch.int32, device=graph.device)
    return src.expand(batch).contiguous()


def _seed_frontier(graph: PaddedCSR, queries: torch.Tensor,
                   cfg: SearchConfig, start: Optional[torch.Tensor]):
    """Frontier (B, L) and visited (B, ...) seeded at the entry points,
    plus the seed ids."""
    bsz = queries.shape[0]
    dev = graph.device
    frontier = fq.make_frontier_batch(cfg.queue_len, bsz, dev)
    visited = vs.make_visited_batch(cfg.visited_mode, graph.n_nodes, bsz,
                                    cfg.hash_bits, dev)
    s = _seed_ids(graph, start, bsz)
    visited, _ = vs.check_and_insert_batch(
        visited, s[:, None], torch.ones((bsz, 1), dtype=torch.bool,
                                        device=dev))
    d0 = point_dist(graph.vectors[s.long()], queries, cfg.metric)[:, None]
    frontier, _, _ = fq.insert(frontier, s[:, None], d0)
    return frontier, visited, s


def _init_state_batch(graph: PaddedCSR, queries: torch.Tensor,
                      cfg: SearchConfig,
                      start: Optional[torch.Tensor]) -> _TopMState:
    bsz = queries.shape[0]
    frontier, visited, s = _seed_frontier(graph, queries, cfg, start)
    # the seed computation participates in first-toucher accounting too
    seed_uniq = batch_unique_counts(
        s[:, None], torch.ones((bsz, 1), dtype=torch.bool, device=s.device))
    stats = SearchStats.zero_batch(bsz, s.device)._replace(
        dist_comps=torch.ones((bsz,), dtype=torch.int32, device=s.device),
        uniq_comps=seed_uniq,
        batch_dup_comps=1 - seed_uniq)
    return _TopMState(frontier, visited, stats)


def staged_m(step: torch.Tensor, cfg: SearchConfig) -> torch.Tensor:
    """§4.2 staging function: M doubles every ``stage_every`` steps
    (elementwise over a (B,) int32 step vector)."""
    if not cfg.staged:
        return torch.full_like(step, cfg.m_max)
    expo = torch.clamp(torch.div(step, cfg.stage_every,
                                 rounding_mode="floor"), max=30)
    return torch.clamp(torch.ones_like(step) << expo, max=cfg.m_max)


def _run_topm_batch(graph: PaddedCSR, queries: torch.Tensor,
                    cfg: SearchConfig, start=None,
                    dist_fn: Optional[DistFn] = None) -> _TopMState:
    """Run the batch-major top-M loop to convergence; returns the final
    state (frontier + visited + stats)."""
    dist_fn = resolve_dist_fn(cfg, dist_fn)
    s = _init_state_batch(graph, queries, cfg, start)

    def lanes_live(s: _TopMState) -> torch.Tensor:
        return fq.has_unchecked(s.frontier) & (s.stats.steps < cfg.max_steps)

    alive = lanes_live(s)
    go = loop_test()
    while go(alive):
        live = fq.has_unchecked(s.frontier).to(torch.int32)
        m = staged_m(s.stats.steps, cfg)
        frontier, visited, _, n, uniq = expand_batch(
            graph, queries, s.frontier, s.visited, cfg.m_max, m, dist_fn,
            lane_mask=alive)
        st = s.stats
        stats = st._replace(
            steps=st.steps + live,
            local_steps=st.local_steps + torch.clamp(m, max=cfg.m_max) * live,
            dist_comps=st.dist_comps + n,
            uniq_comps=st.uniq_comps + uniq,
            batch_dup_comps=st.batch_dup_comps + (n - uniq),
            crit_rounds=st.crit_rounds + live,
        )
        s = lane_select(alive, _TopMState(frontier, visited, stats), s)
        alive = lanes_live(s)
    return s


def search_topm_batch(graph: PaddedCSR, queries: torch.Tensor,
                      cfg: SearchConfig, start=None,
                      dist_fn: Optional[DistFn] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, SearchStats]:
    """Batch-major single-queue top-M search over a (B, d) query batch; one
    distance call per global step.  ``cfg.m_max == 1`` reproduces BFiS.
    Returns (ids (B, k), dists (B, k), stats (B,))."""
    st = _run_topm_batch(graph, queries, cfg, start, dist_fn)
    ids, dists = fq.results(st.frontier, cfg.k)
    return ids, dists, st.stats


def search_topm_batch_visited(graph: PaddedCSR, queries: torch.Tensor,
                              cfg: SearchConfig, start=None,
                              dist_fn: Optional[DistFn] = None):
    """:func:`search_topm_batch` that also returns the per-lane visited set
    as a (B, N) bool mask (requires ``cfg.visited_mode == "bitmap"``)."""
    if cfg.visited_mode != "bitmap":
        raise ValueError(
            "search_topm_batch_visited needs visited_mode='bitmap' (the "
            f"(B, N) mask IS the visited set); got {cfg.visited_mode!r}")
    st = _run_topm_batch(graph, queries, cfg, start, dist_fn)
    ids, dists = fq.results(st.frontier, cfg.k)
    return ids, dists, st.stats, st.visited.table


def _unbatch(out):
    ids, dists, stats = out
    return ids[0], dists[0], SearchStats(*(t[0] for t in stats))


def _start_b(start):
    return None if start is None else \
        torch.as_tensor(start, dtype=torch.int32).reshape(1)


def search_topm(graph: PaddedCSR, q: torch.Tensor, cfg: SearchConfig,
                start=None, dist_fn: Optional[DistFn] = None):
    """Single-query top-M search — a B=1 wrapper over the batch engine."""
    return _unbatch(search_topm_batch(graph, q[None, :], cfg,
                                      start=_start_b(start),
                                      dist_fn=dist_fn))


def bfis_search_batch(graph, queries, cfg: SearchConfig, **kw):
    """Algorithm 1 (the NSG baseline): top-M search with M=1, no staging."""
    return search_topm_batch(
        graph, queries, cfg.with_(m_max=1, staged=False), **kw)


# ---------------------------------------------------------------------------
# HNSW-style hierarchical search (the paper's second baseline)
# ---------------------------------------------------------------------------

def greedy_descent(level_nbrs: torch.Tensor, vectors: torch.Tensor,
                   entry: torch.Tensor, queries: torch.Tensor,
                   max_hops: int = 64, metric: str = "l2") -> torch.Tensor:
    """Greedy walk on one upper level for a (B, d) query batch: every lane
    hops to its closest neighbor until a local minimum (HNSW's ef=1
    upper-level search).  All lanes hop in lockstep; a lane stops when it
    no longer moves, every lane after ``max_hops`` hops.  ``entry`` is (B,)
    int32; returns the (B,) int32 lane positions.  The first of equal
    minima wins, as ``jnp.argmin`` picks it."""
    n = vectors.shape[0]
    qf = queries.float()
    cur = entry.to(torch.int32)
    v = vectors[cur.long().clamp(max=n - 1)]
    cur_d = torch.where(cur < n, point_dist(v, qf, metric), float("inf"))
    moved = torch.ones_like(cur, dtype=torch.bool)
    for _ in range(max_hops):
        if not bool(moved.any()):
            break
        nb = level_nbrs[cur.long()]                             # (B, R_l)
        vecs = vectors[nb.long().clamp(max=n - 1)].float()      # (B, R_l, d)
        if metric in ("ip", "cosine"):
            d = -torch.sum(vecs * qf[:, None, :], dim=-1)
        else:
            d = torch.sum((vecs - qf[:, None, :]) ** 2, dim=-1)
        d = torch.where(nb < n, d, float("inf"))
        j = torch.argmin(d, dim=1, keepdim=True)
        best = d.gather(1, j)[:, 0]
        moved = moved & (best < cur_d)
        cur = torch.where(moved, nb.gather(1, j)[:, 0], cur)
        cur_d = torch.where(moved, best, cur_d)
    return cur


def hnsw_search_batch(index, queries: torch.Tensor, cfg: SearchConfig,
                      dist_fn: Optional[DistFn] = None):
    """HNSW baseline: greedy descent through the upper levels (top level
    first), then the batch-major BFiS at level 0 from the per-query entry
    points."""
    base = index.base
    cur = torch.full((queries.shape[0],), int(index.entry),
                     dtype=torch.int32, device=base.device)
    for lvl in range(len(index.level_nbrs) - 1, -1, -1):
        cur = greedy_descent(index.level_nbrs[lvl], base.vectors, cur,
                             queries, metric=cfg.metric)
    return search_topm_batch(
        base, queries, cfg.with_(m_max=1, staged=False), start=cur,
        dist_fn=dist_fn)
