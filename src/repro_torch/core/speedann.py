"""Speed-ANN intra-query parallel search — Algorithm 3 + §4.2/§4.3/§4.4.

Port of ``repro.core.speedann``.  One *global step*:

  1. scatter: the global queue's unchecked candidates are divided
     round-robin among the ``M`` active walkers (staged: M doubles every
     ``stage_every`` global steps up to ``num_walkers``);
  2. local search: every walker runs a private best-first search on its own
     bounded queue; each local round flattens the (B, W) walker lanes into
     the batch axis of ONE distance call;
  3. CheckMetrics (Algorithm 2): the mean update position over active
     walkers against ``L·R`` triggers a merge;
  4. merge: local queues collapse into the global queue and the walker
     visited maps are OR-merged (in place).

Both ``lax.while_loop``s of the reference are Python loops that test
``any(alive)`` each iteration; finished lanes are masked no-ops.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import queue as fq
from repro_torch.core import visited as vs
from repro_torch.core.bfis import (DistFn, _seed_frontier, _start_b,
                                   _unbatch, expand_batch, lane_select,
                                   resolve_dist_fn, staged_m)
from repro_torch.core.config import SearchConfig
from repro_torch.core.metrics import SearchStats, batch_unique_counts


class _LocalState(NamedTuple):
    locals_: fq.Frontier      # (B, W, L) private walker queues
    up_pos: torch.Tensor      # (B, W) latest update positions
    lstep: torch.Tensor       # (B,) local rounds taken this segment
    do_merge: torch.Tensor    # (B,) bool — CheckMetrics flag
    comps: torch.Tensor       # (B,) distance computations this segment
    uniq: torch.Tensor        # (B,) first-toucher comps this segment


class _GlobalState(NamedTuple):
    frontier: fq.Frontier     # (B, L) global queue S
    stats: SearchStats        # leaves (B,)


def metrics_fire(total: torch.Tensor, count: torch.Tensor,
                 cfg: SearchConfig) -> torch.Tensor:
    """Algorithm 2's test per query: ū = ``total`` / ``count`` ≥ L·R, for
    ``total`` (B,) the active walkers' update positions summed and
    ``count`` (B,) their number (at least 1) -> (B,) bool."""
    return total.float() / count.float() >= cfg.queue_len * cfg.sync_ratio


def check_metrics(up_pos: torch.Tensor, active: torch.Tensor,
                  cfg: SearchConfig) -> torch.Tensor:
    """Algorithm 2 per query: ū ≥ L·R over the ``active`` lowest-index
    walkers.  ``up_pos`` (B, W), ``active`` (B,) -> (B,) bool."""
    w = up_pos.shape[-1]
    is_active = torch.arange(w, device=up_pos.device) < active[..., None]
    return metrics_fire(torch.where(is_active, up_pos, 0).sum(dim=-1),
                        is_active.sum(dim=-1).clamp(min=1), cfg)


def _local_segment_batch(graph, queries: torch.Tensor, locals_: fq.Frontier,
                         visited: vs.Visited, active: torch.Tensor,
                         cfg: SearchConfig, dist_fn: DistFn,
                         query_mask: Optional[torch.Tensor] = None):
    """Lines 11–22 batch-major: private best-first searches for every
    query's walker pool at once, until CheckMetrics fires, every walker
    exhausts its queue, or the ``local_steps`` budget is hit.

    ``query_mask`` (B,) names the queries whose state the caller keeps:
    only they claim first-toucher credit and write their visited maps
    (which are updated in place).  Returns (locals', visited, rounds (B,),
    comps (B,), uniq (B,))."""
    w, cap = cfg.num_walkers, cfg.queue_len
    bsz = queries.shape[0]
    q_rep = queries.repeat_interleave(w, dim=0)            # (B·W, d)
    # a view: in-place writes through it land in the (B, W, ...) map
    vis_flat = visited._replace(
        table=visited.table.view((bsz * w,) + visited.table.shape[2:]))
    is_active = torch.arange(w, device=queries.device) < active[:, None]

    def lanes_live(s: _LocalState) -> torch.Tensor:
        any_work = torch.any(fq.has_unchecked(s.locals_) & is_active, dim=-1)
        return ~s.do_merge & any_work & (s.lstep < cfg.local_steps)

    zeros = torch.zeros((bsz,), dtype=torch.int32, device=queries.device)
    s = _LocalState(
        locals_=locals_,
        up_pos=torch.zeros((bsz, w), dtype=torch.int32,
                           device=queries.device),
        lstep=zeros, do_merge=torch.zeros_like(zeros, dtype=torch.bool),
        comps=zeros, uniq=zeros)
    alive = lanes_live(s)
    while bool(alive.any()):
        counted_q = alive if query_mask is None else alive & query_mask
        had_work = fq.has_unchecked(s.locals_) & is_active
        # ONE batch-major expansion over all B·W walker lanes (M=1 each)
        fr = fq.Frontier(*(t.reshape(bsz * w, -1) for t in s.locals_))
        fr, _, up, n, uniq = expand_batch(
            graph, q_rep, fr, vis_flat, 1, 1, dist_fn,
            lane_mask=counted_q.repeat_interleave(w))
        locals2 = fq.Frontier(*(t.reshape(bsz, w, -1) for t in fr))
        up, n, uniq = (t.reshape(bsz, w) for t in (up, n, uniq))
        # walkers with no unchecked candidates saturate at L (stuck)
        up = torch.where(had_work, up, cap).to(torch.int32)
        new = _LocalState(
            locals_=locals2, up_pos=up, lstep=s.lstep + 1,
            do_merge=check_metrics(up, active, cfg),
            comps=s.comps + torch.where(had_work, n, 0).sum(
                dim=-1, dtype=torch.int32),
            uniq=s.uniq + torch.where(had_work, uniq, 0).sum(
                dim=-1, dtype=torch.int32))
        s = lane_select(alive, new, s)
        alive = lanes_live(s)
    return s.locals_, visited, s.lstep, s.comps, s.uniq


def search_speedann_batch(graph, queries: torch.Tensor, cfg: SearchConfig,
                          start=None, dist_fn: Optional[DistFn] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     SearchStats]:
    """Batch-major Speed-ANN (Algorithm 3) over a (B, d) query batch.
    Returns (ids (B, k), dists (B, k), stats (B,))."""
    dist_fn = resolve_dist_fn(cfg, dist_fn)
    w = cfg.num_walkers
    bsz = queries.shape[0]
    frontier, visited0, s0 = _seed_frontier(graph, queries, cfg, start)
    # Expand the starting point once before dividing work, so the first
    # scatter has a full frontier to distribute.
    frontier, visited0, _, n0, uniq0 = expand_batch(
        graph, queries, frontier, visited0, 1, 1, dist_fn)
    # replicate the seed visited map to all walkers (consistent at t=0)
    t0 = visited0.table
    visited = visited0._replace(
        table=t0[:, None].expand((bsz, w) + t0.shape[1:]).contiguous())
    del visited0, t0

    seed_uniq = batch_unique_counts(
        s0[:, None], torch.ones((bsz, 1), dtype=torch.bool, device=s0.device))
    s = _GlobalState(
        frontier=frontier,
        stats=SearchStats.zero_batch(bsz, s0.device)._replace(
            dist_comps=1 + n0,
            uniq_comps=seed_uniq + uniq0,
            batch_dup_comps=(1 - seed_uniq) + (n0 - uniq0)))

    def lanes_live(s: _GlobalState) -> torch.Tensor:
        return fq.has_unchecked(s.frontier) & (s.stats.steps < cfg.max_steps)

    alive = lanes_live(s)
    while bool(alive.any()):
        # invariant: the walker visited maps are OR-merged on entry
        live = fq.has_unchecked(s.frontier).to(torch.int32)
        m = torch.clamp(staged_m(s.stats.steps, cfg), max=w)
        union_before = vs.popcount(visited)
        # Line 7: divide unchecked candidates among active walkers.
        locals_ = fq.scatter_round_robin(s.frontier, w, m)
        # Lines 11–22: collective-free local searches + CheckMetrics.
        locals_, visited, rounds, comps, uniq = _local_segment_batch(
            graph, queries, locals_, visited, m, cfg, dist_fn,
            query_mask=alive)
        # Line 23: merge local queues into the global queue; §4.4: visited
        # maps reach eventual consistency here (dead queries' maps were not
        # written, so merging them changes nothing).
        merged, _ = fq.merge_frontiers(locals_)
        visited = vs.merge_visited(visited)
        # cross-walker duplicate computations = work minus union growth
        n_dups = comps - (vs.popcount(visited) - union_before)
        st = s.stats
        stats = st._replace(
            steps=st.steps + live,
            local_steps=st.local_steps + rounds * m,
            dist_comps=st.dist_comps + comps,
            dup_comps=st.dup_comps + torch.clamp(n_dups, min=0),
            syncs=st.syncs + live,
            crit_rounds=st.crit_rounds + rounds,
            uniq_comps=st.uniq_comps + uniq,
            batch_dup_comps=st.batch_dup_comps + (comps - uniq),
        )
        s = lane_select(alive, _GlobalState(merged, stats), s)
        alive = lanes_live(s)
    ids, dists = fq.results(s.frontier, cfg.k)
    return ids, dists, s.stats


def search_speedann(graph, q: torch.Tensor, cfg: SearchConfig, start=None,
                    dist_fn: Optional[DistFn] = None):
    """Full Speed-ANN search for one query — a B=1 wrapper."""
    return _unbatch(search_speedann_batch(graph, q[None, :], cfg,
                                          start=_start_b(start),
                                          dist_fn=dist_fn))


# Named ablation variants (§5.3) ------------------------------------------

def variant(cfg: SearchConfig, name: str) -> SearchConfig:
    """The paper's §5.3 configurations."""
    if name == "bfis":               # NSG baseline
        return cfg.with_(m_max=1, num_walkers=1, staged=False)
    if name == "edge_parallel":      # NSG-32T: M=1, walker pool kept
        return cfg.with_(m_max=1, staged=False)
    if name == "nostaged":           # Speed-ANN-NoStaged: fixed M=W
        return cfg.with_(staged=False)
    if name == "nosync":             # Speed-ANN-NoSync: merge only at end
        return cfg.with_(staged=False, sync_ratio=2.0,
                         local_steps=cfg.max_steps)
    if name == "adaptive":           # Speed-ANN-Adaptive (the paper's method)
        return cfg
    raise ValueError(name)
