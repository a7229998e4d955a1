"""Distributed Speed-ANN: walker-sharded and corpus-sharded search.

Port of ``repro.core.distributed``.  The reference runs both modes under
``shard_map`` on a ("data", "model") device mesh; the port places every
position of a :class:`SearchMesh` on ONE device, as JAX's forced host
devices place them on one CPU, and turns the positions into lanes of one
batch:

* **walker sharding** (the paper's intra-query parallelism): the query
  batch splits over ``data``; each ``model`` position is one Speed-ANN
  walker with a private frontier and visited map over the replicated
  graph.  A global round = scatter (each walker's share of the replicated
  queue) → collective-free local rounds, ended per query by CheckMetrics
  (the reference's one scalar ``psum`` per local round; here a reduction
  over the walker axis) → merge (the reference's ``all_gather`` of the
  local frontiers, dedup, top-L; visited maps OR-reduced).  Every query's
  (data, model) lanes advance together: one distance call per local round
  covers all B × W walker lanes.
* **corpus sharding** (§5.5): the corpus is split into shards, each
  ``model`` position searches its own shard's sub-index, and the global
  top-K is merged over the shards' top-K lists.

Per query, neither mode depends on the ``data`` split or on a ``pod`` axis
(which replicates queries), so each query is computed once.  The outer
loop of the walker mode is the static ``cfg.global_rounds`` (converged
queries run no-op rounds and their counters follow the reference's).

One rule is the port's own: the reference gives each device its block of
shards and searches only the first, so a ``ShardedIndex`` with more shards
than the mesh's ``model`` axis silently loses shards there.  The port
raises ``ValueError`` unless the two are equal.  A mesh over several cards
(one rank per card) is not ported: every position sits on the mesh's one
device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import queue as fq
from repro_torch.core import visited as vs
from repro_torch.core.bfis import (DistFn, _seed_frontier, expand_lanes,
                                   lane_select, resolve_dist_fn,
                                   search_topm_batch, staged_m)
from repro_torch.core.config import SearchConfig
from repro_torch.core.graph import PaddedCSR
from repro_torch.core.metrics import SearchStats
from repro_torch.core.speedann import check_metrics
from repro_torch.device import resolve_device

MULTI_CARD_ITEM = 8     # ROADMAP.md §1: a mesh over several cards


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SearchMesh:
    """The port's ``jax.sharding.Mesh``: named axis sizes whose positions
    all sit on one ``device``.  ``shape`` maps axis name -> size, as
    ``dict(mesh.shape)`` does for the reference."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def axis_size(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no "
                             f"{name!r} axis")
        return self.shape[name]


def make_search_mesh(shape, names=("data", "model"),
                     device=None) -> SearchMesh:
    """A search mesh of ``shape`` (one size per name in ``names``), every
    position on ``device`` (default CUDA; raises when it is absent)."""
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} must "
                         "pair one size with each distinct name")
    if min(shape, default=0) < 1:
        raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return SearchMesh(names, shape, dev)


def check_mesh_device(mesh: SearchMesh, device: torch.device) -> None:
    """Every mesh position must sit on the device that holds the index."""
    if mesh.device != device:
        raise ValueError(
            f"the mesh's positions sit on {mesh.device}, the index on "
            f"{device}: a mesh over several cards is not ported (ROADMAP.md "
            f"§1 item {MULTI_CARD_ITEM}); make the mesh on the index's "
            "device")


def _check_data_split(mesh: SearchMesh, data_axis: str, batch: int) -> None:
    data = mesh.axis_size(data_axis)
    if batch % data:
        raise ValueError(f"the query batch ({batch}) must split evenly over "
                         f"the mesh's {data_axis!r} axis ({data})")


# ---------------------------------------------------------------------------
# Walker-sharded Speed-ANN
# ---------------------------------------------------------------------------

class _LocalCarry(NamedTuple):
    local: fq.Frontier        # (B, W, L) walker queues
    rounds: torch.Tensor      # (B,) local rounds taken
    merge: torch.Tensor       # (B,) bool — CheckMetrics flag
    comps: torch.Tensor       # (B,) distance computations, all walkers


def _local_rounds(graph: PaddedCSR, q_rep: torch.Tensor,
                  local: fq.Frontier, visited: vs.Visited,
                  m: torch.Tensor, cfg: SearchConfig, dist_fn: DistFn):
    """The collective-free local rounds of one global round, for every
    query's W walker lanes at once, until CheckMetrics fires or
    ``cfg.local_steps`` rounds are taken.  A query takes at least one
    round (its merge flag is first set by a round, as the reference's
    while_loop sets it); finished queries are frozen, their visited maps
    never written.  Returns (local', rounds (B,), comps (B,))."""
    bsz, w = local.ids.shape[:2]
    cap = cfg.queue_len
    vis_lanes = visited._replace(
        table=visited.table.view((bsz * w,) + visited.table.shape[2:]))
    walker_ok = torch.arange(w, device=m.device) < m[:, None]    # (B, W)
    zeros = torch.zeros((bsz,), dtype=torch.int32, device=m.device)
    c = _LocalCarry(local, zeros, torch.zeros_like(zeros, dtype=torch.bool),
                    zeros)
    alive = torch.full_like(c.merge, cfg.local_steps > 0)
    while bool(alive.any()):
        had = fq.has_unchecked(c.local) & walker_ok
        lanes = fq.Frontier(*(t.reshape(bsz * w, -1) for t in c.local))
        lanes, _, up, n = expand_lanes(
            graph, q_rep, lanes, vis_lanes, 1, 1, dist_fn,
            lane_mask=alive.repeat_interleave(w))
        up = torch.where(had, up.reshape(bsz, w), cap).to(torch.int32)
        # CheckMetrics: the reference's scalar psums over the walker axis
        new = _LocalCarry(
            local=fq.Frontier(*(t.reshape(bsz, w, -1) for t in lanes)),
            rounds=c.rounds + 1,
            merge=check_metrics(up, m, cfg) | ~had.any(dim=-1),
            comps=c.comps + torch.where(had, n.reshape(bsz, w), 0).sum(
                dim=-1, dtype=torch.int32))
        c = lane_select(alive, new, c)
        alive = ~c.merge & (c.rounds < cfg.local_steps)
    return c.local, c.rounds, c.comps


def walker_sharded_search(
    graph: PaddedCSR,
    queries: torch.Tensor,
    cfg: SearchConfig,
    mesh: SearchMesh,
    data_axis: str = "data",
    walker_axis: str = "model",
    dist_fn: Optional[DistFn] = None,
) -> Tuple[torch.Tensor, torch.Tensor, SearchStats]:
    """Speed-ANN with one walker per position along ``walker_axis``
    (``cfg.num_walkers`` is not read).

    queries: (B, d), B divisible by the mesh's ``data_axis`` size.
    Returns (ids (B, k), dists (B, k), stats (B,)); ``uniq_comps`` and
    ``batch_dup_comps`` stay 0, as in the reference."""
    check_mesh_device(mesh, graph.device)
    _check_data_split(mesh, data_axis, queries.shape[0])
    w = mesh.axis_size(walker_axis)
    dist_fn = resolve_dist_fn(cfg, dist_fn)
    bsz = queries.shape[0]
    # every walker seeds and expands the entry point alike on its own
    # replica: expand once and replicate the visited map to the W walkers
    frontier, visited, _ = _seed_frontier(graph, queries, cfg, None)
    frontier, visited, _, n0 = expand_lanes(graph, queries, frontier,
                                            visited, 1, 1, dist_fn)
    t0 = visited.table
    visited = visited._replace(
        table=t0[:, None].expand((bsz, w) + t0.shape[1:]).contiguous())
    del t0
    stats = SearchStats.zero_batch(bsz, queries.device)._replace(
        dist_comps=1 + n0)
    q_rep = queries.repeat_interleave(w, dim=0)            # (B·W, d)
    for _ in range(cfg.global_rounds):
        live = fq.has_unchecked(frontier).to(torch.int32)
        m = torch.clamp(staged_m(stats.steps, cfg), max=w)
        # Line 7: every walker's share of the replicated queue (the
        # reference's _scatter_share, computed on device w from its replica)
        local = fq.scatter_round_robin(frontier, w, m)
        union_before = vs.popcount(visited)
        local, rounds, comps = _local_rounds(graph, q_rep, local, visited,
                                             m, cfg, dist_fn)
        # Line 23 over the walker axis (the reference's all_gather, dedup,
        # top-L), and §4.4's visited reduction in place: bitmap OR, hash
        # the ordered fold over walkers 0..W-1, loose a no-op
        frontier, _ = fq.merge_frontiers(local)
        visited = vs.merge_visited(visited)
        n_dups = torch.clamp(comps - (vs.popcount(visited) - union_before),
                             min=0)
        st = stats
        stats = st._replace(
            steps=st.steps + live,
            local_steps=st.local_steps + rounds * m,
            dist_comps=st.dist_comps + comps,
            dup_comps=st.dup_comps + n_dups * live,
            syncs=st.syncs + live,
            crit_rounds=st.crit_rounds + rounds)
    ids, dists = fq.results(frontier, cfg.k)
    return ids, dists, stats


# ---------------------------------------------------------------------------
# Corpus-sharded search (§5.5)
# ---------------------------------------------------------------------------

class ShardedIndex(NamedTuple):
    """Per-shard sub-indices stacked on a leading shard axis, on one
    device."""
    nbrs: torch.Tensor       # (S, N_s, R) shard-local neighbor ids
    vectors: torch.Tensor    # (S, N_s, d); pad rows +inf
    medoids: torch.Tensor    # (S,) int32
    offsets: torch.Tensor    # (S,) int32: global id = offsets[s] + local id

    @property
    def num_shards(self) -> int:
        return self.nbrs.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.nbrs.device

    def shard(self, s: int) -> PaddedCSR:
        """Shard ``s`` as a graph of N_s nodes (no flattened top level)."""
        vectors = self.vectors[s]
        return PaddedCSR(
            nbrs=self.nbrs[s], vectors=vectors, medoid=self.medoids[s],
            n_top=0,
            flat=vectors.new_zeros((0, self.nbrs.shape[2], self.dim)))


def build_partitioned(data, num_shards: int, degree: int = 24,
                      device=None, **nsg_kw) -> ShardedIndex:
    """Partition the corpus contiguously and build one sub-index per shard
    (``core.build.build_nsg``, ``nsg_kw`` passed on) on ``device``
    (default CUDA).  Shards are padded to the largest with rows of +inf
    and their sentinels remapped to the padded size."""
    from repro_torch.core.build import build_nsg
    dev = resolve_device(device)
    x = (data if isinstance(data, torch.Tensor)
         else torch.from_numpy(np.asarray(data, np.float32)))
    n = x.shape[0]
    per = n // num_shards
    graphs, offs = [], []
    for s in range(num_shards):
        lo, hi = s * per, (s + 1) * per if s < num_shards - 1 else n
        graphs.append(build_nsg(x[lo:hi].to(dev, torch.float32),
                                degree=degree, device=dev, **nsg_kw))
        offs.append(lo)
    max_n = max(g.n_nodes for g in graphs)
    nbrs, vecs = [], []
    for g in graphs:
        pad = max_n - g.n_nodes
        nbrs.append(torch.cat([
            torch.where(g.nbrs >= g.n_nodes, max_n, g.nbrs),
            g.nbrs.new_full((pad, g.degree), max_n)]).to(torch.int32))
        vecs.append(torch.cat([g.vectors.float(), g.vectors.new_full(
            (pad, g.dim), float("inf"), dtype=torch.float32)]))
    meds = torch.stack([g.medoid for g in graphs]).to(torch.int32)
    return ShardedIndex(
        nbrs=torch.stack(nbrs), vectors=torch.stack(vecs), medoids=meds,
        offsets=torch.tensor(offs, dtype=torch.int32, device=dev))


def corpus_sharded_search(
    index: ShardedIndex,
    queries: torch.Tensor,
    cfg: SearchConfig,
    mesh: SearchMesh,
    data_axis: str = "data",
    shard_axis: str = "model",
    dist_fn: Optional[DistFn] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each ``shard_axis`` position searches its shard (the batch-major
    top-M engine, local ids + the shard's offset); the global top-K is a
    stable (dist, id) sort of the S·k candidates, shard by shard.

    Returns (global ids (B, k), dists (B, k)).  Raises ``ValueError``
    unless ``index.num_shards`` equals the mesh's ``shard_axis`` size."""
    check_mesh_device(mesh, index.device)
    _check_data_split(mesh, data_axis, queries.shape[0])
    n_pos = mesh.axis_size(shard_axis)
    if index.num_shards != n_pos:
        raise ValueError(
            f"the index has {index.num_shards} shards and the mesh's "
            f"{shard_axis!r} axis {n_pos} positions; corpus-sharded search "
            "needs one shard per position (with more shards than positions "
            "the reference searches only the first shard of each)")
    dist_fn = resolve_dist_fn(cfg, dist_fn)
    all_ids, all_d = [], []
    for s in range(index.num_shards):
        ids, dists, _ = search_topm_batch(index.shard(s), queries, cfg,
                                          dist_fn=dist_fn)
        all_ids.append(torch.where(ids == fq.INVALID_ID, fq.INVALID_ID,
                                   ids + index.offsets[s]).to(torch.int32))
        all_d.append(dists)
    flat_d, flat_i = fq._sort_by(torch.cat(all_d, dim=-1),
                                 torch.cat(all_ids, dim=-1))
    return flat_i[:, :cfg.k], flat_d[:, :cfg.k]


# ---------------------------------------------------------------------------
# Engine-shaped entry points (facade types in, facade types out)
# ---------------------------------------------------------------------------

def walker_engine_search(index, queries, params,
                         mesh: Optional[SearchMesh] = None):
    """Walker-sharded dispatch with facade types: ``AnnIndex`` +
    ``SearchParams`` in, ``SearchResult`` out, through
    ``index.search(algorithm="sharded")`` (cosine normalization, grouping
    remap and searcher caching are the facade's).  ``mesh=None`` is the
    default (1, 1) mesh on the index's device."""
    return index.search(queries, params.with_(algorithm="sharded"),
                        mesh=mesh)


def build_partitioned_index(data, num_shards: int, spec=None,
                            device=None) -> ShardedIndex:
    """Corpus partitioning driven by an :class:`repro_torch.ann.IndexSpec`
    (degree, alpha, ef_construction, passes, seed, build_batch,
    build_backend), on ``device`` (default CUDA).  For ``cosine`` the
    corpus is unit-normalized first, on the host as the reference does
    (cosine == ip on the unit sphere) and built with l2.  Quantized specs
    are refused."""
    from repro_torch.ann.spec import IndexSpec
    if spec is None:
        spec = IndexSpec()
    if spec.quant.enabled:
        raise ValueError("quantized storage is not wired into the "
                         "corpus-sharded path; use IndexSpec(quant='none')")
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    data = np.asarray(data, np.float32)
    if spec.metric == "cosine":
        data = data / np.maximum(
            np.linalg.norm(data, axis=1, keepdims=True), 1e-12)
    build_metric = "l2" if spec.metric == "cosine" else spec.metric
    return build_partitioned(
        data, num_shards, degree=spec.degree, device=device,
        alpha=spec.alpha, ef_construction=spec.resolved_ef,
        passes=spec.passes, seed=spec.seed, metric=build_metric,
        build_batch=spec.build_batch, build_backend=spec.build_backend)


def corpus_engine_searcher(index: ShardedIndex, params, mesh: SearchMesh,
                           metric: str = "l2"):
    """A batched callable ``fn(queries (B, d)) -> (ids, dists, stats)``
    over a partitioned corpus, shaped for the serving engine: each shard
    searched by a sequential best-first walker (top-M with M = 1,
    unstaged, one walker), the global top-K merged over the shards.
    Queries go to the mesh's device and are unit-normalized for
    ``metric="cosine"``.  ``stats`` is zero-filled, batched over B: per
    query counters do not cross the shard merge."""
    cfg = params.to_search_config(metric).with_(m_max=1, staged=False,
                                                num_walkers=1)
    normalize = metric == "cosine"
    check_mesh_device(mesh, index.device)

    def fn(queries):
        q = torch.as_tensor(queries)
        if q.dim() != 2:
            raise ValueError(f"queries must be (B, d), got "
                             f"{tuple(q.shape)}")
        q = q.to(mesh.device, torch.float32).contiguous()
        if normalize:
            q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                                min=1e-12)
        ids, dists = corpus_sharded_search(index, q, cfg, mesh)
        return ids, dists, SearchStats.zero_batch(q.shape[0], q.device)
    return fn
