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
raises ``ValueError`` unless the two are equal.

**Ranks.**  A mesh made with ``ranks`` (``make_search_mesh(shape,
ranks=...)``, after ``ranks.init_ranks``) lays each axis of size S over r
ranks of the process group, S / r lanes on each; the lanes-only mesh is
the case where every r is 1.  Every rank calls the search functions with
the same queries (SPMD), takes its block of them along ``data``, and
issues each of the reference's collectives over the ranks of its axis
after reducing its own lanes: CheckMetrics an int32 sum, the merge an
all-gather of the local frontiers in walker order, the visited maps a
uint8 max (bitmap) or a gathered, ordered fold (hash), the corpus merge
an all-gather of each shard's top-k in shard order.  Every rank returns
the whole batch's answer, gathered over the ``data`` ranks, bit for bit
the lanes path's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import ranks as rank_mod
from repro_torch.core import queue as fq
from repro_torch.core import visited as vs
from repro_torch.core.bfis import (DistFn, _seed_frontier, expand_lanes,
                                   lane_select, loop_test, resolve_dist_fn,
                                   search_topm_batch, staged_m)
from repro_torch.core.config import SearchConfig
from repro_torch.core.graph import PaddedCSR
from repro_torch.core.metrics import SearchStats
from repro_torch.core.speedann import metrics_fire
from repro_torch.device import resolve_device
from repro_torch.ranks import RankAxis

MULTI_CARD_ITEM = 8     # ROADMAP.md §1: a mesh over several cards


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SearchMesh:
    """The port's ``jax.sharding.Mesh``: named axis sizes.  ``shape`` maps
    axis name -> size, as ``dict(mesh.shape)`` does for the reference.

    ``ranks`` gives the ranks of the process group along each axis (all
    ones: every position a lane of ``device``); ``device_mesh`` is the
    ``torch.distributed`` mesh of those ranks, one subgroup per axis, and
    ``device`` this rank's card.  The rank at grid coordinate c holds
    positions [c·S/r, (c+1)·S/r) of an axis of size S over r ranks."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: torch.device
    ranks: Tuple[int, ...] = ()
    device_mesh: Optional[object] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def over_ranks(self) -> bool:
        """Whether the mesh's collectives go over a process group."""
        return self.device_mesh is not None

    def axis_size(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no "
                             f"{name!r} axis")
        return self.shape[name]

    def ranks_along(self, name: str) -> int:
        self.axis_size(name)
        return self.ranks[self.axis_names.index(name)] if self.ranks else 1

    def lanes(self, name: str) -> int:
        """Positions of axis ``name`` on each rank."""
        return self.axis_size(name) // self.ranks_along(name)

    def coord(self, name: str) -> int:
        """This rank's coordinate along axis ``name``."""
        if self.device_mesh is None:
            self.axis_size(name)
            return 0
        return self.device_mesh.get_local_rank(name)

    def axis(self, name: str) -> Optional[RankAxis]:
        """Axis ``name``'s ranks (None on a lanes-only mesh)."""
        if self.device_mesh is None:
            self.axis_size(name)
            return None
        return RankAxis(self.device_mesh.get_group(name),
                        self.ranks_along(name), self.coord(name))


def make_search_mesh(shape, names=("data", "model"), device=None,
                     ranks=None) -> SearchMesh:
    """A search mesh of ``shape`` (one size per name in ``names``).

    Without ``ranks`` every position sits on ``device`` (default CUDA;
    raises when it is absent).  With ``ranks`` (ranks along each axis: each
    divides its axis, their product is the world size) the axes are laid
    over the process group ``ranks.init_ranks`` joined, row-major as
    ``jax.make_mesh`` places devices; ``device`` defaults to this rank's
    and must be it.  Every rank makes the mesh, in the same order."""
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} must "
                         "pair one size with each distinct name")
    if min(shape, default=0) < 1:
        raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
    if ranks is None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return SearchMesh(names, shape, dev)
    from torch.distributed.device_mesh import init_device_mesh
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) != len(shape) or any(
            r < 1 or s % r for s, r in zip(shape, ranks)):
        raise ValueError(f"ranks {ranks} must give each axis of {shape} a "
                         "count of ranks that divides it")
    if not rank_mod.is_up():
        raise RuntimeError("a mesh over ranks needs a process group: call "
                           "repro_torch.ranks.init_ranks first")
    if math.prod(ranks) != rank_mod.world():
        raise ValueError(f"ranks {ranks} must multiply to the world size "
                         f"({rank_mod.world()})")
    dev = rank_mod.device()
    if device is not None and torch.device(device) not in (
            dev, torch.device(dev.type)):
        raise ValueError(f"this rank's device is {dev}, not {device}")
    # the counting group's rank holds meta tensors over a CPU mesh (a
    # CUDA mesh needs CUDA for DTensor's shape propagation)
    dmesh = init_device_mesh("cpu" if dev.type == "meta" else dev.type,
                             ranks, mesh_dim_names=names)
    if dmesh.device_type == "cpu":
        _shard_moves_as_all_to_all()
    return SearchMesh(names, shape, dev, ranks, dmesh)


def _shard_moves_as_all_to_all() -> None:
    """Have DTensor send a move of a split from one dim to another over a
    CPU mesh axis as the one all-to-all (``_dtensor.shard_dim_alltoall``)
    it sends on a CUDA mesh, where it would gather the whole tensor and
    keep a chunk: gloo has the all-to-all, and the dry run's counting
    group stands for NCCL ranks, so its record is the cards'.  Once a
    process; raises when this torch lacks either piece."""
    from torch.distributed.tensor import placement_types
    own = getattr(placement_types, "shard_dim_alltoall", None)
    if getattr(own, "all_to_all_on_cpu", False):
        return
    op = getattr(torch.ops._dtensor, "shard_dim_alltoall", None)
    if own is None or op is None:
        raise RuntimeError(
            f"torch {torch.__version__} lacks DTensor's shard_dim_alltoall, "
            "through which a mesh over ranks on the CPU sends its moves "
            "from one split dim to another")

    def move(t, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu":
            return own(t, gather_dim, shard_dim, mesh, mesh_dim)
        return op(t, gather_dim, shard_dim,
                  mesh.get_group(mesh_dim).group_name)
    move.all_to_all_on_cpu = True
    placement_types.shard_dim_alltoall = move


def check_mesh_device(mesh: SearchMesh, device: torch.device) -> None:
    """Every position of this rank must sit on the device that holds the
    index (on a mesh over ranks: this rank's card)."""
    if mesh.device != device:
        raise ValueError(
            f"the mesh's positions sit on {mesh.device}, the index on "
            f"{device}: check_mesh_device refuses lanes on a card other "
            f"than the index's (ROADMAP.md §1 item {MULTI_CARD_ITEM}, "
            "lanes across cards, not ported); make the mesh on the index's "
            "device, or lay it over ranks with each rank's index on its "
            "own card")


def _check_data_split(mesh: SearchMesh, data_axis: str, batch: int) -> None:
    data = mesh.axis_size(data_axis)
    if batch % data:
        raise ValueError(f"the query batch ({batch}) must split evenly over "
                         f"the mesh's {data_axis!r} axis ({data})")


def _data_block(mesh: SearchMesh, data_axis: str,
                queries: torch.Tensor) -> torch.Tensor:
    """This rank's block of the batch along ``data_axis`` (all of it on a
    lanes-only mesh)."""
    r = mesh.ranks_along(data_axis)
    b = queries.shape[0] // r
    c = mesh.coord(data_axis)
    return queries[c * b:(c + 1) * b]


def _gather_rows(axis: Optional[RankAxis], t: torch.Tensor) -> torch.Tensor:
    """The whole batch's rows from every ``data`` rank's block, in order."""
    return t if axis is None else axis.gather(t, 0)


# ---------------------------------------------------------------------------
# Walker-sharded Speed-ANN
# ---------------------------------------------------------------------------

class _LocalCarry(NamedTuple):
    local: fq.Frontier        # (B, w, L) this rank's walker queues
    rounds: torch.Tensor      # (B,) local rounds taken
    merge: torch.Tensor       # (B,) bool — CheckMetrics flag
    comps: torch.Tensor       # (B,) distance computations, own walkers


def _local_rounds(graph: PaddedCSR, q_rep: torch.Tensor,
                  local: fq.Frontier, visited: vs.Visited,
                  m: torch.Tensor, cfg: SearchConfig, dist_fn: DistFn,
                  w0: int, n_walkers: int, walkers: Optional[RankAxis]):
    """The collective-free local rounds of one global round, for every
    query's w walker lanes of this rank at once (walkers w0 .. w0 + w - 1
    of ``n_walkers``), until CheckMetrics fires or ``cfg.local_steps``
    rounds are taken.  A query takes at least one round (its merge flag is
    first set by a round, as the reference's while_loop sets it); finished
    queries are frozen, their visited maps never written.  CheckMetrics
    sums the active walkers' update positions and counts the walkers with
    work over all walkers: over ``walkers``' ranks one int32 all-reduce a
    round (the reference's scalar psums), so every rank of a walker group
    takes the same trips.  Returns (local', rounds (B,), comps (B,) of
    this rank's walkers)."""
    bsz, w = local.ids.shape[:2]
    cap = cfg.queue_len
    vis_lanes = visited._replace(
        table=visited.table.view((bsz * w,) + visited.table.shape[2:]))
    walker_ok = (w0 + torch.arange(w, device=m.device)) < m[:, None]
    count = torch.clamp(torch.clamp(m, max=n_walkers), min=1).float()
    zeros = torch.zeros((bsz,), dtype=torch.int32, device=m.device)
    c = _LocalCarry(local, zeros, torch.zeros_like(zeros, dtype=torch.bool),
                    zeros)
    alive = torch.full_like(c.merge, cfg.local_steps > 0)
    go = loop_test()
    while go(alive):
        had = fq.has_unchecked(c.local) & walker_ok
        lanes = fq.Frontier(*(t.reshape(bsz * w, -1) for t in c.local))
        lanes, _, up, n = expand_lanes(
            graph, q_rep, lanes, vis_lanes, 1, 1, dist_fn,
            lane_mask=alive.repeat_interleave(w))
        up = torch.where(had, up.reshape(bsz, w), cap).to(torch.int32)
        # CheckMetrics (Algorithm 2): ū over the active walkers, and
        # whether any walker had work
        sums = torch.stack([
            torch.where(walker_ok, up, 0).sum(dim=-1, dtype=torch.int32),
            had.sum(dim=-1, dtype=torch.int32)])
        if walkers is not None:
            sums = walkers.all_reduce(sums, "sum")
        merge = metrics_fire(sums[0], count, cfg) | (sums[1] == 0)
        new = _LocalCarry(
            local=fq.Frontier(*(t.reshape(bsz, w, -1) for t in lanes)),
            rounds=c.rounds + 1, merge=merge,
            comps=c.comps + torch.where(had, n.reshape(bsz, w), 0).sum(
                dim=-1, dtype=torch.int32))
        c = lane_select(alive, new, c)
        alive = ~c.merge & (c.rounds < cfg.local_steps)
    return c.local, c.rounds, c.comps


def _gather_walkers(walkers: Optional[RankAxis],
                    local: fq.Frontier) -> fq.Frontier:
    """(B, W, L): every walker group rank's (B, w, L) queues in walker
    order (``checked`` travels as uint8)."""
    if walkers is None:
        return local
    checked = walkers.gather(local.checked.to(torch.uint8), 1)
    return fq.Frontier(ids=walkers.gather(local.ids, 1),
                       dists=walkers.gather(local.dists, 1),
                       checked=checked.bool())


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

    queries: (B, d), B divisible by the mesh's ``data_axis`` size (over
    ranks: every rank passes the whole batch and searches its block).
    Returns (ids (B, k), dists (B, k), stats (B,)) of the whole batch on
    every rank; ``uniq_comps`` and ``batch_dup_comps`` stay 0, as in the
    reference."""
    check_mesh_device(mesh, graph.device)
    _check_data_split(mesh, data_axis, queries.shape[0])
    n_walkers = mesh.axis_size(walker_axis)
    w = mesh.lanes(walker_axis)
    w0 = mesh.coord(walker_axis) * w       # this rank's first walker
    walkers, data = mesh.axis(walker_axis), mesh.axis(data_axis)
    dist_fn = resolve_dist_fn(cfg, dist_fn)
    queries = _data_block(mesh, data_axis, queries)
    bsz = queries.shape[0]
    # every walker seeds and expands the entry point alike on its own
    # replica: expand once and replicate the visited map to the w walkers
    frontier, visited, _ = _seed_frontier(graph, queries, cfg, None)
    frontier, visited, _, n0 = expand_lanes(graph, queries, frontier,
                                            visited, 1, 1, dist_fn)
    t0 = visited.table
    visited = visited._replace(
        table=t0[:, None].expand((bsz, w) + t0.shape[1:]).contiguous())
    del t0
    stats = SearchStats.zero_batch(bsz, queries.device)._replace(
        dist_comps=1 + n0)
    q_rep = queries.repeat_interleave(w, dim=0)            # (B·w, d)
    for _ in range(cfg.global_rounds):
        live = fq.has_unchecked(frontier).to(torch.int32)
        m = torch.clamp(staged_m(stats.steps, cfg), max=n_walkers)
        # Line 7: this rank's walkers' shares of the replicated queue (the
        # reference's _scatter_share, computed on each walker's replica)
        local = fq.Frontier(*(t[:, w0:w0 + w] for t in
                              fq.scatter_round_robin(frontier, n_walkers, m)))
        union_before = vs.popcount(visited)
        local, rounds, comps = _local_rounds(graph, q_rep, local, visited,
                                             m, cfg, dist_fn, w0, n_walkers,
                                             walkers)
        if walkers is not None:
            comps = walkers.all_reduce(comps, "sum")
        # Line 23 over the walker axis (the reference's all_gather, dedup,
        # top-L), and §4.4's visited reduction in place: bitmap OR, hash
        # the ordered fold over walkers 0..W-1, loose a no-op
        frontier, _ = fq.merge_frontiers(_gather_walkers(walkers, local))
        visited = vs.merge_visited(visited, walkers)
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
    return (_gather_rows(data, ids), _gather_rows(data, dists),
            SearchStats(*(_gather_rows(data, t) for t in stats)))


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


def _shard_block(mesh: Optional[SearchMesh],
                 num_shards: int) -> Tuple[int, int]:
    """(first, count): the shards this rank holds along the ``model`` axis
    (every shard without a mesh or on a lanes-only one)."""
    if mesh is None:
        return 0, num_shards
    r = mesh.ranks_along("model")
    if num_shards % r:
        raise ValueError(f"{num_shards} shards do not split over the "
                         f"{r} ranks of the mesh's 'model' axis")
    per = num_shards // r
    return mesh.coord("model") * per, per


def build_partitioned(data, num_shards: int, degree: int = 24,
                      device=None, mesh: Optional[SearchMesh] = None,
                      **nsg_kw) -> ShardedIndex:
    """Partition the corpus contiguously and build one sub-index per shard
    (``core.build.build_nsg``, ``nsg_kw`` passed on) on ``device``
    (default CUDA; the mesh's with ``mesh``).  Shards are padded to the
    largest with rows of +inf and their sentinels remapped to the padded
    size.  On a mesh over ranks each rank builds and holds only its block
    of shards along ``model`` (with their global offsets), bit for bit
    those rows of the whole build."""
    from repro_torch.core.build import build_nsg
    dev = mesh.device if mesh is not None else resolve_device(device)
    x = (data if isinstance(data, torch.Tensor)
         else torch.from_numpy(np.asarray(data, np.float32)))
    n = x.shape[0]
    per = n // num_shards
    bounds = [(s * per, (s + 1) * per if s < num_shards - 1 else n)
              for s in range(num_shards)]
    max_n = max(hi - lo for lo, hi in bounds)
    first, count = _shard_block(mesh, num_shards)
    nbrs, vecs, meds, offs = [], [], [], []
    for lo, hi in bounds[first:first + count]:
        g = build_nsg(x[lo:hi].to(dev, torch.float32), degree=degree,
                      device=dev, **nsg_kw)
        pad = max_n - g.n_nodes
        nbrs.append(torch.cat([
            torch.where(g.nbrs >= g.n_nodes, max_n, g.nbrs),
            g.nbrs.new_full((pad, g.degree), max_n)]).to(torch.int32))
        vecs.append(torch.cat([g.vectors.float(), g.vectors.new_full(
            (pad, g.dim), float("inf"), dtype=torch.float32)]))
        meds.append(g.medoid)
        offs.append(lo)
    return ShardedIndex(
        nbrs=torch.stack(nbrs), vectors=torch.stack(vecs),
        medoids=torch.stack(meds).to(torch.int32),
        offsets=torch.tensor(offs, dtype=torch.int32, device=dev))


def local_shards(index: ShardedIndex, mesh: SearchMesh,
                 shard_axis: str = "model") -> ShardedIndex:
    """This rank's block of a whole index (one shard per position of
    ``shard_axis``), as :func:`corpus_sharded_search` takes it over
    ranks."""
    n_pos, per = mesh.axis_size(shard_axis), mesh.lanes(shard_axis)
    if index.num_shards != n_pos:
        raise ValueError(f"the index has {index.num_shards} shards and the "
                         f"mesh's {shard_axis!r} axis {n_pos} positions")
    first = mesh.coord(shard_axis) * per
    return ShardedIndex(*(t[first:first + per] for t in index))


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
    stable (dist, id) sort of the S·k candidates, shard by shard.  Over
    ranks ``index`` is this rank's block of shards (``build_partitioned``
    over the mesh, or :func:`local_shards`), searched for this rank's
    block of the batch; the lists are gathered over the shard ranks in
    shard order.

    Returns (global ids (B, k), dists (B, k)) of the whole batch.  Raises
    ``ValueError`` unless ``index.num_shards`` equals the positions of the
    mesh's ``shard_axis`` on this rank (all of them on a lanes-only
    mesh)."""
    check_mesh_device(mesh, index.device)
    _check_data_split(mesh, data_axis, queries.shape[0])
    n_pos, per = mesh.axis_size(shard_axis), mesh.lanes(shard_axis)
    if index.num_shards != per:
        raise ValueError(
            f"the index has {index.num_shards} shards and the mesh's "
            f"{shard_axis!r} axis {n_pos} positions ({per} on this rank); "
            "corpus-sharded search needs one shard per position (with more "
            "shards than positions the reference searches only the first "
            "shard of each)")
    dist_fn = resolve_dist_fn(cfg, dist_fn)
    queries = _data_block(mesh, data_axis, queries)
    all_ids, all_d = [], []
    for s in range(index.num_shards):
        ids, dists, _ = search_topm_batch(index.shard(s), queries, cfg,
                                          dist_fn=dist_fn)
        all_ids.append(torch.where(ids == fq.INVALID_ID, fq.INVALID_ID,
                                   ids + index.offsets[s]).to(torch.int32))
        all_d.append(dists)
    flat_i, flat_d = torch.cat(all_ids, dim=-1), torch.cat(all_d, dim=-1)
    shards = mesh.axis(shard_axis)
    if shards is not None:
        flat_i, flat_d = shards.gather(flat_i, -1), shards.gather(flat_d, -1)
    flat_d, flat_i = fq._sort_by(flat_d, flat_i)
    data = mesh.axis(data_axis)
    return (_gather_rows(data, flat_i[:, :cfg.k]),
            _gather_rows(data, flat_d[:, :cfg.k]))


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
                            device=None, mesh: Optional[SearchMesh] = None
                            ) -> ShardedIndex:
    """Corpus partitioning driven by an :class:`repro_torch.ann.IndexSpec`
    (degree, alpha, ef_construction, passes, seed, build_batch,
    build_backend), on ``device`` (default CUDA); over a mesh of ranks each
    rank builds its block of shards (``build_partitioned``).  For ``cosine`` the
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
        data, num_shards, degree=spec.degree, device=device, mesh=mesh,
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
