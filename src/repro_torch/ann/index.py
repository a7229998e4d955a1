"""``AnnIndex`` — the port's public API for vector search.

Port of ``repro.ann.index``: the whole single-device lifecycle on one
device (CUDA unless the caller names another)::

    from repro_torch.ann import AnnIndex, IndexSpec, SearchParams

    index = AnnIndex.build(data, IndexSpec(metric="l2", degree=32,
                                           build_backend="rowgather",
                                           build_batch=4096))
    index.add(new_vectors)                            # live insert
    index.delete(ids)                                 # tombstone + repair
    index.save("idx.npz")
    index = AnnIndex.load("idx.npz")
    res = index.search(queries, SearchParams(algorithm="speedann", m_max=8,
                                             backend="rowgather"))
    engine = index.serve(params)                      # bucketed serving
    srv = index.serve_async(params)                   # coalescing front-end

``build`` runs either builder (``nsg``, ``hnsw``) on the device, its
candidate searches through ``build_backend``'s kernel; ``build_batch``
tiles them (a larger tile is faster on the card and changes no output
bit).  ``load``/``from_arrays``/``save`` read and write the reference's
npz layout (formats 1–3, hnsw levels included), so an index built by
either package searches in the other and files round-trip both ways.  The
search runs every algorithm (bfis | topm | speedann | sharded; bfis on an
hnsw index descends its upper levels first) over every distance backend
and metric, with cosine query normalization, the tombstone mask, exact
re-ranking and the neighbor-grouping id remap, in the reference's order.
"sharded" is the walker-sharded path of :mod:`repro_torch.core.distributed`
on a :class:`~repro_torch.core.distributed.SearchMesh` whose positions sit
on the index's device, or are laid over the ranks of a process group
(every rank loads the index on its card and searches the same queries)::

    mesh = make_search_mesh((1, 4), device=index.device)   # 4 walkers
    res = index.search(queries, SearchParams(algorithm="sharded"), mesh=mesh)
    # torchrun, 4 ranks: init_ranks(); make_search_mesh((1, 4), ranks=(1, 4))

Quantized storage: :func:`quantize_graph` attaches int8 codes + scales (or
bf16 codes) to a graph, and ``SearchParams(rerank_k=...)`` makes a search
two-stage — traversal over the codes through a quantized backend
(``ref_int8`` | ``rowgather_int8`` | ``dedup_gather_int8`` | ``ref_bf16``),
then exact f32 re-ranking of the widened pool::

    graph = quantize_graph(index.graph, QuantSpec("int8"))
    qindex = AnnIndex(index.spec.with_(quant="int8"), graph)
    res = qindex.search(queries, SearchParams(k=10, rerank_k=30,
                                              backend="rowgather_int8"))
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.ann.spec import IndexSpec, SearchParams
from repro_torch.core.bfis import (bfis_search_batch, hnsw_search_batch,
                                   search_topm_batch)
from repro_torch.core.build import (HNSWIndex, build_hnsw, build_nsg,
                                    exact_knn, insert_points,
                                    normalize_rows, repair_deleted)
from repro_torch.core.distributed import (SearchMesh, check_mesh_device,
                                          make_search_mesh,
                                          walker_sharded_search)
from repro_torch.core.graph import (PaddedCSR, _flatten_top, compute_medoid,
                                    group_by_indegree, remap_sentinels)
from repro_torch.core.queue import _sort_by
from repro_torch.core.speedann import search_speedann_batch
from repro_torch import ranks as rank_mod
from repro_torch.device import resolve_device
from repro_torch.quant import codec as quant_codec
from repro_torch.quant.scheme import required_quant_dtype

_SAVE_FORMAT = 3


class SearchResult(NamedTuple):
    """One batched search: ids/dists (B, k) + per-query SearchStats."""
    ids: torch.Tensor
    dists: torch.Tensor
    stats: object


def default_search_mesh(device) -> SearchMesh:
    """The mesh of the "sharded" algorithm when the caller gives none: the
    reference's default (1, n_devices).  With a process group up
    (``ranks.init_ranks``) it is (1, world) over the ranks, one walker a
    rank (every rank makes it the first time it searches); otherwise the
    (1, 1) mesh on ``device``: one walker, the same code path."""
    if not rank_mod.is_up():
        return make_search_mesh((1, 1), ("data", "model"), device=device)
    state = rank_mod._STATE
    if state["search_mesh"] is None:
        world = rank_mod.world()
        state["search_mesh"] = make_search_mesh(
            (1, world), ("data", "model"), ranks=(1, world))
    return state["search_mesh"]


def normalize_queries(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalize a (B, d) query batch (cosine = ip on the sphere)."""
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=1e-12)


def remap_result_ids(ids: torch.Tensor, old_from_new: torch.Tensor,
                     n_nodes: int) -> torch.Tensor:
    """Map grouped (relabelled) result ids back to the caller's original
    ids; sentinel/invalid ids (>= n_nodes) pass through unchanged."""
    safe = ids.long().clamp(max=n_nodes - 1)
    return torch.where(ids < n_nodes, old_from_new[safe], ids)


def exact_rerank(graph: PaddedCSR, q: torch.Tensor, ids: torch.Tensor,
                 k: int, metric: str):
    """Exactly re-rank a (B, P) candidate pool against the float32 vectors
    and return the top k (internal id space; sentinels re-rank to +inf;
    ties break on id)."""
    n = graph.n_nodes
    vecs = graph.vectors[ids.long().clamp(max=n - 1)].float()  # (B, P, d)
    qf = q.float()[:, None, :]
    if metric in ("ip", "cosine"):
        d = -torch.sum(vecs * qf, dim=-1)
    else:
        d = torch.sum((vecs - qf) ** 2, dim=-1)
    d = torch.where(ids < n, d, float("inf"))
    d, ids = _sort_by(d, ids.to(torch.int32))
    return ids[:, :k], d[:, :k]


def apply_entry_policy(graph: PaddedCSR, spec: IndexSpec) -> PaddedCSR:
    """Build-time traversal-entry selection (``IndexSpec.entry_policy``):
    ``"max_norm"`` replaces the medoid with the max-norm vertex (the MIPS
    seed heuristic; first of equal norms), computed on the stored vectors
    so the entry is in internal id space."""
    if spec.entry_policy != "max_norm":
        return graph
    norms = torch.linalg.vector_norm(graph.vectors.float(), dim=1)
    return graph._replace(medoid=torch.argmax(norms).to(torch.int32))


def quantize_graph(graph: PaddedCSR, quant) -> PaddedCSR:
    """Attach a trained quantized table (codes + scales) to a graph, on the
    graph's device.

    Scales are calibrated on the STORED vectors, so ``codes[i]`` encodes
    ``vectors[i]``.  With ``keep_float=False`` the exact f32 table is
    dropped here: ``vectors`` (and the flattened hot-vertex blocks) become
    the dequantized codes, so an in-memory index and its save/load round
    trip search alike."""
    if not quant.enabled:
        return graph
    scales = quant_codec.fit_scales(graph.vectors, quant)
    codes = quant_codec.quantize(graph.vectors, quant, scales)
    graph = graph._replace(codes=codes, scales=scales.float())
    if not quant.keep_float:
        vectors = quant_codec.dequantize(codes, quant, graph.scales)
        flat = graph.flat
        if graph.n_top > 0:
            flat = _flatten_top(graph.nbrs, vectors, graph.n_top)
        graph = graph._replace(vectors=vectors, flat=flat)
    return graph


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class AnnIndex:
    """A built similarity-graph index + its :class:`IndexSpec`, on one
    device.  Construct with :meth:`build`, :meth:`load` or
    :meth:`from_arrays`."""

    def __init__(self, spec: IndexSpec, graph: PaddedCSR,
                 hnsw: Optional[HNSWIndex] = None,
                 old_from_new: Optional[np.ndarray] = None,
                 tombstone: Optional[np.ndarray] = None):
        self.spec = spec
        self.graph = graph
        # the upper levels of an hnsw index (its base is ``graph``)
        self.hnsw = hnsw
        self._set_maps(old_from_new, tombstone)

    def _set_maps(self, old_from_new, tombstone) -> None:
        """Host copies of the grouping remap and the tombstones, their
        tensors on the graph's device, and no cached searcher."""
        self.old_from_new = (None if old_from_new is None
                             else np.asarray(old_from_new, np.int64))
        self.tombstone = (None if tombstone is None
                          else np.asarray(tombstone, bool))
        dev = self.graph.device
        self._ofn = (None if self.old_from_new is None else
                     torch.from_numpy(self.old_from_new).to(dev, torch.int32))
        self._tomb = (None if self.tombstone is None else
                      torch.from_numpy(self.tombstone).to(dev))
        self._searcher_cache: Dict = {}

    # -- introspection -----------------------------------------------------

    @property
    def n_nodes(self) -> int:
        return self.graph.n_nodes

    @property
    def dim(self) -> int:
        return self.graph.dim

    @property
    def metric(self) -> str:
        return self.spec.metric

    @property
    def n_alive(self) -> int:
        """Live (non-tombstoned) vertex count."""
        dead = 0 if self.tombstone is None else int(self.tombstone.sum())
        return self.n_nodes - dead

    @property
    def device(self) -> torch.device:
        return self.graph.device

    @property
    def device_bytes(self) -> int:
        """Bytes of the index's tensors (graph, remap, tombstones)."""
        ts = [t for t in self.graph if isinstance(t, torch.Tensor)]
        ts += [t for t in (self._ofn, self._tomb) if t is not None]
        return sum(t.numel() * t.element_size() for t in ts)

    def __repr__(self) -> str:
        return (f"AnnIndex(builder={self.spec.builder!r}, "
                f"metric={self.spec.metric!r}, n={self.n_nodes}, "
                f"d={self.dim}, degree={self.graph.degree}, "
                f"device={self.device})")

    # -- build -------------------------------------------------------------

    @classmethod
    def build(cls, data, spec: IndexSpec = IndexSpec(),
              device=None) -> "AnnIndex":
        """Build an index over ``data`` ((N, d) array or tensor, or anything
        with a ``.base`` attribute such as a dataset) on ``device`` (default
        CUDA).  For ``metric="cosine"`` the base vectors are unit-normalized
        and stored normalized; queries are normalized at search time."""
        rank_mod.refuse_counting("AnnIndex.build")
        if not isinstance(data, (np.ndarray, torch.Tensor)) \
                and getattr(data, "base", None) is not None:
            data = data.base
        dev = resolve_device(device)
        x = (data if isinstance(data, torch.Tensor) else torch.from_numpy(
            np.asarray(data, np.float32))).to(dev, torch.float32)
        if x.dim() != 2:
            raise ValueError(f"data must be (N, d), got {tuple(x.shape)}")
        if spec.metric == "cosine":
            x = normalize_rows(x)
        build_metric = "l2" if spec.metric == "cosine" else spec.metric

        if spec.builder == "hnsw":
            hnsw = build_hnsw(x, degree=spec.degree,
                              upper_degree=spec.upper_degree,
                              seed=spec.seed, alpha=spec.alpha,
                              metric=build_metric,
                              build_batch=spec.build_batch,
                              build_backend=spec.build_backend, device=dev)
            base = apply_entry_policy(
                quantize_graph(hnsw.base, spec.quant), spec)
            return cls(spec, base, hnsw=hnsw._replace(base=base))

        graph = build_nsg(x, degree=spec.degree,
                          knn_k=spec.resolved_knn_k, alpha=spec.alpha,
                          ef_construction=spec.resolved_ef, seed=spec.seed,
                          passes=spec.passes, metric=build_metric,
                          build_batch=spec.build_batch,
                          build_backend=spec.build_backend, device=dev)
        old_from_new = None
        if spec.n_top_fraction > 0:
            graph, ofn = group_by_indegree(
                graph.nbrs, graph.vectors, medoid=int(graph.medoid),
                top_fraction=spec.n_top_fraction)
            old_from_new = _host(ofn)
        graph = apply_entry_policy(quantize_graph(graph, spec.quant), spec)
        return cls(spec, graph, old_from_new=old_from_new)

    # -- incremental maintenance -------------------------------------------

    def _build_metric(self) -> str:
        return "l2" if self.spec.metric == "cosine" else self.spec.metric

    def add(self, new_vectors) -> np.ndarray:
        """Insert new vectors into the live index without a rebuild, on the
        index's device: the same batched insertion as construction
        (:func:`repro_torch.core.build.insert_points`) against the live
        graph.  Cosine inputs are normalized here; quantized indices encode
        the new rows (per-vector scales fit per new row, per-dim scales
        reused, so existing codes stay bit-identical); the flattened top
        level is rebuilt.  Returns the assigned ids (original id space)."""
        if self.spec.builder == "hnsw":
            raise NotImplementedError(
                "incremental add() is supported for the nsg builder only "
                "(the hnsw upper levels would need re-sampling)")
        dev = self.device
        new = (new_vectors if isinstance(new_vectors, torch.Tensor)
               else torch.from_numpy(np.asarray(new_vectors, np.float32))
               ).to(dev, torch.float32)
        if new.dim() == 1:
            new = new[None, :]
        if new.dim() != 2 or new.shape[1] != self.dim:
            raise ValueError(f"new vectors must be (K, {self.dim}), got "
                             f"{tuple(new.shape)}")
        if new.shape[0] == 0:
            return np.zeros((0,), np.int64)
        if self.spec.metric == "cosine":
            new = normalize_rows(new)

        spec, quant, g = self.spec, self.spec.quant, self.graph
        n_old = self.n_nodes
        n_new = n_old + new.shape[0]
        # the sentinel changes value with N: rewrite the old rows' padding
        # BEFORE the table grows
        nbrs = torch.full((n_new, g.degree), n_new, dtype=torch.int32,
                          device=dev)
        nbrs[:n_old] = remap_sentinels(g.nbrs, n_old, n_new)
        codes = scales = None
        store_new = new
        if quant.enabled:
            if quant.dtype == "int8" and not quant.per_dim:
                s_new = quant_codec.fit_scales(new, quant)
                scales = torch.cat([g.scales, s_new.float()])
            else:
                s_new = scales = g.scales
            c_new = quant_codec.quantize(new, quant, s_new)
            codes = torch.cat([g.codes, c_new])
            if not quant.keep_float:
                store_new = quant_codec.dequantize(c_new, quant, s_new)
        vectors = torch.cat([g.vectors.float(), store_new])
        new_ids = np.arange(n_old, n_new, dtype=np.int64)
        insert_points(
            nbrs, vectors, int(g.medoid), new_ids, n_old,
            degree=spec.degree, alpha=spec.alpha, ef=spec.resolved_ef,
            metric=self._build_metric(), build_batch=spec.build_batch,
            build_backend=spec.build_backend)
        self.graph = apply_entry_policy(PaddedCSR(
            nbrs=nbrs, vectors=vectors, medoid=g.medoid, n_top=g.n_top,
            flat=_flatten_top(nbrs, vectors, g.n_top), codes=codes,
            scales=scales), spec)
        ofn = (None if self.old_from_new is None else
               np.concatenate([self.old_from_new, new_ids]))
        tomb = (None if self.tombstone is None else np.concatenate(
            [self.tombstone, np.zeros(new_ids.shape[0], bool)]))
        self._set_maps(ofn, tomb)
        return new_ids

    def delete(self, ids) -> int:
        """Tombstone vertices and repair their neighborhoods in place, on
        the index's device (:func:`repro_torch.core.build.repair_deleted`).
        Tombstoned rows stay navigable; every search and ``exact`` masks
        them.  Returns the number of newly deleted vertices; already-deleted
        and duplicate ids are ignored; deleting every remaining vertex is
        refused.  A deleted entry vertex is re-elected among survivors."""
        if self.spec.builder == "hnsw":
            raise NotImplementedError(
                "incremental delete() is supported for the nsg builder only")
        ids = np.unique(np.asarray(ids, np.int64).ravel())
        if ids.shape[0] == 0:
            return 0
        n = self.n_nodes
        if self.old_from_new is not None:
            # callers speak original ids; tombstones live in internal space
            new_from_old = np.empty(self.old_from_new.shape[0], np.int64)
            new_from_old[self.old_from_new] = np.arange(
                self.old_from_new.shape[0])
            if ids[0] < 0 or ids[-1] >= new_from_old.shape[0]:
                raise ValueError(f"ids out of range [0, "
                                 f"{new_from_old.shape[0]})")
            internal = new_from_old[ids]
        else:
            if ids[0] < 0 or ids[-1] >= n:
                raise ValueError(f"ids out of range [0, {n})")
            internal = ids
        tomb = (self.tombstone.copy() if self.tombstone is not None
                else np.zeros(n, bool))
        fresh = internal[~tomb[internal]]
        if fresh.shape[0] == 0:
            return 0
        if int(tomb.sum()) + fresh.shape[0] >= n:
            raise ValueError("delete() would tombstone every vertex; "
                             "drop the index instead")
        tomb[fresh] = True

        spec, g = self.spec, self.graph
        nbrs = g.nbrs.clone()
        vectors = g.vectors.float()
        repair_deleted(nbrs, vectors, tomb, degree=spec.degree,
                       alpha=spec.alpha, metric=self._build_metric())
        medoid = g.medoid
        if tomb[int(medoid)]:
            # the entry vertex died: re-elect among survivors (the row
            # itself stays a navigable waypoint)
            if spec.entry_policy == "max_norm":
                norms = torch.linalg.vector_norm(vectors, dim=1)
                dead = torch.from_numpy(tomb).to(norms.device)
                best = torch.argmax(torch.where(dead, -float("inf"), norms))
            else:
                best = compute_medoid(vectors, metric=self._build_metric(),
                                      alive=~tomb)
            medoid = torch.tensor(int(best), dtype=torch.int32,
                                  device=self.device)
        self.graph = g._replace(nbrs=nbrs, medoid=medoid,
                                flat=_flatten_top(nbrs, g.vectors, g.n_top))
        self._set_maps(self.old_from_new, tomb)
        return int(fresh.shape[0])

    # -- serving -----------------------------------------------------------

    def serve(self, params: SearchParams = SearchParams(), *, mesh=None,
              obs=None, **engine_kw):
        """A bucketed :class:`repro_torch.serve.AnnEngine` over this index,
        on its device (``engine_kw`` forwards e.g. ``bucket_sizes``).

        The engine serves the single-device algorithms (bfis | topm |
        speedann) and, with ``SearchParams(algorithm="sharded")``, the
        walker-sharded path: one Speed-ANN walker per position along
        ``mesh``'s ``model`` axis, every position on the index's device
        (``mesh=None``: the default (1, 1) mesh).  ``obs`` takes a
        :class:`repro_torch.obs.Observability` bundle for request-scoped
        tracing and convergence telemetry (None: the no-op ``NULL_OBS``)."""
        from repro_torch.serve.ann_engine import AnnEngine
        return AnnEngine(self, params, mesh=mesh, obs=obs, **engine_kw)

    def serve_async(self, params: SearchParams = SearchParams(), *,
                    max_batch: Optional[int] = None,
                    max_wait_ms: float = 2.0,
                    default_deadline_ms: Optional[float] = None,
                    mesh=None, start: bool = True, obs=None,
                    cache=None, admission=None, clock=None, **engine_kw):
        """An async coalescing front-end (:class:`repro_torch.serve.
        AsyncAnnEngine`) over :meth:`serve`: single queries with
        per-request deadlines in, bucketed batches through the engine,
        per-request futures back.

        ``max_batch`` defaults to the engine's top bucket.  The wrapped
        batched engine stays reachable as ``.engine``; the coalescer
        inherits its ``obs``.  ``cache`` (a ``CachePolicy`` or a ready
        ``ResultCache``), ``admission`` (an ``AdmissionPolicy`` or an
        ``AdmissionController``) and ``clock`` (a virtual clock for
        deterministic tests, with ``start=False``) pass straight through.
        """
        from repro_torch.serve.coalescer import AsyncAnnEngine, CoalescePolicy
        engine = self.serve(params, mesh=mesh, obs=obs, **engine_kw)
        policy = CoalescePolicy(
            max_batch=max_batch if max_batch is not None
            else engine.bucket_sizes[-1],
            max_wait_ms=max_wait_ms,
            default_deadline_ms=default_deadline_ms)
        return AsyncAnnEngine(engine, policy, start=start, cache=cache,
                              admission=admission, clock=clock)

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> str:
        """Write the reference's npz layout; returns the path written."""
        path = str(path)
        if not path.endswith(".npz"):
            path += ".npz"
        quant = self.spec.quant
        # default-valued newer spec fields are stripped from the json, as
        # the reference does, so older readers load the file
        has_tomb = self.tombstone is not None and bool(self.tombstone.any())
        fmt = 1
        if self.graph.codes is not None:
            fmt = 2
        if has_tomb:
            fmt = _SAVE_FORMAT
        spec_dict = dataclasses.asdict(self.spec)
        if not quant.enabled:
            del spec_dict["quant"]
        if self.spec.entry_policy == "medoid":
            del spec_dict["entry_policy"]
        if self.spec.build_batch == 32:
            del spec_dict["build_batch"]
        if self.spec.build_backend == "ref":
            del spec_dict["build_backend"]
        arrays = dict(
            format=np.int64(fmt),
            spec=np.asarray(json.dumps(spec_dict)),
            nbrs=_host(self.graph.nbrs),
            medoid=np.asarray(int(self.graph.medoid), np.int32),
            n_top=np.int64(self.graph.n_top),
            flat=_host(self.graph.flat),
        )
        if not quant.enabled or quant.keep_float:
            arrays["vectors"] = _host(self.graph.vectors)
        if self.graph.codes is not None:
            codes = self.graph.codes
            if codes.dtype == torch.bfloat16:
                # npz has no bfloat16 descr; persist the raw bit pattern
                arrays["codes"] = _host(codes.view(torch.int16)).view(np.uint16)
            else:
                arrays["codes"] = _host(codes)
            arrays["scales"] = _host(self.graph.scales.float())
        if self.old_from_new is not None:
            arrays["old_from_new"] = self.old_from_new
        if has_tomb:
            arrays["tombstone"] = self.tombstone
        if self.hnsw is not None:
            arrays["hnsw_entry"] = np.int64(self.hnsw.entry)
            arrays["hnsw_num_levels"] = np.int64(len(self.hnsw.level_nbrs))
            for i, (ln, nn) in enumerate(zip(self.hnsw.level_nbrs,
                                             self.hnsw.level_nodes)):
                arrays[f"hnsw_level_nbrs_{i}"] = _host(ln)
                arrays[f"hnsw_level_nodes_{i}"] = _host(nn)
        np.savez(path, **arrays)
        return path

    @classmethod
    def from_arrays(cls, arrays: Mapping[str, np.ndarray],
                    device=None) -> "AnnIndex":
        """An index from the arrays ``repro``'s ``AnnIndex.save`` writes
        (``format``, ``spec``, ``nbrs``, ``vectors``, ``medoid``, ``n_top``,
        ``flat``; optional ``codes``/``scales``, ``old_from_new``,
        ``tombstone``, ``hnsw_*``), on ``device`` (default CUDA)."""
        dev = resolve_device(device)
        fmt = int(arrays["format"])
        if fmt > _SAVE_FORMAT:
            raise ValueError(f"index file format {fmt} is newer than this "
                             f"code ({_SAVE_FORMAT})")
        spec = IndexSpec(**json.loads(str(arrays["spec"])))

        def up(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.to(device=dev, dtype=dtype or t.dtype)

        codes = scales = None
        if "codes" in arrays:
            raw = np.asarray(arrays["codes"])
            if spec.quant.dtype == "bf16":
                codes = up(raw.view(np.int16)).view(torch.bfloat16)
            else:
                codes = up(raw)
            scales = up(np.asarray(arrays["scales"], np.float32))
        if "vectors" in arrays:
            vectors = up(arrays["vectors"])
        else:
            # keep_float=False file: the f32 table is the dequantized codes
            # (exact() and re-ranking read the quantized values)
            vectors = quant_codec.dequantize(codes, spec.quant, scales)
        graph = PaddedCSR(
            nbrs=up(arrays["nbrs"], torch.int32),
            vectors=vectors,
            medoid=torch.tensor(int(arrays["medoid"]), dtype=torch.int32,
                                device=dev),
            n_top=int(arrays["n_top"]),
            flat=up(arrays["flat"]),
            codes=codes,
            scales=scales,
        )
        hnsw = None
        if "hnsw_entry" in arrays:
            n_levels = int(arrays["hnsw_num_levels"])
            hnsw = HNSWIndex(
                base=graph,
                level_nbrs=tuple(up(arrays[f"hnsw_level_nbrs_{i}"])
                                 for i in range(n_levels)),
                level_nodes=tuple(up(arrays[f"hnsw_level_nodes_{i}"])
                                  for i in range(n_levels)),
                entry=int(arrays["hnsw_entry"]))
        old_from_new = (np.asarray(arrays["old_from_new"])
                        if "old_from_new" in arrays else None)
        tombstone = (np.asarray(arrays["tombstone"], bool)
                     if "tombstone" in arrays else None)
        return cls(spec, graph, hnsw=hnsw, old_from_new=old_from_new,
                   tombstone=tombstone)

    @classmethod
    def load(cls, path: str, device=None) -> "AnnIndex":
        """``np.load`` + :meth:`from_arrays` (default device CUDA)."""
        path = str(path)
        if not path.endswith(".npz"):
            path += ".npz"
        with np.load(path, allow_pickle=False) as z:
            return cls.from_arrays({k: z[k] for k in z.files}, device=device)

    # -- search ------------------------------------------------------------

    def searcher(self, params: SearchParams = SearchParams(), *,
                 mesh: Optional[SearchMesh] = None):
        """A batched callable ``fn(queries (B, d)) -> SearchResult`` on the
        index's device, cached per (params, mesh).  ``mesh`` is read by the
        "sharded" algorithm only (None: :func:`default_search_mesh`); its
        positions must sit on the index's device."""
        rank_mod.refuse_counting("AnnIndex.searcher")
        key = (params, id(mesh) if mesh is not None else None)
        cached = self._searcher_cache.get(key)
        if cached is not None:
            return cached
        need = required_quant_dtype(params.backend)
        if need != "none" and self.spec.quant.dtype != need:
            raise ValueError(
                f"backend {params.backend!r} reads a {need} codes table; "
                f"this index has quant={self.spec.quant.dtype!r} — rebuild "
                f"with IndexSpec(quant={need!r}) or pick a matching backend")
        algorithm = params.algorithm
        hnsw = self.hnsw
        if algorithm == "sharded":
            if need != "none":
                raise ValueError(
                    "quantized backends are not wired into the sharded "
                    "walker path; use a single-host algorithm "
                    "(bfis | topm | speedann) with backend "
                    f"{params.backend!r}")
            the_mesh = (mesh if mesh is not None
                        else default_search_mesh(self.device))
            check_mesh_device(the_mesh, self.device)

            def run(g, q, cfg):
                return walker_sharded_search(g, q, cfg, the_mesh)
        elif algorithm == "bfis" and hnsw is not None:
            # greedy upper-level descent, then Algorithm 1 at level 0
            def run(g, q, cfg):
                return hnsw_search_batch(hnsw._replace(base=g), q, cfg)
        else:
            run = {"bfis": bfis_search_batch, "topm": search_topm_batch,
                   "speedann": search_speedann_batch}[algorithm]

        metric = self.spec.metric
        cfg = params.to_search_config(metric)
        k, rerank_k = params.k, params.rerank_k
        if rerank_k > 0:
            # stage 1 traverses over a pool widened to max(k, rerank_k);
            # stage 2 re-ranks that pool exactly against the f32 vectors
            pool = max(k, rerank_k)
            cfg = cfg.with_(k=pool, queue_len=max(cfg.queue_len, pool))
        has_tomb = self.tombstone is not None and bool(self.tombstone.any())
        graph, ofn, tomb = self.graph, self._ofn, self._tomb
        n_nodes = graph.n_nodes

        def fn(queries) -> SearchResult:
            q = torch.as_tensor(queries)
            if q.dim() != 2:
                raise ValueError(f"queries must be (B, d), got "
                                 f"{tuple(q.shape)}")
            q = q.to(torch.float32).to(graph.device).contiguous()
            if metric == "cosine":
                q = normalize_queries(q)
            ids, dists, stats = run(graph, q, cfg)
            if has_tomb:
                # tombstoned vertices are waypoints, never answers: mask
                # them to the sentinel and stable-sort live results first,
                # before re-ranking and the grouping remap
                dead = tomb[ids.long().clamp(max=n_nodes - 1)] \
                    & (ids < n_nodes)
                dists = torch.where(dead, float("inf"), dists)
                ids = torch.where(dead, n_nodes, ids).to(torch.int32)
                if rerank_k == 0:
                    dists, ids = _sort_by(dists, ids)
            if rerank_k > 0:
                ids, dists = exact_rerank(graph, q, ids, k, metric)
            if ofn is not None:
                ids = remap_result_ids(ids, ofn, n_nodes)
            return SearchResult(ids, dists, stats)

        self._searcher_cache[key] = fn
        return fn

    def search(self, queries, params: SearchParams = SearchParams(), *,
               mesh: Optional[SearchMesh] = None) -> SearchResult:
        """Search a (B, d) query batch with ``params.algorithm`` (the
        walker-sharded path on ``mesh`` for "sharded")."""
        return self.searcher(params, mesh=mesh)(queries)

    # -- ground truth ------------------------------------------------------

    def exact(self, queries, k: int):
        """Metric-aware exact kNN over the indexed vectors (brute force on
        the index's device) — the recall reference.  Returns (ids, dists)
        tensors in the caller's original id space."""
        q = np.asarray(queries.cpu() if isinstance(queries, torch.Tensor)
                       else queries, np.float32)
        metric = self.spec.metric
        if metric == "cosine":
            q = q / np.maximum(
                np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
            metric = "ip"
        q = torch.from_numpy(q).to(self.device)
        has_tomb = self.tombstone is not None and bool(self.tombstone.any())
        if has_tomb:
            # over-fetch so k live results survive the tombstone filter
            kk = min(k + int(self.tombstone.sum()), self.n_nodes)
            ids, dists = exact_knn(self.graph.vectors, q, kk, metric=metric)
            dead = self._tomb[ids.long()]
            order = torch.sort(dead.to(torch.uint8), dim=1,
                               stable=True).indices
            ids = ids.gather(1, order)[:, :k]
            dists = dists.gather(1, order)[:, :k]
        else:
            ids, dists = exact_knn(self.graph.vectors, q, k, metric=metric)
        if self._ofn is not None:
            ids = self._ofn[ids.long()]
        return ids, dists
