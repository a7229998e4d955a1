"""``AnnIndex`` — the port's public API for vector search.

Port of ``repro.ann.index`` for the search path::

    from repro_torch.ann import AnnIndex, SearchParams

    index = AnnIndex.load("idx.npz")                  # on the CUDA device
    res = index.search(queries, SearchParams(algorithm="speedann", m_max=8,
                                             backend="rowgather"))

``load``/``from_arrays``/``save`` read and write the reference's npz layout
(formats 1–3), so an index built by ``repro`` searches here unchanged and
files round-trip both ways.  The search runs every algorithm of the
single-device path (bfis | topm | speedann) over every distance backend and
metric, with cosine query normalization, the tombstone mask, exact
re-ranking and the neighbor-grouping id remap, in the reference's order.

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
from repro_torch.core.bfis import bfis_search_batch, search_topm_batch
from repro_torch.core.build import exact_knn
from repro_torch.core.graph import PaddedCSR, _flatten_top
from repro_torch.core.queue import _sort_by
from repro_torch.core.speedann import search_speedann_batch
from repro_torch.device import resolve_device
from repro_torch.quant import codec as quant_codec
from repro_torch.quant.scheme import required_quant_dtype

_SAVE_FORMAT = 3

_NOT_PORTED = ("not ported to repro_torch yet (ROADMAP.md, 'Modules to "
               "port', item {})")


class SearchResult(NamedTuple):
    """One batched search: ids/dists (B, k) + per-query SearchStats."""
    ids: torch.Tensor
    dists: torch.Tensor
    stats: object


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
    device.  Construct with :meth:`load` or :meth:`from_arrays`."""

    def __init__(self, spec: IndexSpec, graph: PaddedCSR,
                 hnsw_arrays: Optional[Mapping[str, np.ndarray]] = None,
                 old_from_new: Optional[np.ndarray] = None,
                 tombstone: Optional[np.ndarray] = None):
        self.spec = spec
        self.graph = graph
        # the hnsw_* arrays of a file, kept so save() writes them back; the
        # hnsw descent itself is not ported yet
        self.hnsw_arrays = dict(hnsw_arrays) if hnsw_arrays else None
        self.old_from_new = (None if old_from_new is None
                             else np.asarray(old_from_new, np.int64))
        self.tombstone = (None if tombstone is None
                          else np.asarray(tombstone, bool))
        dev = graph.device
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

    # -- not ported yet ----------------------------------------------------

    @classmethod
    def build(cls, data, spec: IndexSpec = IndexSpec()):
        raise NotImplementedError("AnnIndex.build: " + _NOT_PORTED.format(8))

    def add(self, new_vectors):
        raise NotImplementedError("AnnIndex.add: " + _NOT_PORTED.format(8))

    def delete(self, ids):
        raise NotImplementedError("AnnIndex.delete: " + _NOT_PORTED.format(8))

    def serve(self, *args, **kw):
        raise NotImplementedError("AnnIndex.serve: " + _NOT_PORTED.format(7))

    def serve_async(self, *args, **kw):
        raise NotImplementedError(
            "AnnIndex.serve_async: " + _NOT_PORTED.format(7))

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
        if self.hnsw_arrays:
            arrays.update(self.hnsw_arrays)
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
        hnsw = {k: np.asarray(arrays[k]) for k in arrays
                if k.startswith("hnsw_")}
        old_from_new = (np.asarray(arrays["old_from_new"])
                        if "old_from_new" in arrays else None)
        tombstone = (np.asarray(arrays["tombstone"], bool)
                     if "tombstone" in arrays else None)
        return cls(spec, graph, hnsw_arrays=hnsw or None,
                   old_from_new=old_from_new, tombstone=tombstone)

    @classmethod
    def load(cls, path: str, device=None) -> "AnnIndex":
        """``np.load`` + :meth:`from_arrays` (default device CUDA)."""
        path = str(path)
        if not path.endswith(".npz"):
            path += ".npz"
        with np.load(path, allow_pickle=False) as z:
            return cls.from_arrays({k: z[k] for k in z.files}, device=device)

    # -- search ------------------------------------------------------------

    def searcher(self, params: SearchParams = SearchParams()):
        """A batched callable ``fn(queries (B, d)) -> SearchResult`` on the
        index's device, cached per params."""
        cached = self._searcher_cache.get(params)
        if cached is not None:
            return cached
        need = required_quant_dtype(params.backend)
        if need != "none" and self.spec.quant.dtype != need:
            raise ValueError(
                f"backend {params.backend!r} reads a {need} codes table; "
                f"this index has quant={self.spec.quant.dtype!r} — rebuild "
                f"with IndexSpec(quant={need!r}) or pick a matching backend")
        algorithm = params.algorithm
        if algorithm == "sharded":
            raise NotImplementedError(
                "algorithm='sharded': " + _NOT_PORTED.format(9))
        if algorithm == "bfis" and self.hnsw_arrays:
            raise NotImplementedError(
                "algorithm='bfis' on an hnsw index (hnsw_search_batch): "
                + _NOT_PORTED.format(5))
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

        self._searcher_cache[params] = fn
        return fn

    def search(self, queries,
               params: SearchParams = SearchParams()) -> SearchResult:
        """Search a (B, d) query batch with ``params.algorithm``."""
        return self.searcher(params)(queries)

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
