"""Batched ANN serving engine: a bucket ladder over the index's searchers.

Port of ``repro.serve.ann_engine`` in its ``single`` mode.  Online traffic
arrives as variable-size query batches.  The engine quantizes each batch
to a fixed ladder of *buckets* (powers of two by default), pads it up to
the bucket with replicas of its first query, and serves it through the
bucket's entry; batches larger than the top bucket are served in
top-bucket chunks.  The reference does this so that jit compiles one
executable per bucket.  The port has no compile step, but keeps the ladder
as it is, so that padding, the per-bucket latency sketches, the cache
counters and the batch-relative ``SearchStats`` (``uniq_comps``/
``batch_dup_comps``) are the reference's for the same traffic.

A bucket's entry is the searcher that serves it.  On the facade path
(``AnnEngine(AnnIndex, SearchParams)`` or ``index.serve(params)``) every
bucket shares the index's one cached searcher (``AnnIndex.searcher``), as
the reference's facade path does, and so inherits the metric handling,
tombstones, quantized backends, re-ranking and the grouping remap.  The
legacy ``(PaddedCSR, SearchConfig)`` form builds one closure per bucket
over the graph, the resolved distance backend and the algorithm (bfis on
an hnsw :class:`~repro_torch.ann.AnnIndex` enters through the upper-level
descent).  The traversal loops end every step on a host sync, so a bucket
is not captured as a CUDA graph.

Queries enter as numpy or a tensor and go to the index's device; the
padded chunk is built there; results come back to the host as numpy.  The
sharded and corpus modes of the reference are not ported: a
``ShardedIndex``, ``algorithm="sharded"`` or a ``mesh`` raises
``NotImplementedError`` naming their ROADMAP item.

Typical use::

    engine = AnnIndex.load(path).serve(params)
    engine.warmup()                     # one search per bucket up front
    res = engine.search(queries)        # (B, d) for any B
    print(engine.stats())               # recall / latency / cache counters
"""
from __future__ import annotations

import threading
import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.ann.index import (_DISTRIBUTION_ITEM, _NOT_PORTED, AnnIndex,
                                   normalize_queries, remap_result_ids)
from repro_torch.ann.spec import SearchParams
from repro_torch.core.bfis import (DistFn, bfis_search_batch,
                                   hnsw_search_batch, resolve_dist_fn,
                                   search_topm_batch)
from repro_torch.core.config import SearchConfig
from repro_torch.core.metrics import (SearchStats, recall_at_k,
                                      telemetry_per_lane)
from repro_torch.core.speedann import search_speedann_batch
from repro_torch.obs import (NULL_OBS, LogHistogram, Observability,
                             device_annotation)

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

#: Relative error of every latency percentile the engine reports (the
#: samples land in a bounded log-bucketed sketch, ``LogHistogram``).
LATENCY_REL_ERR = 0.01

_ALGORITHMS = {
    "speedann": search_speedann_batch,
    "topm": search_topm_batch,
    "bfis": bfis_search_batch,
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: " + _NOT_PORTED.format(_DISTRIBUTION_ITEM))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeResult(NamedTuple):
    """One served request: results sliced back to the request's true size,
    on the host."""
    ids: np.ndarray          # (B, k) int32
    dists: np.ndarray        # (B, k) float32
    stats: SearchStats       # per-query counters, numpy leaves shaped (B,)
    latency_ms: float        # wall clock for this request (all chunks)
    buckets: Tuple[int, ...]  # bucket(s) the request was quantized to


class AnnEngine:
    """Bucketed batched ANN serving on a fixed index, on its device."""

    def __init__(
        self,
        graph,
        cfg: SearchConfig,
        *,
        algorithm: Optional[str] = None,
        bucket_sizes: Sequence[int] = DEFAULT_BUCKETS,
        dist_fn: Optional[DistFn] = None,
        mesh=None,
        metric: Optional[str] = None,
        obs: Optional[Observability] = None,
    ):
        if mesh is not None:
            raise _not_ported("AnnEngine(mesh=...)")
        if hasattr(graph, "num_shards"):
            raise _not_ported("AnnEngine(ShardedIndex)")
        self.obs = obs if obs is not None else NULL_OBS
        self.index: Optional[AnnIndex] = None
        self.mesh = None
        self.mode = "single"
        self._normalize = False
        ofn = None
        if isinstance(graph, AnnIndex):
            self.index = graph
            graph = self.index.graph
            self._normalize = self.index.spec.metric == "cosine"
            ofn = self.index._ofn
        metric = self.index.spec.metric if self.index is not None else metric
        self.params: Optional[SearchParams] = None
        if isinstance(cfg, SearchParams):
            if algorithm is None:
                algorithm = cfg.algorithm
            if self.index is not None and dist_fn is None:
                # facade path: serve through the index's own searcher
                self.params = cfg.with_(algorithm=algorithm)
            elif cfg.rerank_k > 0:
                # the two-stage re-rank lives in the facade searcher
                raise ValueError(
                    "rerank_k needs the facade serving path: construct the "
                    "engine as AnnEngine(AnnIndex, SearchParams) / "
                    "index.serve(params) without a custom dist_fn")
            cfg = cfg.to_search_config(metric or "l2")
        elif metric is not None and cfg.metric != metric:
            # the index's metric is authoritative over a hand-built config
            cfg = cfg.with_(metric=metric)
        if algorithm is None:
            algorithm = "speedann"
        if algorithm == "sharded":
            raise _not_ported("algorithm='sharded'")
        if algorithm not in _ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {algorithm!r}; one of "
                f"{tuple(_ALGORITHMS)}")
        self.graph = graph
        self.cfg = cfg
        self.algorithm = algorithm
        self.device = graph.device
        self._ofn = ofn
        self._dist_fn = self._search = None
        if self.params is None:
            # legacy pipeline only: the facade path serves through
            # index.searcher and never touches these
            self._dist_fn = resolve_dist_fn(cfg, dist_fn)
            self._search = _ALGORITHMS[algorithm]
            if (algorithm == "bfis" and self.index is not None
                    and self.index.hnsw is not None):
                # as AnnIndex.search: bfis on an hnsw-built index enters
                # via the greedy upper-level descent, not the base medoid
                hnsw = self.index.hnsw

                def _hnsw_bfis(g, q, c, dist_fn=None):
                    return hnsw_search_batch(hnsw._replace(base=g), q, c,
                                             dist_fn=dist_fn)
                self._search = _hnsw_bfis
        self._finish_init(bucket_sizes)

    def _finish_init(self, bucket_sizes: Sequence[int]):
        if not bucket_sizes:
            raise ValueError("bucket_sizes must be non-empty")
        self.bucket_sizes = tuple(sorted(set(int(b) for b in bucket_sizes)))
        # bucket -> its searcher; "jit cache" keeps the reference's name
        self._jit_cache: Dict[int, object] = {}
        # the counters below are read-modify-written by every request; a
        # router may search one engine from several threads
        self._lock = threading.Lock()
        self.queries_served = 0
        self.requests_served = 0
        self.padded_queries = 0
        self.cache_hits = 0
        self.cache_misses = 0
        # latency distributions in bounded log-bucketed sketches (one
        # global, one per bucket)
        self._latency_hist = LogHistogram(rel_err=LATENCY_REL_ERR)
        self._bucket_hists: Dict[int, LogHistogram] = {}
        # convergence-telemetry label: which distance kernel served
        self._backend_label = str(
            getattr(self.cfg, "dist_backend", None) or "ref")
        self._recall_sum = 0.0
        self._recall_n = 0
        # traversal work totals over served (non-padding) lanes
        self.dist_comps_total = 0
        self.uniq_comps_total = 0
        self.batch_dup_comps_total = 0

    # -- bucket entries ------------------------------------------------------

    @property
    def jit_cache_size(self) -> int:
        """Number of bucket entries — bounded by ``len(bucket_sizes)``."""
        return len(self._jit_cache)

    def _compiled(self, bucket: int):
        """The searcher that serves ``bucket`` (made on first use)."""
        with self._lock:
            fn = self._jit_cache.get(bucket)
            if fn is not None:
                self.cache_hits += 1
                return fn
            self.cache_misses += 1
            if self.params is not None:
                # every bucket shares the index's ONE cached searcher
                fn = self.index.searcher(self.params)
            else:
                fn = self._legacy_searcher()
            self._jit_cache[bucket] = fn
            return fn

    def _legacy_searcher(self):
        search, cfg, dist_fn = self._search, self.cfg, self._dist_fn
        normalize, ofn = self._normalize, self._ofn

        def fn(q):
            g = self.graph
            q = q.to(torch.float32)
            if normalize:
                q = normalize_queries(q)
            ids, dists, stats = search(g, q, cfg, dist_fn=dist_fn)
            if ofn is not None:
                ids = remap_result_ids(ids, ofn, g.n_nodes)
            return ids, dists, stats
        return fn

    def bucket_for(self, batch: int) -> int:
        """Smallest bucket >= batch (top bucket for oversize chunks)."""
        for b in self.bucket_sizes:
            if b >= batch:
                return b
        return self.bucket_sizes[-1]

    def warmup(self, dim: Optional[int] = None) -> Dict[int, float]:
        """Run every bucket once up front on zero queries; returns the
        per-bucket seconds (a first search of a fresh process also builds
        the CUDA kernels it launches).

        Warmup does not touch the serving counters, so post-warmup metrics
        reflect real traffic only.
        """
        dim = dim if dim is not None else self.graph.dim
        hits, misses = self.cache_hits, self.cache_misses
        out = {}
        for b in self.bucket_sizes:
            q = torch.zeros((b, dim), dtype=torch.float32,
                            device=self.device)
            t0 = time.perf_counter()
            self._compiled(b)(q)
            _sync(self.device)
            out[b] = time.perf_counter() - t0
        with self._lock:
            self.cache_hits, self.cache_misses = hits, misses
            self._bucket_hists = {}
        return out

    # -- serving -------------------------------------------------------------

    def _run_chunk(self, queries: torch.Tensor, record: bool
                   ) -> Tuple[tuple, int]:
        """Pad one chunk (chunk size <= top bucket) to its bucket and run.

        With ``record`` the chunk is synced and its wall time lands in the
        per-bucket latency distribution.  Multi-chunk requests pass
        ``record=False`` and contribute to the request-level distribution
        only.
        """
        b = queries.shape[0]
        bucket = self.bucket_for(b)
        pad = bucket - b
        if pad:
            # pad with replicas of the first query: real topology, no risk
            # of a degenerate all-zeros search dominating the batch
            queries = torch.cat(
                [queries, queries[:1].expand(pad, queries.shape[1])])
            with self._lock:
                self.padded_queries += pad
        obs = self.obs
        rerank_k = self.params.rerank_k if self.params is not None else 0
        # the rerank pass (params.rerank_k > 0) runs inside the searcher,
        # so it is part of the device_compute span
        with obs.tracer.span("device_compute", cat="engine",
                             args={"bucket": bucket, "pad": pad,
                                   "rerank_k": rerank_k}):
            with device_annotation(f"ann_dispatch/bucket{bucket}",
                                   enabled=obs.profile,
                                   cuda=self.device.type == "cuda"):
                t0 = time.perf_counter()
                ids, dists, stats = self._compiled(bucket)(queries)
                if record:
                    _sync(self.device)
                    ms = (time.perf_counter() - t0) * 1e3
                    with self._lock:
                        hist = self._bucket_hists.get(bucket)
                        if hist is None:
                            hist = self._bucket_hists.setdefault(
                                bucket, LogHistogram(rel_err=LATENCY_REL_ERR))
                    hist.observe(ms)
        out = (ids[:b], dists[:b], torch.stack([t[:b] for t in stats]))
        return out, bucket

    def search(self, queries, gt_ids: Optional[np.ndarray] = None
               ) -> ServeResult:
        """Serve one request of (B, d) queries, any B >= 1.

        With ``gt_ids`` (B, >=k) the engine also folds recall@k into its
        running quality counters.
        """
        if not isinstance(queries, torch.Tensor):
            queries = torch.as_tensor(np.asarray(queries, np.float32))
        queries = queries.to(self.device, torch.float32)
        if queries.dim() != 2 or queries.shape[0] == 0:
            raise ValueError(
                f"queries must be (B, d) with B >= 1, got "
                f"{tuple(queries.shape)}")
        bsz = queries.shape[0]
        top = self.bucket_sizes[-1]
        obs = self.obs

        with obs.tracer.span("engine.search", cat="engine",
                             args={"batch": bsz}) as sp:
            t0 = time.perf_counter()
            chunks, buckets = [], []
            single_chunk = bsz <= top
            for lo in range(0, bsz, top):
                out, bucket = self._run_chunk(queries[lo:lo + top],
                                              record=single_chunk)
                chunks.append(out)
                buckets.append(bucket)
            if not single_chunk:
                _sync(self.device)
            ms = (time.perf_counter() - t0) * 1e3
            sp.add_args(buckets=list(buckets), latency_ms=round(ms, 3))

            with obs.tracer.span("postprocess", cat="engine"):
                ids = np.concatenate([c[0].cpu().numpy() for c in chunks])
                dists = np.concatenate([c[1].cpu().numpy() for c in chunks])
                leaves = np.concatenate([c[2].cpu().numpy() for c in chunks],
                                        axis=1)
                stats = SearchStats(*leaves)
                with self._lock:
                    self.queries_served += bsz
                    self.requests_served += 1
                    self.dist_comps_total += int(np.sum(stats.dist_comps))
                    self.uniq_comps_total += int(np.sum(stats.uniq_comps))
                    self.batch_dup_comps_total += int(
                        np.sum(stats.batch_dup_comps))
                    if gt_ids is not None:
                        self._recall_sum += (
                            recall_at_k(ids, gt_ids, self.cfg.k) * bsz)
                        self._recall_n += bsz
                self._latency_hist.observe(ms)
                if obs.metrics:
                    self._record_telemetry(stats, buckets, ms)
        return ServeResult(ids, dists, stats, ms, tuple(buckets))

    # -- observability -------------------------------------------------------

    def _record_telemetry(self, stats: SearchStats, buckets: Sequence[int],
                          request_ms: float) -> None:
        """Convergence telemetry: per-lane ``SearchStats`` leaves into
        registry histograms, labelled ``{backend, bucket}``.  Only called
        when ``obs.metrics`` is on."""
        reg = self.obs.registry
        bucket = str(buckets[0]) if len(buckets) == 1 else "chunked"
        for field, values in telemetry_per_lane(stats).items():
            child = reg.histogram(
                f"ann_{field}",
                f"per-lane SearchStats.{field} over served queries",
            ).labels(backend=self._backend_label, bucket=bucket)
            for v in values:
                child.observe(v)
        reg.histogram(
            "serve_request_latency_ms",
            "engine wall-clock per request (all chunks)",
        ).labels(backend=self._backend_label).observe(request_ms)

    @staticmethod
    def _hist_summary(h: LogHistogram, prefix: str) -> Dict[str, float]:
        """mean/max exact; p50/p90/p95/p99 within ``LATENCY_REL_ERR``."""
        return {
            f"{prefix}mean_ms": h.mean,
            f"{prefix}p50_ms": h.quantile(0.50),
            f"{prefix}p90_ms": h.quantile(0.90),
            f"{prefix}p95_ms": h.quantile(0.95),
            f"{prefix}p99_ms": h.quantile(0.99),
            f"{prefix}max_ms": h.max,
        }

    def stats(self) -> Dict[str, float]:
        """Traffic and bucket-cache counters and the latency distribution
        (mean, p50/p90/p95/p99, max), globally per request and per bucket
        size (``bucket{b}_*`` keys, single-chunk requests only).

        Key order is the reference's (docs/serving.md): the global counters
        below, the global ``latency_*`` block, per-bucket blocks in
        ascending bucket size (``bucket{b}_chunks`` first within each
        block), then ``recall_at_k`` last when ground truth was supplied."""
        out = {
            "queries_served": float(self.queries_served),
            "requests_served": float(self.requests_served),
            "padded_queries": float(self.padded_queries),
            "jit_cache_size": float(self.jit_cache_size),
            "cache_hits": float(self.cache_hits),
            "cache_misses": float(self.cache_misses),
            "dist_comps_total": float(self.dist_comps_total),
            "uniq_comps_total": float(self.uniq_comps_total),
            "batch_dup_comps_total": float(self.batch_dup_comps_total),
            # share of distance computations whose row gather a batch-dedup
            # backend skips (cross-lane frontier overlap of served traffic)
            "batch_dup_ratio": (
                self.batch_dup_comps_total / self.dist_comps_total
                if self.dist_comps_total else 0.0),
        }
        if self._latency_hist.count:
            out.update(self._hist_summary(self._latency_hist, "latency_"))
        for b in sorted(self._bucket_hists):
            bh = self._bucket_hists[b]
            out[f"bucket{b}_chunks"] = float(bh.count)
            out.update(self._hist_summary(bh, f"bucket{b}_"))
        if self._recall_n:
            out["recall_at_k"] = self._recall_sum / self._recall_n
        return out

    def metrics(self) -> Dict[str, float]:
        """Back-compat alias of :meth:`stats`."""
        return self.stats()

    def latency_histograms(self) -> Dict[str, LogHistogram]:
        """The live sketches behind :meth:`stats` — ``"request"`` plus one
        ``"bucket{b}"`` per served bucket."""
        out: Dict[str, LogHistogram] = {"request": self._latency_hist}
        for b in sorted(self._bucket_hists):
            out[f"bucket{b}"] = self._bucket_hists[b]
        return out
