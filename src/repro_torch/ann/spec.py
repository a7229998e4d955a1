"""Public configuration for the :class:`repro_torch.ann.AnnIndex` facade.

The port's own copy of ``repro.ann.spec``:

* :class:`IndexSpec` — everything fixed at BUILD time and persisted with the
  index (builder, degree/pruning parameters, metric, neighbor-grouping
  fraction, quantization).
* :class:`SearchParams` — everything a caller chooses per query batch (k,
  queue capacity L, expansion width M, walkers, algorithm, distance
  backend).

``SearchParams.to_search_config`` lowers onto the internal
:class:`repro_torch.core.config.SearchConfig`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.core.config import SearchConfig
from repro_torch.quant.scheme import QuantSpec, coerce_quant

BUILDERS = ("nsg", "hnsw")
METRICS = ("l2", "ip", "cosine")
ALGORITHMS = ("bfis", "topm", "speedann", "sharded")
ENTRY_POLICIES = ("medoid", "max_norm")


@dataclass(frozen=True)
class IndexSpec:
    """Index-time configuration, persisted alongside the index arrays."""
    builder: str = "nsg"         # "nsg" | "hnsw"
    metric: str = "l2"           # "l2" | "ip" | "cosine"
    degree: int = 32             # graph out-degree R
    knn_k: int = 0               # kNN-seed width (0 -> degree)
    alpha: float = 1.2           # robust-prune occlusion factor (l2/cosine)
    ef_construction: int = 0     # builder beam width (0 -> 2 * degree)
    passes: int = 2              # NSG refinement passes
    n_top_fraction: float = 0.0  # §4.4 neighbor grouping: fraction of
    #                              hottest vertices whose neighbor embeddings
    #                              are flattened (> 0 relabels vertices)
    upper_degree: int = 16       # HNSW upper-level out-degree
    seed: int = 0
    entry_policy: str = "medoid"  # "medoid" | "max_norm" (metric="ip" only)
    quant: QuantSpec = QuantSpec()  # stored-vector quantization
    build_batch: int = 32        # construction compute tile (throughput only)
    build_backend: str = "ref"   # distance backend for construction searches

    def __post_init__(self):
        object.__setattr__(self, "quant", coerce_quant(self.quant))
        if self.builder not in BUILDERS:
            raise ValueError(
                f"unknown builder {self.builder!r}; one of {BUILDERS}")
        if self.metric not in METRICS:
            raise ValueError(
                f"unknown metric {self.metric!r}; one of {METRICS}")
        if not 0.0 <= self.n_top_fraction <= 1.0:
            raise ValueError("n_top_fraction must be in [0, 1]")
        if self.entry_policy not in ENTRY_POLICIES:
            raise ValueError(
                f"unknown entry_policy {self.entry_policy!r}; one of "
                f"{ENTRY_POLICIES}")
        if self.entry_policy == "max_norm" and self.metric != "ip":
            raise ValueError(
                "entry_policy='max_norm' is the MIPS seed heuristic; it "
                "requires metric='ip' (for l2/cosine the medoid is the "
                "right navigating node)")
        if self.builder == "hnsw" and self.n_top_fraction > 0:
            raise ValueError("neighbor grouping (n_top_fraction) is "
                             "supported for the nsg builder only")
        if self.build_batch < 1:
            raise ValueError("build_batch must be >= 1")

    @property
    def resolved_knn_k(self) -> int:
        return self.knn_k or self.degree

    @property
    def resolved_ef(self) -> int:
        return self.ef_construction or 2 * self.degree

    def with_(self, **kw) -> "IndexSpec":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SearchParams:
    """Per-query-batch configuration for ``AnnIndex.search``/``.searcher``."""
    k: int = 10                  # neighbors to return
    queue_len: int = 64          # L, bounded frontier capacity (recall knob)
    m_max: int = 8               # max expansion width M
    staged: bool = True          # §4.2 staged search (M doubles)
    stage_every: int = 1         # t: double M every t global steps
    num_walkers: int = 1         # W: private-queue workers
    local_steps: int = 4         # max local steps between sync checks
    sync_ratio: float = 0.8      # Algorithm 2 merge trigger
    max_steps: int = 64          # global step budget
    algorithm: str = "speedann"  # "bfis" | "topm" | "speedann" | "sharded"
    backend: str = "ref"         # distance backend (kernel registry name)
    dma_group: int = 8           # G: rows per DMA tile ("dma" backend)
    visited_mode: str = "bitmap"  # "bitmap" | "loose" | "hash"
    hash_bits: int = 14
    global_rounds: int = 12      # static round budget ("sharded" algorithm)
    rerank_k: int = 0            # two-stage search: traverse over a pool
    #                              widened to max(k, rerank_k), then exactly
    #                              re-rank it against the f32 vectors

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}; one of {ALGORITHMS}")
        if self.rerank_k < 0:
            raise ValueError("rerank_k must be >= 0")

    def with_(self, **kw) -> "SearchParams":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_search_config(cls, cfg: SearchConfig,
                           algorithm: str = "speedann") -> "SearchParams":
        """Lift a ``SearchConfig``'s per-query fields onto params (the
        metric, an index-time property, is intentionally dropped)."""
        return cls(
            k=cfg.k, queue_len=cfg.queue_len, m_max=cfg.m_max,
            staged=cfg.staged, stage_every=cfg.stage_every,
            num_walkers=cfg.num_walkers, local_steps=cfg.local_steps,
            sync_ratio=cfg.sync_ratio, max_steps=cfg.max_steps,
            algorithm=algorithm, backend=cfg.dist_backend,
            dma_group=cfg.dma_group, visited_mode=cfg.visited_mode,
            hash_bits=cfg.hash_bits, global_rounds=cfg.global_rounds)

    def to_search_config(self, metric: str = "l2") -> SearchConfig:
        """Lower onto the internal plumbing config.  ``metric`` comes from
        the index's :class:`IndexSpec`, never from the caller."""
        cfg = SearchConfig(
            k=self.k,
            metric=metric,
            queue_len=self.queue_len,
            m_max=self.m_max,
            staged=self.staged,
            stage_every=self.stage_every,
            num_walkers=self.num_walkers,
            local_steps=self.local_steps,
            sync_ratio=self.sync_ratio,
            max_steps=self.max_steps,
            visited_mode=self.visited_mode,
            hash_bits=self.hash_bits,
            dist_backend=self.backend,
            dma_group=self.dma_group,
            global_rounds=self.global_rounds,
        )
        if self.algorithm == "bfis":
            # Algorithm 1 exactly: single sequential best-first walker
            cfg = cfg.with_(m_max=1, num_walkers=1, staged=False)
        return cfg
