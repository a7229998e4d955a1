"""Speed-ANN search configuration — the traversal layer's plumbing type.

Field-for-field copy of ``repro.core.config.SearchConfig`` (the port keeps
its own copy so it never imports the JAX package).  Public callers should
prefer the :mod:`repro_torch.ann` facade (``IndexSpec`` + ``SearchParams``);
``SearchParams.to_search_config`` lowers onto this type.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class SearchConfig:
    """Speed-ANN search hyperparameters (Algorithm 3 + §4)."""
    k: int = 10                  # neighbors to return
    # distance metric of the index: "l2" (squared L2, minimized), "ip"
    # (negative inner product, minimized — MIPS), "cosine" (ip on unit-norm
    # vectors; the AnnIndex facade pre-normalizes base vectors and queries).
    metric: str = "l2"
    queue_len: int = 64          # L, bounded frontier capacity
    m_max: int = 8               # max expansion width M (paper: up to #threads)
    stage_every: int = 1         # t: double M every t global steps (paper: t=1)
    staged: bool = True          # staged search (§4.2); False = fixed M=m_max
    max_steps: int = 64          # step budget (safety bound; BFiS may need more)
    sync_ratio: float = 0.8      # R in Algorithm 2 (paper: 0.8/0.9 per dataset)
    local_steps: int = 4         # max local steps between sync checks
    num_walkers: int = 1         # W: private-queue workers (batched lanes)
    visited_mode: str = "bitmap"  # "bitmap" | "loose" | "hash"
    hash_bits: int = 14          # hash-set capacity = 2**hash_bits
    # distance backend for the neighbor-expansion hot path; resolved through
    # repro_torch.kernels.registry: "ref" (plain torch gather), "rowgather"
    # (CUDA warp-per-candidate row gather), "dma" (cp.async tile gather +
    # FMA matvec), "dedup_gather" (each distinct row of the step once).
    # Backends are BATCH-MAJOR: one kernel launch covers the whole (B, M, R)
    # expansion of a query batch per global step.
    dist_backend: str = "ref"
    dma_group: int = 8           # G: rows per DMA tile ("dma" backend only)
    # distributed search: static outer (scatter/merge) round budget
    global_rounds: int = 12

    def with_(self, **kw) -> "SearchConfig":
        return dataclasses.replace(self, **kw)
