"""Synthetic vector datasets standing in for SIFT/GIST/DEEP (Table 3).

Port of ``repro.data.vectors``: the same numpy draws, so the same seed
gives the same base and query arrays.  Clustered Gaussians reproduce the
locality structure graph-ANN relies on; scale/dimension are configurable so
each paper dataset has a laptop-scale analog with the same dimensionality
(SIFT: d=128, GIST: d=960, DEEP: d=96).  Exact ground truth comes from the
port's blocked brute-force kNN (``core.build.exact_knn``) on ``device``
(default CUDA), returned as numpy.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.build import exact_knn
from repro_torch.device import resolve_device


class VectorDataset(NamedTuple):
    name: str
    base: np.ndarray        # (N, d) float32
    queries: np.ndarray     # (Q, d) float32
    gt_ids: np.ndarray      # (Q, k) int32 exact nearest neighbors
    gt_dists: np.ndarray    # (Q, k) float32
    centers: np.ndarray     # (n_clusters, d) generative cluster centers


# dimensionalities of the paper's datasets (Table 3)
PAPER_DIMS = {"sift": 128, "gist": 960, "deep": 96}


def make_vector_dataset(
    name: str = "sift",
    n: int = 10_000,
    n_queries: int = 100,
    k: int = 100,
    n_clusters: int = 64,
    seed: int = 0,
    dim: int | None = None,
    device=None,
) -> VectorDataset:
    d = dim or PAPER_DIMS.get(name, 128)
    rng = np.random.RandomState(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 4.0
    assign = rng.randint(0, n_clusters, size=n)
    base = centers[assign] + rng.normal(size=(n, d)).astype(np.float32)
    qa = rng.randint(0, n_clusters, size=n_queries)
    queries = centers[qa] + rng.normal(size=(n_queries, d)).astype(np.float32)
    dev = resolve_device(device)
    gt_ids, gt_dists = exact_knn(torch.from_numpy(base).to(dev),
                                 torch.from_numpy(queries).to(dev), k)
    return VectorDataset(name, base.astype(np.float32),
                         queries.astype(np.float32), gt_ids.cpu().numpy(),
                         gt_dists.cpu().numpy(), centers)
