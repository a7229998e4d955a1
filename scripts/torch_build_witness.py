#!/usr/bin/env python3
"""Build the smoke's data with the reference builder and the port's, and
compare the two graphs.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_build_witness.py \
        [--n 50000] [--alpha 1.2] [--seed 0] [--build-batch 1024]
    python3 scripts/torch_build_witness.py --port-only --device cuda \
        --backend rowgather --build-batch 8192 --n 100000

Takes the first N vectors of ``chip_smoke.make_data(seed, 1M)`` (the
construct phase's data: integer coordinates in [0, 255], d = 128, so every
distance the builders take is exact and the two must agree bit for bit),
builds an NSG index (l2, degree 32, the given α) with ``repro.ann.AnnIndex``
on the CPU and with ``repro_torch.ann.AnnIndex`` on ``--device``, and prints
one JSON line: each build's seconds, whether ``nbrs`` and the medoid are
equal, and each index's speedann recall@10 (k = 10, L = 128, M = 8, W = 8:
the smoke's search, each package searching its own index) on 256 of the
smoke's queries against a numpy brute force, and the share of the port's
edges that join two different clusters of the generator.  ``build_batch``
is a compute tile of both builders and changes no bit of either graph.
Exits 1 if the graphs differ.  ``--port-only`` builds and searches the
port's index alone (no JAX needed), for sizes the reference cannot build
in reasonable time on a CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def brute_force(base: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    """(Q, k) ids of the k nearest base rows by squared L2, ties by id; the
    integer data makes every distance exact in float64."""
    b = base.astype(np.float64)
    b2 = (b * b).sum(1)
    out = []
    for s in range(0, len(queries), 32):
        q = queries[s:s + 32].astype(np.float64)
        d = (q * q).sum(1)[:, None] + b2[None, :] - 2.0 * q @ b.T
        kth = np.partition(d, k - 1, axis=1)[:, k - 1]
        for row, t in zip(d, kth):
            c = np.flatnonzero(row <= t)          # ascending ids
            out.append(c[np.argsort(row[c], kind="stable")][:k])
    return np.stack(out)


def cluster_labels(seed: int, n: int) -> np.ndarray:
    """The generator cluster of each of the first n vectors: the draws
    ``chip_smoke.make_data(seed, N)`` makes, in its order."""
    from chip_smoke import N
    rng = np.random.RandomState(seed)
    rng.normal(size=(1000, 128))                   # the centres
    return rng.randint(0, 1000, N)[:n]


def recall(got: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean([len(set(a) & set(b)) / gt.shape[1]
                          for a, b in zip(got.tolist(), gt.tolist())]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--alpha", type=float, default=1.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--build-batch", type=int, default=1024)
    ap.add_argument("--device", default="cpu",
                    help="the port's device (the reference runs on the CPU)")
    ap.add_argument("--backend", default="ref",
                    help="the port's build_backend")
    ap.add_argument("--port-only", action="store_true",
                    help="build and search the port's index alone")
    args = ap.parse_args()

    import torch
    import repro_torch.ann as port
    from chip_smoke import N, make_data

    base, queries, _, _ = make_data(args.seed, N)
    base, queries = base[:args.n], queries[:256]
    out = {"n": args.n, "alpha": args.alpha, "seed": args.seed,
           "build_batch": args.build_batch, "device": args.device,
           "backend": args.backend}
    if args.device != "cpu":
        import subprocess
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    kw = dict(k=10, queue_len=128, m_max=8, num_walkers=8,
              algorithm="speedann")
    gt = brute_force(base, queries, 10)

    if not args.port_only:
        import repro.ann as ref
        t0 = time.perf_counter()
        a = ref.AnnIndex.build(base, ref.IndexSpec(
            metric="l2", degree=32, alpha=args.alpha,
            build_batch=args.build_batch))
        out["reference_seconds"] = time.perf_counter() - t0
        out["reference_recall_at_10"] = recall(
            np.asarray(a.search(queries, ref.SearchParams(**kw)).ids), gt)

    x = torch.from_numpy(base).to(args.device)
    if args.device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    b = port.AnnIndex.build(x, port.IndexSpec(
        metric="l2", degree=32, alpha=args.alpha,
        build_batch=args.build_batch, build_backend=args.backend),
        device=args.device)
    if args.device != "cpu":
        torch.cuda.synchronize()
    out["port_seconds"] = time.perf_counter() - t0
    nbrs_b = b.graph.nbrs.cpu().numpy()
    out["mean_out_degree"] = float((nbrs_b < args.n).sum(1).mean())
    labels = cluster_labels(args.seed, args.n)
    src, slot = np.nonzero(nbrs_b < args.n)
    out["cross_cluster_edge_share"] = float(
        (labels[src] != labels[nbrs_b[src, slot]]).mean())
    out["port_recall_at_10"] = recall(
        b.search(torch.from_numpy(queries).to(args.device),
                 port.SearchParams(**kw)).ids.cpu().numpy(), gt)

    ok = True
    if not args.port_only:
        nbrs_a = np.asarray(a.graph.nbrs)
        out["nbrs_equal"] = bool(np.array_equal(nbrs_a, nbrs_b))
        out["medoid_equal"] = int(a.graph.medoid) == int(b.graph.medoid)
        out["rows_differing"] = int((nbrs_a != nbrs_b).any(axis=1).sum())
        ok = out["nbrs_equal"] and out["medoid_equal"]
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
