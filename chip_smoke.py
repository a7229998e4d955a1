#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's Speed-ANN search and build paths on one GPU.

    python3 chip_smoke.py [--seed 0] [--profile-src DIR]

Phases, one JSON line each:

  1. device  — the card's name and power limit;
  2. build   — nvcc builds the six kernels (csrc/*.cu), in parallel;
  3. kernels — each kernel against its plain torch version: the f32
               gather-distance kernels at the search path's shapes (N = 1M,
               d = 128; B·W = 512 × C = 32 and B = 64 × C = 256) and the
               construct phase's (B = 8,192 × C = 128), plus
               d = 960, a bf16 table, padding ids, a ragged C, C = 1000
               (dma's chunked runs), and integer data held to exact
               equality, dma also to rowgather; the int8 kernels bit for
               bit at the same shapes and d = 960, with padding, negative ids
               and a zero query; both dedup kernels bit for bit against
               rowgather on their hard cases (f32, bf16 and int8, d = 128
               and 960: every lane one id, every lane a different row so
               that a block's hash table probes, two successive calls,
               B = C = 1); rowgather, dma and rowgather_int8 at
               B = 65,573 × C = 32 (more query rows than a grid's y
               dimension holds), exactly; sort_pairs exactly on (512, 256),
               (512, 512), (64, 1024), (32, 2048) and (4, 16384) rows with
               heavy key ties and +inf padding;
  4. data    — 1M SIFT-like vectors: 1000 Gaussian clusters rescaled and
               rounded to integers in [0, 255], plus 264 queries;
  5. graph   — a fixture graph (the port's kNN-24 plus 8 uniform random
               out-edges per vertex, R = 32), saved as an index file and
               loaded back with AnnIndex.load;
  6. search  — speedann (k=10, L=128, M=8, W=8) through every f32 backend
               (ref, rowgather, dma, dedup_gather): 4 batches of 64 queries
               and 8 single queries each, all bit-identical to ref (ids,
               dists and the 8 SearchStats counters); topm and bfis once
               with rowgather against ref.  Each path (algorithm/backend)
               runs with the launch counts set to 0 just before it and read
               just after: its backend's kernel must launch, no other may;
  7. recall  — recall@10 against AnnIndex.exact, at least 0.25;
  8. merge   — every frontier insert of one speedann batch, captured at its
               call site (core/bfis.py expand_batch), replayed through
               ops.topl_merge (two sort_pairs launches each): equal to
               queue.insert bit for bit;
  9. quant   — the 1M index quantized on the card (quantize_graph, int8
               per-vector codes beside the f32 table), saved and loaded;
               speedann with rerank_k = 30 through ref_int8, rowgather_int8
               and dedup_gather_int8 on the same queries as phase 6, all
               bit-identical, each path launching its own kernel only;
               recall@10 beside the f32 recall (floor 0.25); one ref_bf16
               batch on a bf16 copy; query_meta runs once per queries
               tensor (1 + global steps per speedann batch) on both int8
               kernel backends;
 10. timing  — the launch floor (the time of one empty kernel, read the
               same way) and per kernel its time, its plain version's time
               and its bound on the inputs of a real mid-search call
               (speedann: 512 × 32; topm: 64 × 256; the int8 kernels on
               the quantized speedann step with the query side given, as
               the DistFns give it, and with it computed in the call;
               sort_pairs on a merge's rows, beside torch.sort of the keys
               alone and the same co-sort as three stable torch.sort passes
               and gathers, which is not one call); for the dedup kernels
               their tile, the distinct rows of the grid and of its tiles
               and the most lanes of one row;
 11. profile — one speedann batch under torch.profiler for each of
               rowgather, dma, dedup_gather, rowgather_int8 and
               dedup_gather_int8: wall time, device busy time and idle
               share, kernel launches, the distance kernel's calls and mean
               time, the top ops by device time;
 12. construct — the port builds the index it searches, on the card:
               AnnIndex.build of 2,048 integer vectors with rowgather and
               build_batch 512 equal (graph bytes and medoid) to the CPU
               build with ref and build_batch 32; the build of the first
               N_BUILD smoke vectors (degree 32, alpha 1, rowgather,
               build_batch 8192): seconds, points/s, seconds of candidate
               search / prune / reverse pass, peak memory, l2dist_rowgather
               as its only kernel, one insertion and one refinement round
               under torch.profiler; speedann recall@10 of the built graph
               above phase 7's fixture recall; add of 1% new vectors from
               the same clusters, each found at distance 0; delete of 1% of
               the ids (chosen by --seed), none returned, recall@10 against
               the tombstone-aware exact still above the fixture's; an
               hnsw build at N_HNSW = 100,000, its bfis
               (through the upper-level descent) on 64 queries equal in
               ids, dists and the 8 counters to the CPU search of the saved
               index.

``--profile-src DIR`` runs phases 4, 5 and 11 only, with the repro_torch
package under DIR, and times l2dist_rowgather, l2dist_dma and
int8dist_rowgather at the speedann and topm steps and sort_pairs on a
merge's pass-2 rows, beside the launch floor: unpack an older commit
(``git archive``) and run both trees on one card to compare them batch for
batch and kernel for kernel.

The line before the last holds the kernels; the last is
``{"ok": true, "device": {...}}``.  With integer coordinates in [0, 255] and
d = 128 every f32 sum is exact in any order, which is why the f32 backends
must agree bit for bit; the int8 backends agree because their integer sums
are exact and their float epilogue is rounded op by op alike.  Needs one
CUDA device; exits non-zero on any failure.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N = 1_000_000                 # vectors in the index: SIFT1M's size

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOP_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
INT8_OP_PER_S = 1979e12       # H100 SXM int8, dense
BACKENDS = ("ref", "rowgather", "dma", "dedup_gather")
INT8_BACKENDS = ("ref_int8", "rowgather_int8", "dedup_gather_int8")
# backend -> the kernel its distance calls launch (ref* launch none); the
# "merge" path is ops.topl_merge
BACKEND_KERNEL = {"ref": None, "rowgather": "l2dist_rowgather",
                  "dma": "l2dist_dma", "dedup_gather": "dedupdist",
                  "ref_int8": None, "rowgather_int8": "int8dist_rowgather",
                  "dedup_gather_int8": "dedupdist_int8", "ref_bf16": None,
                  "topl_merge": "sort_pairs"}
SPIN_CYCLES = 2_000_000       # ~1 ms of device spin at the H100's clock
BIG_B = 65_573                # query rows past a grid's y limit (65,535)
N_BUILD = 1_000_000           # points the construct phase builds
N_HNSW = 100_000              # points of its hnsw build (two builds inside)
BUILD_BATCH = 8192            # the builds' candidate-search tile
# the α of the construct phase's builds.  On this data (1000 equidistant
# Gaussian clusters, far more members than a row's 32 slots) the default
# α = 1.2 occludes no same-cluster candidate, so rows fill with them and
# the searches cannot navigate the graph; α = 1 prunes them
# (scripts/torch_build_witness.py builds the default α with both packages).
BUILD_ALPHA = 1.0
KERNELS = {
    # name: (source, the TPU kernel it replaces)
    "l2dist_rowgather": ("src/repro_torch/csrc/rowgather.cu",
                         "src/repro/kernels/l2dist.py:57"),
    "l2dist_dma": ("src/repro_torch/csrc/dma.cu",
                   "src/repro/kernels/l2dist.py:125"),
    "dedupdist": ("src/repro_torch/csrc/dedup.cu",
                  "src/repro/kernels/dedup.py:110"),
    "int8dist_rowgather": ("src/repro_torch/csrc/rowgather_int8.cu",
                           "src/repro/quant/kernels.py:161"),
    "dedupdist_int8": ("src/repro_torch/csrc/dedup_int8.cu",
                       "src/repro/kernels/dedup.py:179"),
    "sort_pairs": ("src/repro_torch/csrc/bitonic.cu",
                   "src/repro/kernels/bitonic.py:75"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def make_data(seed: int, n: int, d: int = 128, n_clusters: int = 1000,
              n_queries: int = 264):
    """SIFT-like integer vectors: cluster centres N(0, 1), unit noise,
    rescaled by the base's range and rounded into [0, 255].  Returns (base,
    queries, the generator, ``more(m, seed)``: m further vectors from the
    same clusters and scale, drawn from their own generator)."""
    rng = np.random.RandomState(seed)
    centres = rng.normal(size=(n_clusters, d)).astype(np.float32)
    base = centres[rng.randint(0, n_clusters, n)]
    base += rng.normal(size=(n, d)).astype(np.float32)
    queries = centres[rng.randint(0, n_clusters, n_queries)]
    queries += rng.normal(size=(n_queries, d)).astype(np.float32)
    lo, hi = float(base.min()), float(base.max())

    def scale(x):
        return np.clip(np.rint((x - lo) / (hi - lo) * 255.0), 0, 255
                       ).astype(np.float32)

    def more(m: int, more_seed: int):
        g = np.random.RandomState(more_seed)
        x = centres[g.randint(0, n_clusters, m)]
        return scale(x + g.normal(size=(m, d)).astype(np.float32))
    return scale(base), scale(queries), rng, more


def time_ms(fn, *args, reps: int = 30, **kw) -> float:
    """Median device time of ``fn(*args, **kw)`` by CUDA events (3 warm-up
    calls first).  Each call follows a write of 128 MB that evicts the 50 MB
    L2 (a search step meets its rows cold, so the timing must too) and a
    device spin that holds the start event back while the host enqueues the
    whole call, so the reading holds no host launch gaps however many ops
    ``fn`` issues.  A call whose start event had already fired once ``fn``
    and the end event were enqueued is not counted: the spin doubles and the
    call is timed again."""
    import torch
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn(*args, **kw)
    spin, times = SPIN_CYCLES, []
    while len(times) < reps:
        flush.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args, **kw)
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            times.append(start.elapsed_time(end))
        elif spin >= 64 * SPIN_CYCLES:
            raise RuntimeError(f"{getattr(fn, '__name__', fn)}: the host "
                               f"still enqueues after a {spin}-cycle spin")
        else:
            spin *= 2
    return float(np.median(times))


def bound(table, ids, metric: str):
    """(bound_ms, bound_by): the least time for the gather-distance of
    these inputs — the distinct valid rows, the ids, the queries and the
    output each moved once, against 2-3 flops per element of each valid
    pair."""
    import torch
    n, d = table.shape
    b, c = ids.shape
    valid = ids < n
    rows = int(torch.unique(ids[valid]).numel())
    nbytes = (rows * d * table.element_size() + ids.numel() * 4
              + b * d * 4 + b * c * 4)
    flops = int(valid.sum()) * d * (3 if metric == "l2" else 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_ids(gen, rows: int, b: int, c: int):
    """(B, C) int32 ids on the card in [0, rows), about 1 in 8 set to
    padding (>= rows, +inf) and 1 in 64 negative (row 0)."""
    import torch
    ids = torch.randint(0, rows, (b, c), generator=gen, device="cuda",
                        dtype=torch.int32)
    u = torch.rand((b, c), generator=gen, device="cuda")
    ids = torch.where(u < 0.125, rows + 7, ids)
    return torch.where(u > 1 - 1 / 64, -3, ids).to(torch.int32)


def dedup_grids(gen, rows: int):
    """The dedup kernels' hard cases, each a list of (B, C) id grids that
    are called in a row: one id in every lane; every lane a different row,
    so each block's 32 rows in its 64-slot hash table probe past each other
    (with padding and negative ids); two successive calls with different
    ids; B = C = 1."""
    import torch
    collide = torch.randperm(rows, generator=gen, device="cuda")[
        :512 * 32].reshape(512, 32)
    collide[:, ::9] = rows + 2
    collide[:, 1::11] = -4
    return {"all_duplicate": [torch.full((512, 32), 17, dtype=torch.int32,
                                         device="cuda")],
            "collide": [collide.to(torch.int32)],
            "successive": [random_ids(gen, rows, 512, 32),
                           random_ids(gen, rows, 512, 32)],
            "b1c1": [torch.full((1, 1), rows - 1, dtype=torch.int32,
                                device="cuda")]}


def check_kernels(seed: int):
    """Phase 3: each kernel against its plain version on the card."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.dedup import dedupdist
    from repro_torch.kernels.l2dist import l2dist_dma, l2dist_rowgather

    plain = {"l2dist_rowgather": ref.dist_ref, "dedupdist": ref.dist_ref,
             "l2dist_dma": ref.dist_expanded_ref}
    kern = {"l2dist_rowgather": l2dist_rowgather, "dedupdist": dedupdist,
            "l2dist_dma": l2dist_dma}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tables = {
        "f32_d128": torch.randn((N, 128), generator=gen, device="cuda"),
        "int_d128": torch.randint(0, 256, (N, 128), generator=gen,
                                  device="cuda").float(),
        "f32_d960": torch.randn((100_000, 960), generator=gen,
                                device="cuda"),
    }
    tables["bf16_d128"] = tables["f32_d128"].to(torch.bfloat16)
    tables["bf16_d960"] = tables["f32_d960"].to(torch.bfloat16)
    # 250: ragged; 300 x 1000: dma copies its runs in chunks; the construct
    # phase's candidate searches: BUILD_BATCH rows x C = m_max 4 x R 32
    shapes = [(512, 32), (64, 256), (64, 250), (300, 1000),
              (BUILD_BATCH, 128)]
    err = {k: 0.0 for k in kern}
    cases = 0
    for tname, table in tables.items():
        tol = 2e-2 if tname.startswith("bf16") else 1e-5
        exact = tname.startswith("int")
        rows, d = table.shape
        for b, c in shapes:
            ids = random_ids(gen, rows, b, c)
            if tname.startswith("int"):
                q = torch.randint(0, 256, (b, d), generator=gen,
                                  device="cuda").float()
            else:
                q = torch.randn((b, d), generator=gen, device="cuda")
            for metric in ("l2", "ip"):
                outs = {}
                for name, fn in kern.items():
                    got = fn(table, ids, q, metric=metric)
                    want = plain[name](table, ids, q, metric)
                    torch.cuda.synchronize()
                    pad = ids >= rows
                    if not bool(torch.isinf(got[pad]).all()):
                        raise AssertionError(f"{name}: padding not +inf")
                    if exact:
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"{name} {tname} {metric} ({b},{c}): not "
                                f"exact on integer data")
                    elif metric == "l2":
                        torch.testing.assert_close(got, want, rtol=tol,
                                                   atol=tol)
                    else:
                        # an inner product cancels: its rounding error
                        # scales with sum |x_i q_i|, not with the result
                        scale = -ref.dist_ref(table.abs(), ids, q.abs(),
                                              "ip")
                        bad = (got - want).abs()[~pad] \
                            > tol * (1 + scale[~pad])
                        if bool(bad.any()):
                            raise AssertionError(
                                f"{name} {tname} ip ({b},{c}): beyond "
                                f"{tol} x (1 + sum |x q|)")
                    if tname == "f32_d128":
                        e = (got[~pad] - want[~pad]).abs().max().item()
                        err[name] = max(err[name], e)
                    outs[name] = got
                    cases += 1
                if not torch.equal(outs["l2dist_rowgather"],
                                   outs["dedupdist"]):
                    raise AssertionError(
                        f"dedupdist != rowgather bit for bit ({tname}, "
                        f"{metric}, ({b},{c}))")
                if exact and not torch.equal(outs["l2dist_rowgather"],
                                             outs["l2dist_dma"]):
                    raise AssertionError(
                        f"l2dist_dma != rowgather on integer data ({metric}, "
                        f"({b},{c}))")
        for case, grids in dedup_grids(gen, rows).items():
            qs = [torch.randn((g.shape[0], d), generator=gen, device="cuda")
                  for g in grids]
            for metric in ("l2", "ip"):
                outs = [dedupdist(table, g, q, metric=metric)
                        for g, q in zip(grids, qs)]
                for g, q, got in zip(grids, qs, outs):
                    if not torch.equal(got, l2dist_rowgather(
                            table, g, q, metric=metric)):
                        raise AssertionError(
                            f"dedupdist != rowgather bit for bit ({tname}, "
                            f"{case}, {metric})")
                    cases += 1
    # more query rows than a grid's y dimension holds (speedann's B·W at
    # 8,197 queries and W = 8), on integer data: exact
    table = tables["int_d128"]
    ids = random_ids(gen, N, BIG_B, 32)
    q = torch.randint(0, 256, (BIG_B, 128), generator=gen,
                      device="cuda").float()
    for name in ("l2dist_rowgather", "l2dist_dma"):
        got = kern[name](table, ids, q, metric="l2")
        torch.cuda.synchronize()
        if not torch.equal(got, plain[name](table, ids, q, "l2")):
            raise AssertionError(f"{name} at B = {BIG_B}: not exact on "
                                 f"integer data")
        cases += 1
    del tables, table, ids, q
    torch.cuda.empty_cache()
    return err, cases


def check_quant_sort_kernels(seed: int):
    """Phase 3, second half: the int8 kernels bit for bit against
    ``int8dist_ref`` (and each other), sort_pairs exactly against
    ``sort_pairs_ref``.  Returns (max |err| per kernel, cases)."""
    import torch
    from repro_torch.kernels.bitonic import sort_pairs
    from repro_torch.kernels.dedup import dedupdist_int8
    from repro_torch.kernels.ref import sort_pairs_ref
    from repro_torch.quant import QuantSpec, fit_scales, quantize
    from repro_torch.quant.kernels import int8dist_ref, int8dist_rowgather

    kern = {"int8dist_rowgather": int8dist_rowgather,
            "dedupdist_int8": dedupdist_int8}
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    err = {k: 0.0 for k in list(kern) + ["sort_pairs"]}
    cases = 0
    spec = QuantSpec("int8")
    for rows, d in ((N, 128), (100_000, 960)):
        x = torch.randn((rows, d), generator=gen, device="cuda")
        scales = fit_scales(x, spec)
        codes = quantize(x, spec, scales)
        del x
        for b, c in ((512, 32), (64, 256), (64, 250), (300, 1000)):
            ids = random_ids(gen, rows, b, c)
            q = torch.randn((b, d), generator=gen, device="cuda")
            q[0] = 0.0                                   # a zero query
            for metric in ("l2", "ip"):
                want = int8dist_ref(codes, scales, ids, q, metric)
                outs = []
                for name, fn in kern.items():
                    got = fn(codes, scales, ids, q, metric=metric)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        fin = torch.isfinite(want)
                        e = (got[fin] - want[fin]).abs().max().item()
                        raise AssertionError(
                            f"{name} d={d} {metric} ({b},{c}): not bit-"
                            f"identical to int8dist_ref (max |err| {e})")
                    if not bool(torch.isinf(got[ids >= rows]).all()):
                        raise AssertionError(f"{name}: padding not +inf")
                    outs.append(got)
                    cases += 1
                if not torch.equal(outs[0], outs[1]):
                    raise AssertionError("dedupdist_int8 != "
                                         "int8dist_rowgather bit for bit")
        for case, grids in dedup_grids(gen, rows).items():
            qs = [torch.randn((g.shape[0], d), generator=gen, device="cuda")
                  for g in grids]
            for metric in ("l2", "ip"):
                outs = [dedupdist_int8(codes, scales, g, q, metric=metric)
                        for g, q in zip(grids, qs)]
                for g, q, got in zip(grids, qs, outs):
                    if not torch.equal(got, int8dist_rowgather(
                            codes, scales, g, q, metric=metric)):
                        raise AssertionError(
                            f"dedupdist_int8 != int8dist_rowgather bit for "
                            f"bit (d={d}, {case}, {metric})")
                    cases += 1
        if d == 128:
            # more query rows than a grid's y dimension holds
            ids = random_ids(gen, rows, BIG_B, 32)
            q = torch.randn((BIG_B, d), generator=gen, device="cuda")
            got = int8dist_rowgather(codes, scales, ids, q, metric="l2")
            torch.cuda.synchronize()
            if not torch.equal(got, int8dist_ref(codes, scales, ids, q,
                                                 "l2")):
                raise AssertionError(f"int8dist_rowgather at B = {BIG_B}: "
                                     f"not bit-identical to int8dist_ref")
            cases += 1
            del ids, q, got
        del codes, scales
    for b, n in ((512, 256), (512, 512), (64, 1024), (32, 2048),
                 (4, 16384)):
        keys = torch.randint(0, 8, (b, n), generator=gen,
                             device="cuda").float() * 0.25
        keys[torch.rand((b, n), generator=gen, device="cuda") < 0.25] = \
            float("inf")
        p0 = torch.randint(0, 4, (b, n), generator=gen, device="cuda",
                           dtype=torch.int32)
        p1 = torch.randint(-20, 20, (b, n), generator=gen, device="cuda",
                           dtype=torch.int32)
        got = sort_pairs(keys, p0, p1)
        torch.cuda.synchronize()
        for g, w in zip(got, sort_pairs_ref(keys, p0, p1)):
            if not torch.equal(g, w):
                raise AssertionError(f"sort_pairs ({b},{n}) differs from "
                                     f"sort_pairs_ref")
        cases += 1
    torch.cuda.empty_cache()
    return err, cases


def quantized_index(index, dtype: str):
    """The index quantized on the card (``quantize_graph``, per-vector
    scales, the f32 table kept for re-ranking), saved and loaded back:
    (loaded index, facts of the round trip)."""
    import torch
    from repro_torch.ann import AnnIndex, quantize_graph
    from repro_torch.quant import QuantSpec

    t0 = time.perf_counter()
    graph = quantize_graph(index.graph, QuantSpec(dtype))
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    spec = index.spec.with_(quant=dtype)
    with tempfile.TemporaryDirectory() as tmp:
        path = AnnIndex(spec, graph).save(os.path.join(tmp, "qindex.npz"))
        loaded = AnnIndex.load(path)
    if not (torch.equal(loaded.graph.codes, graph.codes)
            and torch.equal(loaded.graph.scales, graph.scales)):
        raise AssertionError(f"{dtype} codes changed in save/load")
    info = {"quantize_seconds": t_quant,
            "codes_bytes": graph.codes.numel() * graph.codes.element_size(),
            "scales_bytes": graph.scales.numel() * 4,
            "device_bytes": loaded.device_bytes}
    del graph
    torch.cuda.empty_cache()
    return loaded, info


def run_backend(index, queries, params):
    """4 batches of 64 + 8 single queries through one backend; returns
    the concatenated (ids, dists, stats) and the batch latencies."""
    import torch
    fn = index.searcher(params)
    outs, lat = [], []
    for s in range(0, 256, 64):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(queries[s:s + 64])
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        outs.append(r)
    for s in range(256, 264):
        outs.append(fn(queries[s:s + 1]))
    ids = torch.cat([o.ids for o in outs]).cpu()
    dists = torch.cat([o.dists for o in outs]).cpu()
    stats = {f: torch.cat([getattr(o.stats, f) for o in outs]).cpu()
             for f in outs[0].stats._fields}
    return ids, dists, stats, lat


def counted(fn, *args):
    """``fn(*args)`` with every launch count set to 0 just before it and
    read just after: (result, {kernel: launches})."""
    import torch
    from repro_torch.kernels import _cuda
    torch.cuda.synchronize()
    _cuda.reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, dict(_cuda.LAUNCHES)


def check_launches(path_launches) -> None:
    """Each "algorithm/backend" path must have launched its backend's
    kernel and no other."""
    for path, counts in path_launches.items():
        want = BACKEND_KERNEL[path.split("/")[1]]
        for k, v in counts.items():
            if k == want and v == 0:
                raise AssertionError(f"{path}: kernel {k} never launched")
            if k != want and v != 0:
                raise AssertionError(f"{path}: launched {k} {v} times")


def same(a, b) -> bool:
    import torch
    ia, da, sa = a[:3]
    ib, db, sb = b[:3]
    return (torch.equal(ia, ib) and torch.equal(da, db)
            and all(torch.equal(sa[f], sb[f]) for f in sa))


def _recording(inner, seen: list):
    """A DistFn that calls ``inner`` and keeps each call's (B, C) ids and
    queries in ``seen``."""
    def dist_fn(graph, active, nbrs, q):
        seen.append((nbrs.reshape(nbrs.shape[0], -1).clone(), q))
        return inner(graph, active, nbrs, q)
    return dist_fn


def step_ids(index, queries, params, inner=None):
    """The (B, C) candidate ids of one mid-search distance call of a real
    search, for timing the kernels on the path's own data: the speedann
    local step (B·W lanes × R) and the topm step (B × M·R).  ``inner`` is
    the DistFn the search runs on (default: rowgather)."""
    import torch
    from repro_torch.core.bfis import search_topm_batch
    from repro_torch.core.speedann import search_speedann_batch
    from repro_torch.kernels.registry import make_dist_fn

    if inner is None:
        inner = make_dist_fn("rowgather", metric="l2")
    out = {}
    for name, fn in (("speedann", search_speedann_batch),
                     ("topm", search_topm_batch)):
        seen = []
        fn(index.graph, queries[:64], params.to_search_config("l2"),
           dist_fn=_recording(inner, seen))
        ids, q = seen[len(seen) // 2]
        out[name] = (ids.contiguous(), q.contiguous())
    torch.cuda.synchronize()
    return out


def capture_inserts(index, queries, params):
    """Every frontier insert of one speedann batch of 64 (rowgather) made
    at its call site in ``core.bfis.expand_batch``: a list of (frontier,
    candidate ids, candidate dists, insert's output)."""
    import torch
    from repro_torch.core import queue as fq
    from repro_torch.core.speedann import search_speedann_batch

    real, seen = fq.insert, []

    def recording(f, ids, dists):
        out = real(f, ids, dists)
        if sys._getframe(1).f_code.co_name == "expand_batch":
            seen.append((f, ids, dists, out))
        return out
    fq.insert = recording
    try:
        search_speedann_batch(index.graph, queries[:64],
                              params.with_(backend="rowgather")
                              .to_search_config("l2"))
    finally:
        fq.insert = real
    torch.cuda.synchronize()
    if not seen:
        raise AssertionError("no insert captured at expand_batch")
    return seen


def replay_merges(seen):
    """Each captured insert through ops.topl_merge; every one must equal
    queue.insert bit for bit (ids, dists, checked, update position)."""
    import torch
    from repro_torch.core.queue import INVALID_ID
    from repro_torch.kernels.ops import topl_merge

    for f, ids, dists, (f2, up, _) in seen:
        d2, i2, m2, up2 = topl_merge(f.dists, f.ids, f.checked.to(
            torch.int32), dists, ids)
        if not (torch.equal(i2, f2.ids) and torch.equal(d2, f2.dists)
                and torch.equal(up2, up)
                and torch.equal((m2 == 1) | (i2 == INVALID_ID),
                                f2.checked)):
            raise AssertionError(f"topl_merge differs from queue.insert on "
                                 f"a captured frontier {tuple(f.ids.shape)}")
    return len(seen)


def tile_stats(ids, n: int, tile: int):
    """The dedup kernels' view of a (B, C) id grid: the lanes per block,
    the distinct valid rows of the grid and summed over its tiles (the rows
    the blocks stage), and the most lanes any one row has."""
    import torch
    flat = ids.reshape(-1).long()
    valid = flat < n
    rows = flat.clamp(min=0)[valid]
    tiles = torch.arange(flat.numel(), device=ids.device)[valid] // tile
    _, counts = torch.unique(rows, return_counts=True)
    return {"tile": tile, "distinct_rows": int(counts.numel()),
            "distinct_rows_in_tiles": int(torch.unique(tiles * n + rows)
                                          .numel()),
            "max_lanes_per_row": int(counts.max()) if counts.numel() else 0}


def launch_floor_ms() -> float:
    """:func:`time_ms` of one empty kernel: the least any kernel reads."""
    import torch
    return time_ms(torch.cuda._sleep, 0)


def kernel_row(name, launches, err, ms, pms, bms, bby, shape, floor):
    """A row of the kernels line; the kernel's time is read against
    ``bound_or_floor_ms``, the larger of its bound and the launch floor."""
    src, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": bby, "library_ms": None,
            "launch_floor_ms": floor, "bound_or_floor_ms": max(bms, floor),
            "shape": list(shape)}


def time_kernels(index, queries, params, launches, err, floor):
    """Per kernel: its time, its plain version's time and its bound at the
    speedann step's shape (the kernels line), and at the topm step's; for
    dedupdist also its tiles."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.dedup import dedupdist, tile_lanes
    from repro_torch.kernels.l2dist import l2dist_dma, l2dist_rowgather

    table = index.graph.vectors
    n, d = table.shape
    calls = {"l2dist_rowgather": (l2dist_rowgather, ref.dist_ref),
             "l2dist_dma": (l2dist_dma, ref.dist_expanded_ref),
             "dedupdist": (dedupdist, ref.dist_ref)}
    rows, shapes = [], {}
    for step, (ids, q) in step_ids(index, queries, params).items():
        bms, bby = bound(table, ids, "l2")
        shapes[step] = {"shape": list(ids.shape),
                        "distinct_rows": int(torch.unique(
                            ids[ids < n]).numel()),
                        "valid": int((ids < n).sum()),
                        "bound_ms": bms, "bound_by": bby}
        for kname, (kfn, pfn) in calls.items():
            ms = time_ms(kfn, table, ids, q, metric="l2")
            pms = time_ms(pfn, table, ids, q, "l2")
            shapes[step][kname] = {"ms": ms, "plain_ms": pms}
            if kname == "dedupdist":
                shapes[step][kname].update(tile_stats(
                    ids, n, tile_lanes(d, d * 4, *ids.shape)))
            if step == "speedann":
                rows.append(kernel_row(kname, launches, err, ms, pms, bms,
                                       bby, ids.shape, floor))
    return rows, shapes


def int8_bound(codes, ids, queries):
    """(bound_ms, bound_by) of an int8 gather-distance: the distinct valid
    code rows with their scales, the ids, the f32 queries and the output
    each moved once, against a dot and a norm (2 multiply-adds) per element
    of each valid pair at the card's int8 rate."""
    import torch
    n, d = codes.shape
    b, c = ids.shape
    valid = ids < n
    rows = int(torch.unique(ids[valid]).numel())
    nbytes = rows * (d + 4) + ids.numel() * 4 + b * d * 4 + b * c * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = int(valid.sum()) * d * 4 / INT8_OP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sort_bound(keys):
    """(bound_ms, bound_by) of a (B, n) co-sort: 12 B per element read and
    written once, against two comparisons per compare-exchange of the
    bitonic network at the card's f32 rate."""
    b, n = keys.shape
    k = n.bit_length() - 1
    t_bytes = 2 * 12 * b * n / HBM_BYTES_PER_S * 1e3
    t_ops = b * (n // 2) * (k * (k + 1) // 2) * 2 / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def merge_sorts(seen):
    """The two sort_pairs calls (pass 1, pass 2) of one mid-search frontier
    merge, replayed through ops.topl_merge: [(keys, p0, p1), ...]."""
    import torch
    from repro_torch.kernels import ops
    f, ids, dists, _ = seen[len(seen) // 2]
    real, sorts = ops.sort_pairs, []

    def recording(k, a, b):
        sorts.append(tuple(t.contiguous() for t in (k, a, b)))
        return real(k, a, b)
    ops.sort_pairs = recording
    try:
        ops.topl_merge(f.dists, f.ids, f.checked.to(torch.int32), dists, ids)
    finally:
        ops.sort_pairs = real
    return sorts


def torch_lexsort3(keys, p0, p1):
    """The co-sort of sort_pairs in torch: three stable ``torch.sort``
    passes (p1, then p0, then the key) composed by gathers, as
    ``core/queue.py::_sort_by`` does for two keys; a yardstick of several
    calls, used nowhere in the port."""
    import torch
    order = torch.sort(p1, dim=1, stable=True).indices
    order = order.gather(1, torch.sort(p0.gather(1, order), dim=1,
                                       stable=True).indices)
    order = order.gather(1, torch.sort(keys.gather(1, order), dim=1,
                                       stable=True).indices)
    return tuple(t.gather(1, order) for t in (keys, p0, p1))


def time_quant_sort_kernels(qindex, queries, params, launches, err, seen,
                            floor):
    """The int8 kernels on the ids of a mid-search call of the quantized
    speedann (and topm) search, with the query side given as the DistFns
    give it (and, for comparison, computed in the call); sort_pairs on the
    (dist, id) sort of a mid-search frontier merge, beside torch.sort of
    its keys alone and three stable torch.sort passes."""
    import torch
    from repro_torch.kernels.bitonic import sort_pairs
    from repro_torch.kernels.dedup import dedupdist_int8, tile_lanes
    from repro_torch.kernels.ref import sort_pairs_ref
    from repro_torch.quant.kernels import (int8dist_ref, int8dist_rowgather,
                                           make_rowgather_int8_dist_fn,
                                           query_meta)

    codes, scales = qindex.graph.codes, qindex.graph.scales
    n, d = codes.shape
    rows, shapes = [], {}
    calls = {"int8dist_rowgather": int8dist_rowgather,
             "dedupdist_int8": dedupdist_int8}
    steps = step_ids(qindex, queries, params,
                     inner=make_rowgather_int8_dist_fn("l2"))
    for step, (ids, q) in steps.items():
        bms, bby = int8_bound(codes, ids, q)
        step = "int8_" + step
        shapes[step] = {"shape": list(ids.shape),
                        "distinct_rows": int(torch.unique(
                            ids[ids < n]).numel()),
                        "valid": int((ids < n).sum()),
                        "bound_ms": bms, "bound_by": bby}
        qm = query_meta(q)
        pms = time_ms(int8dist_ref, codes, scales, ids, q, "l2", qmeta=qm)
        shapes[step]["query_meta_ms"] = time_ms(query_meta, q)
        for kname, kfn in calls.items():
            ms = time_ms(kfn, codes, scales, ids, q, metric="l2", qmeta=qm)
            with_meta = time_ms(kfn, codes, scales, ids, q, metric="l2")
            shapes[step][kname] = {"ms": ms, "plain_ms": pms,
                                   "ms_with_query_meta": with_meta}
            if kname == "dedupdist_int8":
                shapes[step][kname].update(tile_stats(
                    ids, n, tile_lanes(d, d, *ids.shape)))
            if step == "int8_speedann":
                # "ms" and "plain_ms" with the query side given, as the
                # DistFns give it; "ms_with_query_meta" computes it in the
                # call, as PR 12's DistFns did on every call
                rows.append(dict(kernel_row(kname, launches, err, ms, pms,
                                            bms, bby, ids.shape, floor),
                                 ms_with_query_meta=with_meta))

    # the sort_pairs calls of one mid-search merge
    sorts = merge_sorts(seen)
    keys, p0, p1 = sorts[1]                             # pass 2: (dist, id)
    if not all(torch.equal(a, b) for a, b in zip(
            sort_pairs(keys, p0, p1), torch_lexsort3(keys, p0, p1))):
        raise AssertionError("sort_pairs differs from three stable "
                             "torch.sort passes on a merge's rows")
    bms, bby = sort_bound(keys)
    ms = time_ms(sort_pairs, keys, p0, p1)
    pms = time_ms(sort_pairs_ref, keys, p0, p1)
    lib = time_ms(torch.sort, keys, dim=1, stable=True)
    lex = time_ms(torch_lexsort3, keys, p0, p1)
    shapes["merge"] = {"shape": list(keys.shape), "sort_pairs": {
        "ms": ms, "plain_ms": pms, "torch_sort_key_only_ms": lib,
        "torch_three_stable_sorts_ms": lex,
        "pass1_ms": time_ms(sort_pairs, *sorts[0])},
        "bound_ms": bms, "bound_by": bby}
    rows.append(dict(kernel_row("sort_pairs", launches, err, ms, pms, bms,
                                bby, keys.shape, floor), library_ms=lib,
                     library="torch.sort (key only)",
                     torch_three_stable_sorts_ms=lex,
                     torch_three_stable_sorts="the same co-sort as 3 "
                     "stable torch.sort passes + gathers: not one call"))
    return rows, shapes


# backend -> the name of its distance kernel in a profiler trace
TRACE_KERNEL = {"rowgather": "rowgather_kernel", "dma": "dma_kernel",
                "dedup_gather": "dedup_kernel",
                "rowgather_int8": "rowgather_int8_kernel",
                "dedup_gather_int8": "dedup_int8_kernel"}


def profile_batch(index, queries, params, smi, backend: str = "rowgather"):
    """One speedann batch of 64 through ``backend``: its wall time (median
    of 3 plain runs), then one run under torch.profiler for the summed
    kernel time, the device's idle share against the plain wall time, the
    kernel launches, the distance kernel's calls and mean time, and the ops
    that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p = params.with_(backend=backend)
    fn = index.searcher(p)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(queries[:64])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(walls))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(queries[:64])
        torch.cuda.synchronize()
        wall_profiled = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    events = prof.key_averages()
    # kernels (device events) give the busy time; the aten ops that
    # launched them give the breakdown
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    ops = sorted((e for e in events
                  if e.device_type == DeviceType.CPU and dev_us(e) > 0),
                 key=dev_us, reverse=True)
    measured = busy_ms > 0
    dist = [e for e in kernels if TRACE_KERNEL[backend] in e.key]
    dist_ms = sum(dev_us(e) for e in dist) / 1e3
    dist_n = sum(e.count for e in dist)
    return {"phase": "profile", "backend": backend, "batch": 64,
            "wall_ms": wall, "wall_ms_profiled": wall_profiled,
            "device_busy_ms": busy_ms if measured else "not measured",
            "idle_share": 1 - busy_ms / wall if measured
            else "not measured",
            "kernel_launches": sum(e.count for e in kernels),
            "dist_kernel_calls": dist_n,
            "dist_kernel_mean_ms": dist_ms / dist_n if dist_n
            else "not measured",
            "top_ops_device_ms": [[e.key, dev_us(e) / 1e3, e.count]
                                  for e in ops[:10]],
            "card": smi}


def profile_backends(index, qindex, queries, smi):
    """Phase 11: :func:`profile_batch` for rowgather, dma and dedup_gather
    on ``index`` and for rowgather_int8 and dedup_gather_int8 on
    ``qindex``, each after one warm batch; the rows name the package that
    ran."""
    import repro_torch
    params = smoke_params()
    qparams = params.with_(rerank_k=30)
    rows = []
    for idx, p, be in ((index, params, "rowgather"),
                       (index, params, "dma"),
                       (index, params, "dedup_gather"),
                       (qindex, qparams, "rowgather_int8"),
                       (qindex, qparams, "dedup_gather_int8")):
        idx.searcher(p.with_(backend=be))(queries[:64])
        rows.append(dict(profile_batch(idx, queries, p, smi, be),
                         package=os.path.dirname(repro_torch.__file__)))
    return rows


def kernel_times(index, qindex, queries, smi):
    """``--profile-src``: l2dist_rowgather, l2dist_dma and
    int8dist_rowgather (the query side given) by :func:`time_ms` on the
    speedann and topm steps' ids, and sort_pairs on a mid-search merge's
    pass-2 rows, beside the launch floor, with the package that ran."""
    import repro_torch
    from repro_torch.kernels.bitonic import sort_pairs
    from repro_torch.kernels.l2dist import l2dist_dma, l2dist_rowgather
    from repro_torch.quant.kernels import (int8dist_rowgather,
                                           make_rowgather_int8_dist_fn,
                                           query_meta)
    params = smoke_params()
    codes, scales = qindex.graph.codes, qindex.graph.scales
    table = index.graph.vectors
    out = {"phase": "kernel_times", "launch_floor_ms": launch_floor_ms()}
    for step, (ids, q) in step_ids(index, queries, params).items():
        out[step] = {"shape": list(ids.shape),
                     "l2dist_rowgather": time_ms(l2dist_rowgather, table,
                                                 ids, q, metric="l2"),
                     "l2dist_dma": time_ms(l2dist_dma, table, ids, q,
                                           metric="l2")}
    steps = step_ids(qindex, queries, params.with_(rerank_k=30),
                     inner=make_rowgather_int8_dist_fn("l2"))
    for step, (ids, q) in steps.items():
        out["int8_" + step] = {"shape": list(ids.shape),
                               "int8dist_rowgather": time_ms(
                                   int8dist_rowgather, codes, scales, ids, q,
                                   metric="l2", qmeta=query_meta(q))}
    keys, p0, p1 = merge_sorts(capture_inserts(index, queries, params))[1]
    out["merge"] = {"shape": list(keys.shape),
                    "sort_pairs": time_ms(sort_pairs, keys, p0, p1)}
    return dict(out, package=os.path.dirname(repro_torch.__file__),
                card=smi)


def smoke_params():
    """The smoke's search: speedann, k = 10, L = 128, M = 8, W = 8."""
    from repro_torch.ann import SearchParams
    return SearchParams(k=10, queue_len=128, m_max=8, num_walkers=8,
                        algorithm="speedann")


def build_index(seed: int):
    """Phases 4-5: the data and the fixture graph's index, saved and loaded
    back; (index, queries on the card, facts of both phases)."""
    import torch
    from repro_torch.ann import AnnIndex, IndexSpec
    from repro_torch.core import knn_graph, make_padded_csr

    t0 = time.perf_counter()
    base, queries_np, rng, more = make_data(seed, N)
    data = {"seconds": time.perf_counter() - t0, "n": base.shape[0],
            "d": base.shape[1], "queries": queries_np.shape[0]}
    t0 = time.perf_counter()
    base_dev = torch.from_numpy(base).cuda()
    knn = knn_graph(base_dev, 24)
    rand = torch.from_numpy(rng.randint(0, N, size=(N, 8))
                            ).to("cuda", torch.int32)
    torch.cuda.synchronize()
    t_knn = time.perf_counter() - t0
    graph = make_padded_csr(torch.cat([knn, rand], dim=1), base_dev,
                            device="cuda")
    del knn, rand, base_dev
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        path = AnnIndex(IndexSpec(metric="l2", degree=32), graph).save(
            os.path.join(tmp, "index.npz"))
        t_save = time.perf_counter() - t1
        del graph
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        index = AnnIndex.load(path)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t1
    graph_facts = {"knn_seconds": t_knn, "save_seconds": t_save,
                   "load_seconds": t_load, "degree": index.graph.degree,
                   "device_bytes": index.device_bytes,
                   "medoid": int(index.graph.medoid)}
    return (index, torch.from_numpy(queries_np).cuda(),
            {"data": data, "graph": graph_facts, "base": base,
             "more": more})


def count_query_meta(qindex, queries, params):
    """Per int8 kernel backend: ``query_meta`` calls and global steps of
    one speedann batch of 64 (the DistFns keep the query side per queries
    tensor: 1 + global steps)."""
    from repro_torch.quant import kernels as qk
    real, out = qk.query_meta, {}
    for be in INT8_BACKENDS[1:]:
        calls = []

        def counting(q):
            calls.append(q.shape)
            return real(q)
        qk.query_meta = counting
        try:
            r = qindex.search(queries[:64], params.with_(backend=be))
        finally:
            qk.query_meta = real
        out[be] = {"query_meta_calls": len(calls),
                   "global_steps": int(r.stats.steps.max()),
                   "query_rows": sorted({s[0] for s in calls})}
    return out


class StageClock:
    """Seconds of the build's stages, by wrapping ``repro_torch.core.build``
    functions with a device sync on each side: a call counts to the stage
    of the outermost wrapped call it runs in (the reverse pass's own prunes
    count as reverse)."""
    STAGES = {"_candidate_pool": "candidate_search",
              "_prune_round": "prune", "_apply_reverse": "reverse"}

    def __init__(self):
        self.seconds = {v: 0.0 for v in self.STAGES.values()}
        self._depth = 0
        self._real = {}

    def __enter__(self):
        import torch
        from repro_torch.core import build
        for name, stage in self.STAGES.items():
            real = self._real[name] = getattr(build, name)

            def timed(*a, _real=real, _stage=stage, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                self._depth += 1
                try:
                    return _real(*a, **kw)
                finally:
                    self._depth -= 1
                    torch.cuda.synchronize()
                    if self._depth == 0:
                        self.seconds[_stage] += time.perf_counter() - t0
            setattr(build, name, timed)
        return self

    def __exit__(self, *exc):
        from repro_torch.core import build
        for name, real in self._real.items():
            setattr(build, name, real)


def profile_round(index, pool: str, rows: int, seed: int, smi):
    """One build round of ``rows`` points (the ``pool`` kind: "visited" for
    insertion, "results" for refinement) on a copy of the built graph,
    under torch.profiler: wall time, device busy time and idle share,
    kernel launches, the top ops by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import build

    spec = index.spec
    g = index.graph
    cfg = build._build_search_config(spec.resolved_ef, "l2",
                                     spec.build_backend)
    ids = torch.from_numpy(np.random.RandomState(seed).choice(
        g.n_nodes, size=rows, replace=False)).cuda()

    def one_round():
        nbrs = g.nbrs.clone()
        build._process_round(nbrs, g.vectors, int(g.medoid), ids, cfg,
                             spec.degree, spec.alpha, "l2",
                             spec.build_batch, False, None, pool=pool)
        torch.cuda.synchronize()
    one_round()
    t0 = time.perf_counter()
    one_round()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one_round()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    ops = sorted((e for e in events
                  if e.device_type == DeviceType.CPU and dev_us(e) > 0),
                 key=dev_us, reverse=True)
    return {"pool": pool, "rows": rows, "wall_ms": wall,
            "device_busy_ms": busy if busy > 0 else "not measured",
            "idle_share": 1 - busy / wall if busy > 0 else "not measured",
            "kernel_launches": sum(e.count for e in kernels),
            "top_ops_device_ms": [[e.key, dev_us(e) / 1e3, e.count]
                                  for e in ops[:8]],
            "card": smi}


def construct(seed: int, base, more, queries, fixture_recall, smi,
              n_build: int):
    """Phase 12: the port builds the index it searches, on the card.

    (1) a build of 2,048 integer vectors on the card (rowgather,
    build_batch 512) equal to the port's CPU build (ref, build_batch 32);
    (2) the full build of the smoke's first ``n_build`` vectors, with its
    stages' seconds, peak memory and kernel launches; (3) its speedann
    recall@10, above the fixture graph's; (4) ``add`` of 1% new vectors,
    each found at distance 0; (5) ``delete`` of 1% of the ids: none
    returned, recall against the tombstone-aware ``exact`` above the
    fixture's; (6) an hnsw build at ``N_HNSW``, whose bfis through the
    descent equals the port's CPU search of the saved index."""
    import torch
    from repro_torch.ann import AnnIndex, IndexSpec
    from repro_torch.core import recall_at_k

    params = smoke_params()
    gate = fixture_recall
    out = {"phase": "construct", "card": smi, "recall_gate": gate}

    # (1) the card against the CPU, bit for bit
    small = make_data(seed + 2, 2048)[0]
    t0 = time.perf_counter()
    cpu = AnnIndex.build(small, IndexSpec(metric="l2", degree=32),
                         device="cpu")
    t_cpu = time.perf_counter() - t0
    card, launches = counted(AnnIndex.build, small, IndexSpec(
        metric="l2", degree=32, build_backend="rowgather", build_batch=512))
    check_launches({"construct/rowgather": launches})
    if not (torch.equal(card.graph.nbrs.cpu(), cpu.graph.nbrs)
            and int(card.graph.medoid) == int(cpu.graph.medoid)):
        raise AssertionError("the card build differs from the CPU build "
                             "at N = 2048")
    out["card_equals_cpu"] = {"n": 2048, "cpu_seconds": t_cpu,
                              "launches": launches}
    del cpu, card

    # (2) the full build
    spec = IndexSpec(metric="l2", degree=32, alpha=BUILD_ALPHA,
                     build_backend="rowgather", build_batch=BUILD_BATCH)
    x = torch.from_numpy(base[:n_build]).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with StageClock() as clock:
        t0 = time.perf_counter()
        index, launches = counted(AnnIndex.build, x, spec)
        seconds = time.perf_counter() - t0
    check_launches({"construct/rowgather": launches})
    out["build"] = {
        "n": n_build, "degree": 32, "alpha": BUILD_ALPHA,
        "build_batch": BUILD_BATCH,
        "seconds": seconds, "points_per_s": n_build / seconds,
        "stage_seconds": clock.seconds,
        "other_seconds": seconds - sum(clock.seconds.values()),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "mean_out_degree": float((index.graph.nbrs < n_build).sum(dim=1)
                                 .double().mean())}
    emit(dict(out, part="build"))
    out["round_profile"] = [profile_round(index, pool, BUILD_BATCH, seed,
                                          smi)
                            for pool in ("visited", "results")]

    # (3) recall of the built graph
    res = index.search(queries, params)
    gt, _ = index.exact(queries[:256], 10)
    recall = recall_at_k(res.ids[:256].cpu(), gt, 10)
    out["recall_at_10"] = recall
    out["mean_stats"] = {f: float(v.double().mean())
                         for f, v in zip(res.stats._fields, res.stats)}
    if not recall > gate:
        raise AssertionError(f"built graph recall@10 {recall} not above "
                             f"{gate}")

    # (4) add 1% new vectors: each found at distance 0
    extra = torch.from_numpy(more(n_build // 100, seed + 4)).cuda()
    t0 = time.perf_counter()
    new_ids, launches = counted(index.add, extra)
    t_add = time.perf_counter() - t0
    check_launches({"add/rowgather": launches})
    found = torch.cat([index.search(extra[s:s + 256], params).dists[:, 0]
                       for s in range(0, extra.shape[0], 256)])
    at_zero = float((found == 0).double().mean())
    out["add"] = {"n": int(extra.shape[0]), "seconds": t_add,
                  "top1_at_distance_0": at_zero, "launches": launches}
    if at_zero < 0.99:
        raise AssertionError(f"add: {at_zero} of the new vectors found at "
                             f"distance 0")

    # (5) delete 1% of the ids, chosen by the seed
    dead = np.random.RandomState(seed + 5).choice(
        index.n_nodes, size=index.n_nodes // 100, replace=False)
    t0 = time.perf_counter()
    n_dead = index.delete(dead)
    t_del = time.perf_counter() - t0
    res = index.search(queries, params)
    if bool(torch.isin(res.ids.cpu(), torch.from_numpy(dead)).any()):
        raise AssertionError("delete: a deleted id was returned")
    gt, _ = index.exact(queries[:256], 10)
    recall_del = recall_at_k(res.ids[:256].cpu(), gt, 10)
    out["delete"] = {"n": n_dead, "seconds": t_del,
                     "recall_at_10": recall_del}
    if not recall_del > gate:
        raise AssertionError(f"recall@10 after delete {recall_del} not "
                             f"above {gate}")
    del index, x, extra
    torch.cuda.empty_cache()

    # (6) hnsw: build, then bfis through the descent against the CPU port
    hspec = spec.with_(builder="hnsw")
    t0 = time.perf_counter()
    hindex, launches = counted(AnnIndex.build,
                               torch.from_numpy(base[:N_HNSW]).cuda(), hspec)
    t_hnsw = time.perf_counter() - t0
    check_launches({"hnsw/rowgather": launches})
    hparams = params.with_(algorithm="bfis")
    got = hindex.search(queries[:64], hparams)
    with tempfile.TemporaryDirectory() as tmp:
        path = hindex.save(os.path.join(tmp, "hnsw.npz"))
        want = AnnIndex.load(path, device="cpu").search(queries[:64].cpu(),
                                                        hparams)
    if not (torch.equal(got.ids.cpu(), want.ids)
            and torch.equal(got.dists.cpu(), want.dists)
            and all(torch.equal(a.cpu(), b)
                    for a, b in zip(got.stats, want.stats))):
        raise AssertionError("hnsw bfis on the card differs from the CPU "
                             "search of the saved index")
    gt, _ = hindex.exact(queries[:64], 10)
    out["hnsw"] = {"n": N_HNSW, "seconds": t_hnsw,
                   "levels": len(hindex.hnsw.level_nbrs),
                   "launches": launches,
                   "bfis_equals_cpu": True,
                   "recall_at_10_bfis_first64": recall_at_k(
                       got.ids.cpu(), gt, 10)}
    del hindex
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-src", metavar="DIR",
                    help="only build the index and run phase 11 with the "
                         "repro_torch package under DIR (an unpacked older "
                         "commit's src, to compare two versions on one card)")
    args = ap.parse_args()
    if args.profile_src:                    # before any import of the port
        sys.path.insert(0, os.path.abspath(args.profile_src))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on "
              "the card", file=sys.stderr)
        return 2
    if args.profile_src:
        smi = smi_line()
        index, queries, _ = build_index(args.seed)
        qindex, _ = quantized_index(index, "int8")
        emit(kernel_times(index, qindex, queries, smi))
        for row in profile_backends(index, qindex, queries, smi):
            emit(row)
        print(smi, flush=True)
        return 0
    from repro_torch.core import recall_at_k
    from repro_torch.kernels import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = _cuda.build()
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in _cuda.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built, "ptxas": ptxas})

    t0 = time.perf_counter()
    err, cases = check_kernels(args.seed)
    err2, cases2 = check_quant_sort_kernels(args.seed)
    err.update(err2)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "cases": cases + cases2, "max_abs_err_f32": err,
          "tolerance": {"f32": 1e-5, "bf16": 2e-2, "integer": "exact",
                        "int8": "exact", "sort_pairs": "exact"}})

    index, queries, facts = build_index(args.seed)
    emit({"phase": "data", **facts["data"]})
    emit({"phase": "graph", **facts["graph"]})
    params = smoke_params()
    t0 = time.perf_counter()
    res, path_launches = {}, {}
    for be in BACKENDS:
        res[be], path_launches[f"speedann/{be}"] = counted(
            run_backend, index, queries, params.with_(backend=be))
    others = {}
    for algo in ("topm", "bfis"):
        p = params.with_(algorithm=algo)
        others[algo] = []
        for be in ("ref", "rowgather"):
            r, path_launches[f"{algo}/{be}"] = counted(
                index.search, queries[:64], p.with_(backend=be))
            others[algo].append(r)
    search_s = time.perf_counter() - t0
    for be in BACKENDS[1:]:
        if not same(res["ref"], res[be]):
            raise AssertionError(f"backend {be} differs from ref")
    for algo, (a, b) in others.items():
        if not (torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
                and all(torch.equal(x, y) for x, y in zip(a.stats,
                                                          b.stats))):
            raise AssertionError(f"{algo}: rowgather differs from ref")
    check_launches(path_launches)
    # the kernels line: each kernel's launches on its own backend's
    # speedann path, the main path
    launches = {BACKEND_KERNEL[be]: path_launches[f"speedann/{be}"][
        BACKEND_KERNEL[be]] for be in BACKENDS[1:]}
    ids, dists, stats = res["ref"][:3]
    if ids.shape != (264, 10) or not bool(torch.isfinite(dists).all()):
        raise AssertionError("search results malformed")
    emit({"phase": "search", "seconds": search_s,
          "bit_identical": list(BACKENDS), "launches": path_launches,
          "p50_batch_ms": {be: float(np.median(r[3])) * 1e3
                           for be, r in res.items()},
          "mean_stats": {f: float(v.double().mean())
                         for f, v in stats.items()},
          "card": smi})

    gt, _ = index.exact(queries[:256], 10)
    recall = recall_at_k(ids[:256], gt, 10)
    emit({"phase": "recall", "recall_at_10": recall, "floor": 0.25})
    if recall < 0.25:
        raise AssertionError(f"recall@10 {recall} below 0.25")

    t0 = time.perf_counter()
    seen = capture_inserts(index, queries, params)
    n_merges, path_launches["merge/topl_merge"] = counted(replay_merges,
                                                          seen)
    check_launches({"merge/topl_merge": path_launches["merge/topl_merge"]})
    launches["sort_pairs"] = path_launches["merge/topl_merge"]["sort_pairs"]
    emit({"phase": "merge", "seconds": time.perf_counter() - t0,
          "merges": n_merges, "bit_identical_to": "queue.insert",
          "rows_L_C": sorted({(*s_[0].ids.shape, s_[1].shape[-1])
                              for s_ in seen}),
          "launches": path_launches["merge/topl_merge"]})

    t0 = time.perf_counter()
    qindex, quant_info = quantized_index(index, "int8")
    qparams = params.with_(rerank_k=30)
    qres = {}
    for be in INT8_BACKENDS:
        qres[be], path_launches[f"speedann/{be}"] = counted(
            run_backend, qindex, queries, qparams.with_(backend=be))
    for be in INT8_BACKENDS[1:]:
        if not same(qres["ref_int8"], qres[be]):
            raise AssertionError(f"backend {be} differs from ref_int8")
    check_launches({p: path_launches[p] for p in path_launches
                    if p.split("/")[1] in INT8_BACKENDS})
    for be in INT8_BACKENDS[1:]:
        launches[BACKEND_KERNEL[be]] = \
            path_launches[f"speedann/{be}"][BACKEND_KERNEL[be]]
    qids, qdists = qres["ref_int8"][:2]
    if qids.shape != (264, 10) or not bool(torch.isfinite(qdists).all()):
        raise AssertionError("quantized search results malformed")
    recall_int8 = recall_at_k(qids[:256], gt, 10)
    bindex, bquant_info = quantized_index(index, "bf16")
    bres, path_launches["speedann/ref_bf16"] = counted(
        bindex.search, queries[:64], qparams.with_(backend="ref_bf16"))
    check_launches({"speedann/ref_bf16": path_launches["speedann/ref_bf16"]})
    del bindex
    recall_bf16 = recall_at_k(bres.ids.cpu(), gt[:64], 10)
    meta_calls = count_query_meta(qindex, queries, qparams)
    for be, m in meta_calls.items():
        if m["query_meta_calls"] != 1 + m["global_steps"]:
            raise AssertionError(f"{be}: query_meta ran {m} times, not once "
                                 f"per queries tensor")
    emit({"phase": "quant", "seconds": time.perf_counter() - t0,
          "query_meta_per_search": meta_calls,
          "int8": quant_info, "bf16": bquant_info, "rerank_k": 30,
          "bit_identical": list(INT8_BACKENDS),
          "launches": {p: path_launches[p] for p in path_launches
                       if p.split("/")[1] in INT8_BACKENDS + ("ref_bf16",)},
          "p50_batch_ms": {be: float(np.median(r[3])) * 1e3
                           for be, r in qres.items()},
          "recall_at_10": {"f32": recall, "int8_rerank30": recall_int8,
                           "bf16_rerank30_first64": recall_bf16},
          "floor": 0.25, "card": smi})
    if min(recall_int8, recall_bf16) < 0.25:
        raise AssertionError(f"quantized recall@10 {recall_int8} / "
                             f"{recall_bf16} below 0.25")

    floor = launch_floor_ms()
    rows, shapes = time_kernels(index, queries, params, launches, err, floor)
    rows2, shapes2 = time_quant_sort_kernels(qindex, queries, qparams,
                                             launches, err, seen, floor)
    rows += rows2
    shapes.update(shapes2)
    del seen
    emit({"phase": "timing", "launch_floor_ms": floor, "shapes": shapes,
          "card": smi})
    for row in profile_backends(index, qindex, queries, smi):
        emit(row)
    del qindex, index
    torch.cuda.empty_cache()

    built = construct(args.seed, facts["base"], facts["more"], queries,
                      recall, smi, N_BUILD)
    emit(built)
    for row in rows:
        if row["name"] == "l2dist_rowgather":
            # the construct phase's build is this kernel's second main path
            row["launches_construct"] = \
                built["build"]["launches"]["l2dist_rowgather"]
    emit({"phase": "done", "total_seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
