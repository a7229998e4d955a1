#!/usr/bin/env python3
"""Run the port's Speed-ANN search, serving and build paths, and its LMs
(dense with kNN-LM retrieval and training; the moe family), on one GPU.

    python3 chip_smoke.py [--seed 0] [--profile-src DIR]

Phases, one JSON line each:

  1. device  — the card's name and power limit;
  2. build   — nvcc builds the six kernels (csrc/*.cu), in parallel;
  3. kernels — each kernel against its plain torch version: the f32
               gather-distance kernels at the search path's shapes (N = 1M,
               d = 128; B·W = 512 × C = 32 and B = 64 × C = 256) and the
               construct phase's (B = 8,192 × C = 128) and the serving
               buckets' speedann calls (b × 32 and 8·b × 32, b = 1..32),
               plus
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
               heavy key ties and +inf padding; and the three f32 gather
               kernels at the LM's width, d = 2048, on a 131,072-row
               integer table (f32 and bf16, coordinates in [0, 15]) at
               every (B, C) of phase 15 (KNNLM_SHAPES), exactly equal to
               their plain versions and to one another;
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
               call site (core/bfis.py _expand), replayed through
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
 12. serve   — the serving stack on the 1M fixture index and its int8
               copy: ``index.serve`` through rowgather with the default
               buckets, warmed (seconds per bucket), requests of 1, 3, 17,
               64 and 100 queries (100 is two chunks) each equal to
               ``index.search`` (ids, dists and the counters; the
               batch-relative pair where the request was padded obeys
               uniq + dup = dist_comps) and launching l2dist_rowgather only,
               at (B, C) shapes phase 3 held against the plain version;
               one request of 64 through dma, dedup_gather, rowgather_int8
               and dedup_gather_int8 (rerank_k = 30), each equal to
               ``index.search`` and launching its own kernel only; per
               bucket p50 and max of SERVE_REPS timed requests, and p99
               where there are 100 (bucket 1); ``serve_async``
               (max_wait 2 ms) on its dispatcher thread fed the 264
               queries one at a time, four times over, with Poisson gaps
               from --seed at half the rate the 64-bucket sustains on real
               queries, every answer equal to the direct single-query
               search and the served rate at least 90% of the offered
               (latency p50/p99, queue wait, mean batch, queries/s); a
               cached server given 64 of them twice, the second 64 all
               hits and equal; a ReplicaRouter of two engines with a hedge
               after half the single-query p50, ROUTER_QUERIES single
               queries from 4 client threads, each equal to its direct
               search, each
               resolved once, hedges counted; one request of 64 with
               tracing, metrics and the profiler bridge under
               torch.profiler: the trace passes scripts/check_trace.py
               (device_compute and postprocess inside engine.search), the
               ann_dispatch/bucket64 range holds every rowgather launch,
               and the device idle share (busy under the profiler over the
               wall time without it);
 13. construct — the port builds the index it searches, on the card:
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
               index;
 14. sharded — run after phase 12, on the fixture index while it is on
               the card: the walker-sharded search (``SearchParams(
               algorithm="sharded")``, 12 global rounds of at most 4
               local rounds) of 64 queries on
               (1, 1), (1, 4) and (2, 4) meshes through rowgather, dma and
               dedup_gather, bit-identical, each launching its own kernel
               only, the first 8 queries equal to the same search on the
               CPU, recall@10 at least 0.25, p50 wall of 5 batches and one
               batch under torch.profiler (device busy and idle share); the
               coalescer over the (1, 4) sharded engine, 16 single queries,
               each equal to ``index.search``; the corpus path:
               ``build_partitioned_index`` of the N_CORPUS smoke vectors in
               4 shards (construct's spec, α = 1; seconds, peak memory,
               launches), ``corpus_sharded_search`` and the corpus
               AnnEngine on a (1, 4) mesh: ids in range, recall@10 against
               the exact kNN of the whole corpus at least 0.25, the engine
               equal to the direct search, p50 and profile as above.  The
               kernels line's rows gain ``launches_sharded``;
 15. knnlm   — qwen2.5-3b at full width and depth, random weights from
               --seed: the port's CausalLM at 2 layers on the card against
               the CPU (f32 to 1e-4; bf16 no farther apart than the
               farther of the two from f32); ServeEngine on 8
               prompts of 512 tokens, 32 greedy steps, replayed step by
               step against the teacher-forced forward (prefill ms, decode
               ms a step beside its byte bound, tokens/s, peak memory, one
               profiled decode step); build_datastore over 16 TokenStream
               batches (131,072 keys × 2048, degree 16, rowgather,
               build_batch 8192): forward and build seconds, stage seconds,
               peak memory, l2dist_rowgather its only kernel;
               knnlm_logits (λ 0.25, τ 10) on 64 held-out prompts of 256
               tokens through ref, rowgather, dma and dedup_gather (k = 16,
               L = 128, M = 8, W = 8), each launching its own kernel only:
               probabilities summing to 1, ids below N, distances the exact
               ones of their ids, recall@16 within 0.02 of ref's, the first
               8 equal to the CPU's on the saved datastore; every (B, C)
               its gathers took held in phase 3; the call's parts (p50 of
               5) and one profiled call.  The kernels line's rows gain
               ``launches_knnlm``;
 16. train   — qwen2.5-3b trained on the card (random weights from
               --seed; after phase 15 has freed its model): at full width
               and 2 layers (f32, 2 × 64 tokens) the loss, the global
               gradient norm and every gradient leaf against the CPU's
               (1e-4), and AdamW fed the CPU's gradients against the CPU's
               update (1e-6); at full width and depth (f32 storage, bf16
               compute, AdamW f32 moments, remat) one warm and 3 timed
               make_train_step steps of 4 × 512 tokens (step ms beside its
               bound, tokens/s, peak memory, losses and gradient norms; the
               first loss within 0.5 of ln V), one profiled step (device
               idle share, launches), none of the six kernels launched, and
               a microbatches = 2 step whose loss is within 1e-3 of the
               unsplit loss; at full width and 2 layers the Trainer's 6
               steps of 4 × 128 tokens run clean and with a failure before
               step 4 (checkpoints every 3 steps, keep 1): the final
               parameters equal (bit for bit, else within 1e-5), the
               checkpoints' bytes and save and restore seconds; one 4-lane
               int8 compressed step within the exact step's bounds.  The
               kernels line's rows gain ``launches_train`` (0);
 17. moe     — qwen3-moe-30b-a3b (128 experts, top-8; random weights from
               --seed; after phase 16 has freed its state): at full width
               and 2 layers (f32, 2 × 64 tokens) forward logits (1e-4),
               aux (1e-6), loss and every gradient leaf (1e-4 of the
               leaf's largest) against the CPU's; moe_ffn_sharded over
               lanes on one full-width layer and 2,048 tokens, a (2, 4)
               mesh (the a2a path) and a (1, 3) mesh (the tp path), card
               = CPU within 1e-5 relative and equal to moe_ffn where
               nothing drops; at full depth (48 layers, bf16 storage)
               ServeEngine on 8 prompts of 512 tokens, 32 greedy steps
               (prefill and decode ms beside their bounds, tokens/s, peak
               memory, a profiled decode step and prefill, the split of
               one layer's moe_ffn, no kernel launched), a decode step at
               the config's capacity factor equal bit for bit to one at
               E/k, and the replay check at E/k in f32 compute (greedy
               tokens = teacher-forced argmax, replayed logits = forward,
               routing held token by token).  The kernels line's rows
               gain ``launches_moe`` (0).

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
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
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
SERVE_BUCKETS = (1, 2, 4, 8, 16, 32, 64)   # AnnEngine's default buckets
# the f32 gather kernels' (B, C) in phase 3: speedann's step (B·W = 512 ×
# R = 32) and topm's (64 × M·R = 256); 250 ragged; 300 × 1000, where dma
# copies its runs in chunks; the construct phase's candidate searches
# (BUILD_BATCH rows × C = m_max 4 × R 32); and speedann's calls at every
# serving bucket below 64, which the serve phase's requests launch: the
# entry's expansion (b queries × R) and the walkers' step (8·b × R)
GATHER_SHAPES = ([(512, 32), (64, 256), (64, 250), (300, 1000),
                  (BUILD_BATCH, 128)]
                 + sorted({(w * b, 32) for b in SERVE_BUCKETS if b < 64
                           for w in (1, 8)} - {(512, 32)}))
# phase 15 (knnlm): qwen2.5-3b at full width and depth, the reference's own
# kNN-LM model.  ServeEngine: KNNLM_PROMPTS prompts of KNNLM_PROMPT_LEN
# tokens, KNNLM_STEPS greedy steps.  The datastore: KNNLM_BATCHES TokenStream
# batches of KNNLM_STREAM_BATCH rows × KNNLM_SEQ_LEN tokens (1,025 inputs,
# 1,024 keys a row): 16 × 8 × 1,024 = 131,072 keys of d_model 2,048.
KNNLM_ARCH = "qwen2.5-3b"
KNNLM_PROMPTS, KNNLM_PROMPT_LEN, KNNLM_STEPS = 8, 512, 32
KNNLM_SEQ_LEN, KNNLM_STREAM_BATCH, KNNLM_BATCHES = 1026, 8, 16
KNNLM_KEYS = KNNLM_BATCHES * KNNLM_STREAM_BATCH * (KNNLM_SEQ_LEN - 2)
KNNLM_D = 2048                # qwen2.5-3b's d_model: the keys' width
KNNLM_DEGREE = 16             # build_datastore's default degree
KNNLM_QUERIES, KNNLM_QUERY_LEN = 64, 256   # held-out prompts
KNNLM_CPU_QUERIES = 8         # prompts held to the CPU's knnlm_logits
KNNLM_WALKERS = 8
KNNLM_LAM, KNNLM_TAU = 0.25, 10.0
KNNLM_REPS = 5                # timed kNN-LM calls (p50)
# phase 16 (train): qwen2.5-3b trained on the card.  At full depth: one
# warm step, then TRAIN_STEPS timed steps of TRAIN_BATCH rows × TRAIN_SEQ
# tokens (TokenStream rows of TRAIN_SEQ + 1); at 2 layers: the Trainer's
# clean and recovered runs of TRAIN_RUN_STEPS steps of 4 × 128 tokens, a
# checkpoint every TRAIN_CKPT_EVERY steps, a failure before step
# TRAIN_FAIL_AT.
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 3
TRAIN_RUN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 6, 3, 4
BF16_FLOP_PER_S = 989e12      # H100 SXM dense bf16 peak
# phase 17 (moe): qwen3-moe-30b-a3b at full width.  (a) card vs CPU at 2
# layers, f32, MOE_CHECK_ROWS × MOE_CHECK_SEQ tokens; (b) the lane paths on
# one layer's experts and MOE_LANE_TOKENS tokens over MOE_LANE_MESHES; (c)
# full depth in bf16 storage (its f32 weights, 122 GB, do not fit the
# card): ServeEngine on MOE_PROMPTS prompts of MOE_PROMPT_LEN tokens,
# MOE_STEPS greedy steps at the config's capacity factor, and the replay
# check on MOE_REPLAY_LEN-token prompts, MOE_REPLAY_STEPS steps, at
# capacity factor E/k (capacity = tokens: nothing drops); MOE_SPLIT_REPS
# timed calls of each part of one layer's moe_ffn
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_CHECK_ROWS, MOE_CHECK_SEQ = 2, 64
MOE_LANE_TOKENS = 2048
MOE_LANE_MESHES = ((2, 4), (1, 3))      # a2a: 128 % 4 = 0; tp: 128 % 3 != 0
MOE_PROMPTS, MOE_PROMPT_LEN, MOE_STEPS = 8, 512, 32
MOE_REPLAY_LEN, MOE_REPLAY_STEPS = 64, 8
MOE_SPLIT_REPS = 20


def knnlm_gather_shapes(n_keys: int, build_batch: int = BUILD_BATCH,
                        degree: int = KNNLM_DEGREE,
                        queries: int = KNNLM_QUERIES,
                        walkers: int = KNNLM_WALKERS):
    """Every (B, C) a gather kernel may see in phase 15.  The build's
    candidate searches (topm, M = 1, 2, 4: C = M·R) run over chunks of
    ``build_batch`` of the insertion rounds 1, 1, 2, 4, ... (the first
    point is placed bare); the retrieval's speedann expands the entry
    (queries × R) and then one vertex a walker (queries·W × R)."""
    chunks, inserted = set(), 1
    while inserted < n_keys:
        take = min(inserted, n_keys - inserted)
        chunks |= {min(build_batch, take - s)
                   for s in range(0, take, build_batch)}
        inserted += take
    return sorted({(b, m * degree) for b in chunks for m in (1, 2, 4)}
                  | {(queries, degree), (queries * walkers, degree)})


KNNLM_SHAPES = knnlm_gather_shapes(KNNLM_KEYS)
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
    err = {k: 0.0 for k in kern}
    cases = 0
    for tname, table in tables.items():
        tol = 2e-2 if tname.startswith("bf16") else 1e-5
        exact = tname.startswith("int")
        rows, d = table.shape
        for b, c in GATHER_SHAPES:
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


def check_wide_kernels(seed: int):
    """Phase 3 at the LM's width: l2dist_rowgather, l2dist_dma and
    dedupdist on a KNNLM_KEYS × 2048 integer table, f32 and bf16
    (coordinates and queries in [0, 15], so every l2 and ip sum is exact:
    at most 225 · 2048 < 2^24), at every (B, C) of KNNLM_SHAPES, each
    exactly equal to its plain version and the three to one another.
    Returns (cases, the dedup tile and dma plan at the widest call)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.dedup import dedupdist, tile_lanes
    from repro_torch.kernels.l2dist import (dma_plan, l2dist_dma,
                                            l2dist_rowgather)

    kern = {"l2dist_rowgather": (l2dist_rowgather, ref.dist_ref),
            "l2dist_dma": (l2dist_dma, ref.dist_expanded_ref),
            "dedupdist": (dedupdist, ref.dist_ref)}
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    n, d = KNNLM_KEYS, KNNLM_D
    base = torch.randint(0, 16, (n, d), generator=gen, device="cuda").float()
    cases, plans = 0, {}
    for dtype in (torch.float32, torch.bfloat16):
        table = base.to(dtype)
        for b, c in KNNLM_SHAPES:
            ids = random_ids(gen, n, b, c)
            q = torch.randint(0, 16, (b, d), generator=gen,
                              device="cuda").float()
            for metric in ("l2", "ip"):
                outs = []
                for name, (fn, plain) in kern.items():
                    got = fn(table, ids, q, metric=metric)
                    if not torch.equal(got, plain(table, ids, q, metric)):
                        raise AssertionError(
                            f"{name} d={d} {dtype} {metric} ({b},{c}): not "
                            f"exact on integer data")
                    outs.append(got)
                    cases += 1
                if not all(torch.equal(outs[0], o) for o in outs[1:]):
                    raise AssertionError(
                        f"d={d} {dtype} {metric} ({b},{c}): dma or dedup "
                        f"differs from rowgather")
        b, c = KNNLM_SHAPES[-1]
        plans[str(dtype).split(".")[1]] = {
            "shape": [b, c],
            "dedup_tile": tile_lanes(d, d * table.element_size(), b, c),
            "dma_plan": dma_plan(b, c, d, dtype)._asdict()}
        del table
    del base
    torch.cuda.empty_cache()
    return cases, plans


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
        # (64, 32): speedann's entry expansion at bucket 64
        for b, c in ((512, 32), (64, 32), (64, 256), (64, 250),
                     (300, 1000)):
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


def counted(fn, *args, **kw):
    """``fn(*args, **kw)`` with every launch count set to 0 just before it
    and read just after: (result, {kernel: launches})."""
    import torch
    from repro_torch.kernels import _cuda
    torch.cuda.synchronize()
    _cuda.reset_launches()
    out = fn(*args, **kw)
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
    at its call site in ``core.bfis._expand``: a list of (frontier,
    candidate ids, candidate dists, insert's output)."""
    import torch
    from repro_torch.core import queue as fq
    from repro_torch.core.speedann import search_speedann_batch

    real, seen = fq.insert, []

    def recording(f, ids, dists):
        out = real(f, ids, dists)
        if sys._getframe(1).f_code.co_name == "_expand":
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
        raise AssertionError("no insert captured at _expand")
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
    """One speedann batch of 64 through ``backend``, read by
    :func:`profile_call`."""
    fn = index.searcher(params.with_(backend=backend))
    return {"phase": "profile", "backend": backend, "batch": 64,
            **profile_call(lambda: fn(queries[:64]), backend), "card": smi}


def profile_call(run, backend):
    """``run()`` (one batch through ``backend``; None for a run with no
    distance kernel): its wall time (median of 3 plain runs), then one run
    under torch.profiler for the summed kernel time, the device's idle
    share against the plain wall time, the kernel launches, the distance
    kernel's calls and mean time, and the ops that take the most device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(walls))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    dist = [e for e in kernels
            if backend is not None and TRACE_KERNEL[backend] in e.key]
    dist_ms = sum(dev_us(e) for e in dist) / 1e3
    dist_n = sum(e.count for e in dist)
    return {"wall_ms": wall, "wall_ms_profiled": wall_profiled,
            "device_busy_ms": busy_ms if measured else "not measured",
            "idle_share": 1 - busy_ms / wall if measured
            else "not measured",
            "kernel_launches": sum(e.count for e in kernels),
            "dist_kernel_calls": dist_n,
            "dist_kernel_mean_ms": dist_ms / dist_n if dist_n
            else "not measured",
            "top_ops_device_ms": [[e.key, dev_us(e) / 1e3, e.count]
                                  for e in ops[:10]]}


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


SERVE_SIZES = (1, 3, 17, 64, 100)   # engine requests; 100 is two chunks
# timed requests per bucket: 100 at bucket 1 (a single query, the
# coalescer's unit), so that its p99 is a tail; 20 at 2-8 and 10 above,
# which report p50 and max only.  (Until phase 17 came, 100 at 1-8 and 20
# above: the timed requests took 118 s of the serve phase's 282 s on one
# H100, buckets 2-8 70 s of them.)
SERVE_REPS = {1: 100, 2: 20, 4: 20, 8: 20, 16: 10, 32: 10, 64: 10}
TAIL_MIN = 100                      # fewer requests report no p99
# single queries through the hedging router, from 4 client threads (64
# until phase 17 came: 75 s of the serve phase, every query hedged)
ROUTER_QUERIES = 32
COALESCE_PASSES = 4                 # the 264 queries, offered this often


def served_equals(got, want, exact_relative: bool) -> bool:
    """An engine's ``ServeResult`` against ``index.search`` of the same
    queries: ids, dists and the counters bit for bit; the batch-relative
    pair (``uniq_comps``, ``batch_dup_comps``) only when the request filled
    its bucket, else ``uniq + dup == dist_comps`` per lane."""
    ok = (np.array_equal(got.ids, want.ids.cpu().numpy())
          and np.array_equal(got.dists, want.dists.cpu().numpy()))
    for name, w, g in zip(want.stats._fields, want.stats, got.stats):
        if exact_relative or name not in want.stats.BATCH_RELATIVE:
            ok = ok and np.array_equal(g, w.cpu().numpy())
    s = got.stats
    return ok and np.array_equal(s.uniq_comps + s.batch_dup_comps,
                                 s.dist_comps)


def load_check_trace():
    """``scripts/check_trace.py`` of this checkout, as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "check_trace", os.path.join(ROOT, "scripts", "check_trace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def recording_shapes(seen: set):
    """While open, every ``l2dist_rowgather`` call made through
    ``kernels.ops`` (every f32 rowgather DistFn) adds its ids' (B, C) to
    ``seen``."""
    import importlib
    # the module, not the package's ``l2dist`` function of the same name
    l2dist = importlib.import_module("repro_torch.kernels.l2dist")
    inner = l2dist.l2dist_rowgather

    def recorded(table, ids, queries, **kw):
        seen.add(tuple(ids.shape))
        return inner(table, ids, queries, **kw)
    l2dist.l2dist_rowgather = recorded
    try:
        yield seen
    finally:
        l2dist.l2dist_rowgather = inner


def serve_engine(index, qindex, queries, params, qparams):
    """Phase 12 (1)-(2): the engine's requests of SERVE_SIZES through
    rowgather, then one request of 64 through each other kernel backend,
    each equal to ``index.search`` and launching its backend's kernel
    only; SERVE_REPS timed requests a bucket (p50, max, and p99 where there
    are TAIL_MIN).  Every (B, C) the rowgather requests launch must be one
    that phase 3 held against the plain version.  Returns (facts, path
    launches, engine)."""
    engine = index.serve(params)
    if tuple(engine.bucket_sizes) != SERVE_BUCKETS:
        raise AssertionError(f"buckets {engine.bucket_sizes}")
    facts = {"warmup_seconds": {str(b): s for b, s in
                                engine.warmup().items()}}
    path_launches, lo, seen, timed = {}, 0, set(), {}
    nq = queries.shape[0]
    seconds, t0 = {}, time.perf_counter()
    for n in SERVE_SIZES:
        req = queries[lo:lo + n]
        with recording_shapes(seen):
            got, path_launches[f"engine{n}/rowgather"] = counted(
                engine.search, req)
        if not served_equals(got, index.search(req, params),
                             n in engine.bucket_sizes):
            raise AssertionError(f"engine request of {n} differs from "
                                 f"index.search")
        lo += n
    seconds["requests"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with recording_shapes(seen):
        for b in engine.bucket_sizes:
            # a window sliding over the 264 queries; results come back as
            # numpy, so each request has synchronized when it returns
            timed[b] = []
            for i in range(SERVE_REPS[b]):
                s = (i * b) % (nq - b + 1)
                t0 = time.perf_counter()
                engine.search(queries[s:s + b])
                timed[b].append((time.perf_counter() - t0) * 1e3)
    seconds["timed"] = {str(b): sum(ms) / 1e3 for b, ms in timed.items()}
    t0 = time.perf_counter()
    unchecked = seen - set(GATHER_SHAPES)
    if not seen or unchecked:
        raise AssertionError(f"rowgather shapes not held in phase 3: "
                             f"{sorted(unchecked) or 'none recorded'}")
    for idx, p in ((index, params.with_(backend="dma")),
                   (index, params.with_(backend="dedup_gather")),
                   (qindex, qparams.with_(backend="rowgather_int8")),
                   (qindex, qparams.with_(backend="dedup_gather_int8"))):
        eng = idx.serve(p)
        got, path_launches[f"engine64/{p.backend}"] = counted(
            eng.search, queries[:64])
        if not served_equals(got, idx.search(queries[:64], p), True):
            raise AssertionError(f"engine through {p.backend} differs from "
                                 f"index.search")
    check_launches(path_launches)
    seconds["backends"] = time.perf_counter() - t0
    facts["seconds"] = seconds
    facts["bucket_ms"] = {}
    for b, ms in timed.items():
        row = {"requests": len(ms), "p50": float(np.percentile(ms, 50)),
               "max": max(ms)}
        if len(ms) >= TAIL_MIN:
            row["p99"] = float(np.percentile(ms, 99))
        facts["bucket_ms"][str(b)] = row
    facts["single_query_p50_ms"] = facts["bucket_ms"]["1"]["p50"]
    facts["rowgather_shapes"] = sorted(seen)
    facts["requests_bit_identical"] = list(SERVE_SIZES)
    facts["backends_bit_identical"] = sorted(
        {p.split("/")[1] for p in path_launches})
    return facts, path_launches, engine


def serve_coalescer(index, queries_np, params, direct, bucket64_ms, seed):
    """Phase 12 (3): the 264 queries, COALESCE_PASSES times over, one at a
    time with Poisson gaps from ``seed`` at half the rate the 64-bucket
    sustains on real queries (64 over its p50), through ``serve_async``'s
    dispatcher thread on the real clock: every answer equal to the direct
    single-query search, and the served rate at least 90% of the offered
    (the queue did not grow).  Then a cached server given 64 of them
    twice: the second 64 all hits, equal."""
    from repro_torch.serve import CachePolicy
    rate = 0.5 * 64 / (bucket64_ms / 1e3)
    order = np.tile(np.arange(len(queries_np)), COALESCE_PASSES)
    gaps = np.random.default_rng(seed).exponential(1.0 / rate, len(order))
    srv = index.serve_async(params, max_wait_ms=2.0)
    t_sub, futs = [], []
    due = time.perf_counter()
    for i, gap in zip(order, gaps):
        due += gap
        time.sleep(max(0.0, due - time.perf_counter()))
        t_sub.append(time.perf_counter())
        futs.append(srv.submit(queries_np[i]))
    res = [f.result(timeout=600) for f in futs]
    st = srv.stats()
    srv.close()
    for i, r in zip(order, res):
        if not (np.array_equal(r.ids, direct[i][0])
                and np.array_equal(r.dists, direct[i][1])):
            raise AssertionError(f"coalesced query {i} differs from its "
                                 f"direct search")
    lat = [(r.done_t - t) * 1e3 for r, t in zip(res, t_sub)]
    done = sorted(r.done_t for r in res)
    # both rates over their own span: arrivals first to last, completions
    # first to last
    offered = (len(res) - 1) / (t_sub[-1] - t_sub[0])
    served = (len(res) - 1) / (done[-1] - done[0])
    quarter = len(lat) // 4
    out = {"rate_qps": rate, "offered_qps": offered, "served_qps": served,
           "requests": len(res),
           "latency_p50_ms": float(np.percentile(lat, 50)),
           "latency_p99_ms": float(np.percentile(lat, 99)),
           "latency_p50_first_quarter_ms": float(np.median(lat[:quarter])),
           "latency_p50_last_quarter_ms": float(np.median(lat[-quarter:])),
           "queue_wait_p50_ms": float(np.percentile(
               [r.queue_wait_ms for r in res], 50)),
           "batch_size_mean": st["batch_size_mean"],
           "batches": st["batches_dispatched"], "bit_identical": True}
    if served < 0.9 * offered:
        raise AssertionError(f"coalescer fell behind its offered rate: "
                             f"{out}")
    srv = index.serve_async(params, max_wait_ms=2.0, cache=CachePolicy())
    first = [f.result(timeout=600)
             for f in [srv.submit(q) for q in queries_np[:64]]]
    hits = [srv.submit(q).result(timeout=60) for q in queries_np[:64]]
    cache = srv.cache.stats()
    srv.close()
    if cache["hits"] != 64 or any(
            h.batch_size != 0.0 or not np.array_equal(h.ids, r.ids)
            or not np.array_equal(h.dists, r.dists)
            or not np.array_equal(h.ids, direct[i][0])
            for i, (h, r) in enumerate(zip(hits, first))):
        raise AssertionError(f"cache replay: {cache}")
    out["cache_hits"] = cache["hits"]
    return out


def serve_router(index, queries_np, params, direct, hedge_ms):
    """Phase 12 (4): two replicas behind ``ReplicaRouter`` with a hedge
    after ``hedge_ms``; ROUTER_QUERIES single queries from 4 client
    threads, each equal to its direct search and resolved once, hedges
    counted."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.serve import ReplicaRouter, RouterPolicy
    router = ReplicaRouter([index.serve(params) for _ in range(2)],
                           policy=RouterPolicy(hedge_after_ms=hedge_ms))
    with ThreadPoolExecutor(max_workers=4) as pool:
        res = list(pool.map(
            lambda i: router.search(queries_np[i:i + 1]),
            range(ROUTER_QUERIES)))
    router.drain_hedges()
    st = router.stats()
    router.close()
    for i, r in enumerate(res):
        if not (np.array_equal(r.ids[0], direct[i][0])
                and np.array_equal(r.dists[0], direct[i][1])):
            raise AssertionError(f"routed query {i} differs from its "
                                 f"direct search")
    if st["requests"] != ROUTER_QUERIES or st["hedges"] == 0:
        raise AssertionError(f"router: {st}")
    lat = [r.latency_ms for r in res]
    return {"hedge_after_ms": hedge_ms, "requests": ROUTER_QUERIES,
            "hedges": st["hedges"], "hedge_wins": st["hedge_wins"],
            "hedge_discarded": st["hedge_discarded"],
            "replica_served": [st["replica0_served"],
                               st["replica1_served"]],
            "latency_p50_ms": float(np.percentile(lat, 50)),
            "latency_max_ms": max(lat), "bit_identical": True}


def serve_obs(index, queries, params):
    """Phase 12 (5): one request of 64 through an engine with tracing,
    metrics and the profiler bridge on, under torch.profiler: the trace
    passes ``scripts/check_trace.py`` with device_compute and postprocess
    inside engine.search; the ``ann_dispatch/bucket64`` range holds every
    rowgather launch of the request.  The device idle share is the
    profiled run's busy time against the wall time of the same request
    without the profiler (median of 3), as ``profile_batch`` reads it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _cuda
    from repro_torch.obs import Observability
    obs = Observability(tracing=True, metrics=True, profile=True)
    engine = index.serve(params, obs=obs)
    engine.search(queries[:64])                  # the bucket's entry
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.search(queries[:64])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls))
    obs.tracer.clear()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.search(queries[:64])
        torch.cuda.synchronize()
        wall_profiled = (time.perf_counter() - t0) * 1e3
    launched = _cuda.LAUNCHES["l2dist_rowgather"]
    trace = obs.tracer.to_chrome_trace()
    errors = load_check_trace().validate(trace, require=[
        "engine.search", "device_compute", "postprocess"])
    ev = {e["name"]: e for e in trace["traceEvents"]}
    outer, dc, pp = (ev["engine.search"], ev["device_compute"],
                     ev["postprocess"])
    end = outer["ts"] + outer["dur"] + 0.5
    if errors or not (outer["ts"] <= dc["ts"] and dc["ts"] + dc["dur"]
                      <= pp["ts"] + 0.5 and pp["ts"] + pp["dur"] <= end):
        raise AssertionError(f"trace: {errors or 'span nesting'}")
    events = prof.events()
    ann = [e for e in events if e.name == "ann_dispatch/bucket64"
           and e.device_type == DeviceType.CPU]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and TRACE_KERNEL["rowgather"] in e.name]
    if len(ann) != 1 or launched == 0:
        raise AssertionError(f"profiler: {len(ann)} ann_dispatch/bucket64 "
                             f"ranges, {launched} rowgather launches")
    linked = sum(TRACE_KERNEL["rowgather"] in k.name for k in ann[0].kernels)
    lo, hi = ann[0].time_range.start, ann[0].time_range.end
    inside = sum(lo <= k.time_range.start and k.time_range.end <= hi
                 for k in kernels)
    if linked != launched and not (inside == len(kernels) == launched):
        raise AssertionError(
            f"ann_dispatch/bucket64 holds {linked} linked / {inside} timed "
            f"of {launched} rowgather launches ({len(kernels)} traced)")

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # the profiler mirrors the annotation onto the device's timeline, where
    # it spans the whole request: it is no device work of its own
    busy_ms = sum(dev_us(e) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.key != "ann_dispatch/bucket64") / 1e3
    reg = obs.registry.to_dict()
    return {"trace_events": len(trace["traceEvents"]), "check_trace": "OK",
            "rowgather_launches": launched,
            "launches_in_ann_dispatch": {"linked": linked, "timed": inside},
            "wall_ms": wall_ms, "wall_ms_profiled": wall_profiled,
            "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "registry_series": sorted(reg)}


def serve_phase(index, qindex, queries, seed, smi):
    """Phase 12: the serving stack on the card, on the 1M fixture index and
    its int8 copy.  Returns (the phase's line, its path launches)."""
    import torch
    params = smoke_params().with_(backend="rowgather")
    qparams = smoke_params().with_(rerank_k=30)
    out = {"phase": "serve", "card": smi}
    t_phase = time.perf_counter()
    parts = {}

    def part(name, fn, *a):
        t0 = time.perf_counter()
        res = fn(*a)
        parts[name] = time.perf_counter() - t0
        return res
    facts, path_launches, engine = part("engine", serve_engine, index,
                                        qindex, queries, params, qparams)
    out["engine"] = facts
    searcher = index.searcher(params)

    def direct_searches():
        found = []
        for i in range(queries.shape[0]):
            r = searcher(queries[i:i + 1])
            found.append((r.ids[0].cpu().numpy(),
                          r.dists[0].cpu().numpy()))
        return found
    direct = part("direct", direct_searches)
    queries_np = queries.cpu().numpy()
    out["coalescer"] = part("coalescer", serve_coalescer, index, queries_np,
                            params, direct, facts["bucket_ms"]["64"]["p50"],
                            seed)
    out["router"] = part("router", serve_router, index, queries_np, params,
                         direct, 0.5 * facts["single_query_p50_ms"])
    out["obs"] = part("obs", serve_obs, index, queries, params)
    out["launches"] = path_launches
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t_phase
    del engine
    torch.cuda.empty_cache()
    return out, path_launches


SHARD_MESHES = ((1, 1), (1, 4), (2, 4))    # walker meshes: (data, model)
SHARD_BACKENDS = ("rowgather", "dma", "dedup_gather")
SHARD_REPS = 5                      # timed batches of 64 per mesh
SHARD_CPU_QUERIES = 8               # queries held to the CPU run
N_SHARDS = 4                        # corpus shards, one per model position
# vectors the corpus path partitions: half the index since phase 16 (the
# whole smoke must end within 1200 s; the 1M partitioned build took 115 s)
N_CORPUS = N // 2
# the corpus engine's best-first walker (M = 1) takes a step per expanded
# vertex: the step budget of the reference's own multi-device check
CORPUS_MAX_STEPS = 384


def same_result(a, b) -> bool:
    """Equal ids, dists and all 8 counters of two search results."""
    import torch
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and all(torch.equal(x, y) for x, y in zip(a[2], b[2])))


def batch_walls(run, reps: int = SHARD_REPS):
    """Wall ms of ``reps`` synced runs of ``run()``."""
    import torch
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def _on_cpu(graph):
    import torch
    return graph._replace(**{f: t.cpu() for f, t in graph._asdict().items()
                             if isinstance(t, torch.Tensor)})


def walker_meshes(index, queries, gt, path_launches):
    """Phase 14, the walker path: ``SearchParams(algorithm="sharded")``
    (12 global rounds) on the 1M fixture index, a batch of 64, on each of
    SHARD_MESHES; per
    mesh the three f32 kernel backends bit-identical, each launching its
    own kernel only, the first SHARD_CPU_QUERIES equal to the same search
    on the CPU, recall@10 >= 0.25, p50 wall of SHARD_REPS batches and one
    batch under the profiler; on (1, 4) the coalescer over the sharded
    engine equal to ``index.search``."""
    from repro_torch.ann import AnnIndex
    from repro_torch.core import recall_at_k
    from repro_torch.core.distributed import make_search_mesh

    params = smoke_params().with_(algorithm="sharded")
    q = queries[:64]
    cpu_index = AnnIndex(index.spec, _on_cpu(index.graph))
    out = {}
    for shape in SHARD_MESHES:
        name = "x".join(map(str, shape))
        mesh = make_search_mesh(shape)
        res = {}
        for be in SHARD_BACKENDS:
            res[be], path_launches[f"sharded_{name}/{be}"] = counted(
                index.search, q, params.with_(backend=be), mesh=mesh)
        for be in SHARD_BACKENDS[1:]:
            if not same_result(res["rowgather"], res[be]):
                raise AssertionError(f"sharded {shape}: {be} differs from "
                                     "rowgather")
        k = SHARD_CPU_QUERIES
        on_cpu = cpu_index.search(q[:k].cpu(), params.with_(
            backend="rowgather"), mesh=make_search_mesh(shape, device="cpu"))
        card = res["rowgather"]
        if not same_result(tuple(t[:k].cpu() for t in card[:2])
                           + (tuple(t[:k].cpu() for t in card[2]),),
                           on_cpu):
            raise AssertionError(f"sharded {shape}: the card differs from "
                                 "the CPU")
        ids = card.ids.cpu()
        if ids.shape != (64, 10) or not bool(card.dists.isfinite().all()):
            raise AssertionError(f"sharded {shape}: results malformed")
        recall = recall_at_k(ids, gt[:64], 10)
        if recall < 0.25:
            raise AssertionError(f"sharded {shape}: recall@10 {recall} "
                                 "below 0.25")
        fn = index.searcher(params.with_(backend="rowgather"), mesh=mesh)
        walls = batch_walls(lambda: fn(q))
        out[name] = {
            "mesh": list(shape), "bit_identical": list(SHARD_BACKENDS),
            "equal_cpu_queries": k, "recall_at_10": recall,
            "p50_batch_ms": float(np.median(walls)), "batch_ms": walls,
            "profile": profile_call(lambda: fn(q), "rowgather"),
            "launches": {be: path_launches[f"sharded_{name}/{be}"]
                         for be in SHARD_BACKENDS},
            "mean_stats": {f: float(v.double().mean())
                           for f, v in card.stats._asdict().items()}}
    mesh = make_search_mesh((1, 4))
    p = params.with_(backend="rowgather")
    srv = index.serve_async(p, mesh=mesh, start=False)
    try:
        futs = [srv.submit(v) for v in queries[:16].cpu().numpy()]
        srv.flush()
        direct = index.search(queries[:16], p, mesh=mesh)
        for i, f in enumerate(futs):
            r = f.result(timeout=600)
            if not (np.array_equal(r.ids, direct.ids[i].cpu().numpy())
                    and np.array_equal(r.dists,
                                       direct.dists[i].cpu().numpy())):
                raise AssertionError("coalescer over the sharded engine "
                                     "differs from index.search")
    finally:
        srv.close()
    out["coalescer_1x4_equal_search"] = 16
    return out


def corpus_mesh(base, queries, path_launches):
    """Phase 14, the corpus path: ``build_partitioned_index`` of the first
    N_CORPUS smoke vectors in N_SHARDS shards (the construct phase's spec,
    α = 1) with its seconds, peak memory and launches; then
    ``corpus_sharded_search`` and the corpus ``AnnEngine`` on a (1, 4)
    mesh, rowgather, a batch of 64: ids in range, recall@10 against the
    exact kNN of the whole corpus >= 0.25, the engine equal to the direct
    search, p50 wall of SHARD_REPS batches and one under the profiler."""
    import torch
    from repro_torch.ann import IndexSpec
    from repro_torch.core import exact_knn, recall_at_k
    from repro_torch.core.distributed import (build_partitioned_index,
                                              corpus_sharded_search,
                                              make_search_mesh)
    from repro_torch.serve import AnnEngine

    spec = IndexSpec(metric="l2", degree=32, alpha=BUILD_ALPHA,
                     build_backend="rowgather", build_batch=BUILD_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sharded, path_launches["corpus_build/rowgather"] = counted(
        build_partitioned_index, base[:N_CORPUS], N_SHARDS, spec)
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    mesh = make_search_mesh((1, N_SHARDS))
    params = smoke_params().with_(backend="rowgather",
                                  max_steps=CORPUS_MAX_STEPS)
    cfg = params.to_search_config("l2").with_(m_max=1, staged=False,
                                              num_walkers=1)
    q = queries[:64]
    (ids, dists), path_launches["corpus_1x4/rowgather"] = counted(
        corpus_sharded_search, sharded, q, cfg, mesh)
    ids = ids.cpu()
    if not (bool(((ids >= 0) & (ids < N_CORPUS)).all())
            and bool(dists.isfinite().all())):
        raise AssertionError("corpus search returned an id out of range")
    corpus = torch.from_numpy(base[:N_CORPUS]).cuda()
    gt, _ = exact_knn(corpus, q, 10)
    del corpus
    recall = recall_at_k(ids, gt.cpu(), 10)
    if recall < 0.25:
        raise AssertionError(f"corpus recall@10 {recall} below 0.25")
    engine = AnnEngine(sharded, params, mesh=mesh)
    served, path_launches["corpus_engine_1x4/rowgather"] = counted(
        engine.search, q)
    if not (np.array_equal(served.ids, ids.numpy())
            and np.array_equal(served.dists, dists.cpu().numpy())):
        raise AssertionError("the corpus engine differs from the direct "
                             "corpus search")
    walls = batch_walls(lambda: corpus_sharded_search(sharded, q, cfg, mesh))
    return {"n": N_CORPUS, "shards": N_SHARDS,
            "rows_per_shard": sharded.nbrs.shape[1],
            "build_seconds": build_s, "build_peak_bytes": peak,
            "build_launches": path_launches["corpus_build/rowgather"],
            "max_steps": CORPUS_MAX_STEPS, "recall_at_10": recall,
            "engine_equal_direct": True,
            "p50_batch_ms": float(np.median(walls)), "batch_ms": walls,
            "profile": profile_call(
                lambda: corpus_sharded_search(sharded, q, cfg, mesh),
                "rowgather"),
            "launches": {p: path_launches[p] for p in path_launches
                         if p.startswith("corpus_")}}


def sharded_phase(index, base, queries, gt, smi):
    """Phase 14: the walker-sharded and corpus-sharded paths on the card.
    Returns (the phase's line, its path launches)."""
    import torch
    t0 = time.perf_counter()
    path_launches = {}
    walker = walker_meshes(index, queries, gt, path_launches)
    corpus = corpus_mesh(base, queries, path_launches)
    check_launches(path_launches)
    torch.cuda.empty_cache()
    return ({"phase": "sharded", "walker": walker, "corpus": corpus,
             "seconds": time.perf_counter() - t0, "card": smi},
            path_launches)


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
    """Phase 13: the port builds the index it searches, on the card.

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


def _synced_ms(fn, *a, **kw):
    """(fn(*a, **kw), its wall ms between two device syncs)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bf16_pair_err(a, b, f32):
    """(max |a − b|, max |a − f32|, max |b − f32|): two bf16 runs of one
    model and the float32 run they approximate."""
    return tuple(float((x - y).abs().max()) for x, y in ((a, b), (a, f32),
                                                        (b, f32)))


def lm_card_vs_cpu(cfg, seed: int):
    """Phase 15 (2): the port's CausalLM at full width and 2 layers on the
    card against the same weights on the CPU, on 2 prompts of 16 tokens.
    float32: logits within rtol = atol = 1e-4.  bf16: the card's and the
    CPU's logits no farther apart than the farther of the two is from the
    float32 logits (two bf16 runs that round in different orders drift
    apart by up to bf16's own error: at this width 0.03 on the CPU alone,
    PERF.md §3), with the share beyond 2e-2 recorded."""
    import copy
    import dataclasses
    import torch
    from repro_torch.models import build_model

    small = dataclasses.replace(cfg, num_layers=2)
    cpu = build_model(small, device="cpu").init(
        torch.Generator().manual_seed(seed))
    card = copy.deepcopy(cpu).to("cuda")
    toks = torch.from_numpy(np.random.RandomState(seed + 9).randint(
        0, cfg.vocab_size, size=(2, 16)))
    logits = {}
    for dtype in ("float32", "bfloat16"):
        cfg_d = dataclasses.replace(small, dtype=dtype)
        m_cpu, m_card = build_model(cfg_d, device="cpu"), build_model(cfg_d)
        with torch.inference_mode():
            logits[dtype] = (m_cpu.forward(cpu, toks)[0].float(),
                             m_card.forward(card, toks.cuda())[0].float()
                             .cpu())
    want, got = logits["float32"]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    c_cpu, c_card = logits["bfloat16"]
    pair, card_err, cpu_err = bf16_pair_err(c_card, c_cpu, want)
    if pair > max(card_err, cpu_err):
        raise AssertionError(f"bf16: card and CPU logits {pair} apart, "
                             f"beyond their errors from f32 ({card_err}, "
                             f"{cpu_err})")
    beyond = (c_card - c_cpu).abs() > 2e-2 + 2e-2 * c_cpu.abs()
    del cpu, card
    torch.cuda.empty_cache()
    return {"float32": {"max_abs_err": float((got - want).abs().max()),
                        "rtol_atol": 1e-4},
            "bfloat16": {"max_abs_card_cpu": pair,
                         "max_abs_card_f32": card_err,
                         "max_abs_cpu_f32": cpu_err,
                         "beyond_2e-2": int(beyond.sum()),
                         "logits": beyond.numel()}}


def engine_timings(model, params, prompts, steps: int):
    """ServeEngine on ``prompts`` (B, plen) for ``steps`` greedy steps: a
    warm call, then ``generate`` timed (peak memory); 3 timed prefills and
    the generated tokens replayed one timed decode step at a time, keeping
    the logits that picked each token.  Returns (facts, generated tokens
    (B, steps), picked logits (B, steps, V) f32, the final state)."""
    import torch
    from repro_torch.serve import ServeEngine

    b, plen = prompts.shape
    s_max = plen + steps
    eng = ServeEngine(model, params, s_max=s_max)
    eng.generate(prompts[:, :16], steps=2)                    # warm
    torch.cuda.reset_peak_memory_stats()
    (gen, _), gen_ms = _synced_ms(eng.generate, prompts, steps)
    peak = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        pre_ms, step_ms = [], []
        for _ in range(3):
            (logits, state), ms = _synced_ms(model.prefill, params,
                                             prompts, s_max)
            pre_ms.append(ms)
        picked = [logits[:, 0].float()]
        for t in range(steps):
            (logits, state), ms = _synced_ms(model.decode_step, params,
                                             state, gen[:, t:t + 1],
                                             inplace=True)
            step_ms.append(ms)
            if t + 1 < steps:
                picked.append(logits[:, 0].float())
        picked = torch.stack(picked, dim=1)                   # (B, steps, V)
    if not torch.equal(gen.long(), picked.argmax(-1)):
        raise AssertionError("ServeEngine: the replayed steps pick other "
                             "tokens than generate")
    p50 = float(np.median(step_ms))
    return ({"prompts": b, "prompt_len": plen, "steps": steps,
             "s_max": s_max, "generate_ms": gen_ms,
             "generate_tokens_per_s": b * steps / (gen_ms / 1e3),
             "prefill_ms": pre_ms,
             "prefill_p50_ms": float(np.median(pre_ms)),
             "decode_ms": step_ms, "decode_p50_ms": p50,
             "decode_tokens_per_s": b / (p50 / 1e3), "peak_bytes": peak},
            gen, picked, state)


def lm_engine(model, params, seed: int):
    """Phase 15 (3): ServeEngine on qwen2.5-3b: KNNLM_PROMPTS prompts of
    KNNLM_PROMPT_LEN tokens, KNNLM_STEPS greedy steps
    (:func:`engine_timings`).  The logits that picked each token are held
    to the teacher-forced ``forward`` over prompt + generated tokens at its
    position: no farther from it than the farther of the two is from the
    float32 forward (bf16 runs of another shape round in another order).
    Each token is that forward's argmax wherever its top-2 margin exceeds
    twice the replay's largest |difference| in its row (there the two
    argmaxes must agree).  Prefill ms, decode ms a step (p50), tokens/s,
    peak memory, and the decode step beside the bytes it must move (every
    weight in its stored dtype, the filled caches)."""
    import dataclasses
    import torch
    from repro_torch.data.tokens import TokenStream, _batch_at
    from repro_torch.models import build_model

    cfg = model.cfg
    b, plen, steps = KNNLM_PROMPTS, KNNLM_PROMPT_LEN, KNNLM_STEPS
    prompts = torch.from_numpy(_batch_at(TokenStream(
        cfg.vocab_size, plen + 1, b, seed + 7, 0, 1), 0)["tokens"]).cuda()
    facts, gen, picked, state = engine_timings(model, params, prompts,
                                               steps)
    with torch.inference_mode():
        seq = torch.cat([prompts, gen.long()], 1)
        window = slice(plen - 1, plen - 1 + steps)
        tf = model.forward(params, seq)[0][:, window].float()
        f32 = build_model(dataclasses.replace(cfg, dtype="float32")).forward(
            params, seq)[0][:, window]
    pair, replay_err, tf_err = bf16_pair_err(picked, tf, f32)
    del f32
    if pair > max(replay_err, tf_err):
        raise AssertionError(f"ServeEngine: replayed logits {pair} from the "
                             f"teacher-forced ones, beyond their errors from "
                             f"f32 ({replay_err}, {tf_err})")
    eps = (picked - tf).abs().amax(dim=-1)                    # (B, steps)
    top2 = torch.topk(tf, 2, dim=-1).values
    checked = top2[..., 0] - top2[..., 1] > 2 * eps
    agree = gen.long() == tf.argmax(-1)
    if not bool(agree[checked].all()):
        raise AssertionError(f"ServeEngine: {int((~agree & checked).sum())} "
                             f"greedy tokens differ from the teacher-forced "
                             f"argmax")
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    cache_bytes = sum(t.numel() * t.element_size() for t in state.caches)
    bound_ms = (w_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    return {**facts,
            "decode_bound_ms": bound_ms, "decode_bound_by": "bytes",
            "decode_bound_bytes": {"weights": w_bytes, "caches": cache_bytes},
            "max_abs_replay_teacher": pair, "max_abs_replay_f32": replay_err,
            "max_abs_teacher_f32": tf_err,
            "tokens_checked": int(checked.sum()),
            "tokens_near_tie": int((~checked).sum()),
            "tokens_equal_teacher_argmax": int(agree.sum())}, state


def knnlm_datastore(model, params, seed: int, n_batches: int):
    """Phase 15 (4): ``build_datastore`` over ``n_batches`` TokenStream
    batches, degree 16, l2, build_batch BUILD_BATCH, rowgather: forward and
    build seconds, tokens/s, the build's stage seconds, peak memory,
    launches (l2dist_rowgather only) and the (B, C) its gathers took."""
    import torch
    from repro_torch.data.tokens import TokenStream, _batch_at
    from repro_torch.serve import knnlm as tk

    stream = TokenStream(model.cfg.vocab_size, KNNLM_SEQ_LEN,
                         KNNLM_STREAM_BATCH, seed, 0, 1)
    batches = [torch.from_numpy(_batch_at(stream, i)["tokens"]).cuda()
               for i in range(n_batches)]
    real, fwd_ms, seen = tk._final_hidden, [], set()

    def timed(*a, **kw):
        out, ms = _synced_ms(real, *a, **kw)
        fwd_ms.append(ms)
        return out
    tk._final_hidden = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with StageClock() as clock, recording_shapes(seen):
            t0 = time.perf_counter()
            ds, launches = counted(
                tk.build_datastore, model, params, batches,
                model.cfg.vocab_size, degree=KNNLM_DEGREE, metric="l2",
                build_batch=BUILD_BATCH, build_backend="rowgather")
            total = time.perf_counter() - t0
    finally:
        tk._final_hidden = real
    check_launches({"knnlm_build/rowgather": launches})
    fwd_s = sum(fwd_ms) / 1e3
    tokens = sum(int(t.numel()) for t in batches)
    return ds, stream, seen, {
        "batches": n_batches, "tokens": tokens, "keys": ds.graph.n_nodes,
        "d": ds.graph.dim, "keys_bytes": ds.graph.vectors.numel() * 4,
        "forward_seconds": fwd_s, "forward_tokens_per_s": tokens / fwd_s,
        "build_seconds": total - fwd_s, "stage_seconds": clock.seconds,
        "total_seconds": total,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "mean_out_degree": float((ds.graph.nbrs < ds.graph.n_nodes)
                                 .sum(dim=1).double().mean())}


def knnlm_queries(model, params, stream, first_step: int):
    """KNNLM_QUERIES held-out prompts of KNNLM_QUERY_LEN tokens (rows of
    the stream's later steps), their last hidden states and last LM
    logits."""
    import torch
    from repro_torch.data.tokens import _batch_at
    from repro_torch.serve import knnlm as tk

    steps = KNNLM_QUERIES // KNNLM_STREAM_BATCH
    qs = torch.from_numpy(np.concatenate([
        _batch_at(stream, first_step + i)["tokens"][:, :KNNLM_QUERY_LEN]
        for i in range(steps)])).cuda()
    with torch.inference_mode():
        hidden = tk._final_hidden(model, params, qs)[:, -1]
        lm = model.forward(params, qs)[0][:, -1]
    return qs, hidden, lm


def knnlm_retrieval(ds, hidden, lm, seen, path_launches):
    """Phase 15 (5): ``knnlm_logits`` (λ = 0.25, τ = 10) through ref,
    rowgather, dma and dedup_gather: each kernel backend launching its own
    kernel only, ref none; mixed log-probs finite, their exp summing to 1 ±
    1e-3 a row; every id below N; each backend's distances the exact f32
    distances of its ids (1e-5 relative); recall@16 against the exact kNN
    within 0.02 of ref's.  The first KNNLM_CPU_QUERIES rows equal the CPU's
    ``knnlm_logits`` on the saved datastore: ids equal but at near-ties
    (equal distance lists), log-probs within 2·1e-5·max(dist)/τ + 1e-4 (a
    1e-5 relative distance error moves the exponent by that much)."""
    import torch
    from repro_torch.ann import AnnIndex, SearchParams
    from repro_torch.core import recall_at_k
    from repro_torch.serve import knnlm as tk

    params = SearchParams(k=16, queue_len=128, m_max=8,
                          num_walkers=KNNLM_WALKERS, algorithm="speedann")
    n = ds.graph.n_nodes
    keys = ds.graph.vectors
    hq = hidden.float()
    gt, _ = ds.index.exact(hq, 16)
    out, res = {}, {}
    for be in BACKENDS:
        p = params.with_(backend=be)
        with (recording_shapes(seen) if be == "rowgather"
              else contextlib.nullcontext()):
            (mixed, ids), path_launches[f"knnlm/{be}"] = counted(
                tk.knnlm_logits, ds, hidden, lm, p, lam=KNNLM_LAM,
                tau=KNNLM_TAU)
        sr = ds.index.search(hq, p)
        if not torch.equal(sr.ids, ids):
            raise AssertionError(f"knnlm {be}: search ids differ from "
                                 f"knnlm_logits' ids")
        if not bool(torch.isfinite(mixed).all()):
            raise AssertionError(f"knnlm {be}: mixed log-probs not finite")
        total = mixed.double().exp().sum(-1)
        if float((total - 1).abs().max()) > 1e-3:
            raise AssertionError(f"knnlm {be}: probabilities sum to "
                                 f"{total.min().item()}..{total.max().item()}")
        if not bool((ids < n).all()) or not bool((ids >= 0).all()):
            raise AssertionError(f"knnlm {be}: an id outside [0, N)")
        exact = ((keys[ids.long()].double() - hq.double()[:, None]) ** 2
                 ).sum(-1)
        rel = float(((sr.dists.double() - exact).abs()
                     / exact.clamp(min=1e-30)).max())
        if rel > 1e-5:
            raise AssertionError(f"knnlm {be}: distances {rel} off the "
                                 f"exact f32 distances of their ids")
        recall = recall_at_k(ids.cpu(), gt.cpu(), 16)
        res[be] = (mixed, ids, sr.dists)
        out[be] = {"recall_at_16": recall, "max_rel_dist_err": rel,
                   "launches": path_launches[f"knnlm/{be}"],
                   "prob_sum_max_err": float((total - 1).abs().max())}
    for be in BACKENDS[1:]:
        if abs(out[be]["recall_at_16"] - out["ref"]["recall_at_16"]) > 0.02:
            raise AssertionError(f"knnlm {be}: recall@16 "
                                 f"{out[be]['recall_at_16']} against ref's "
                                 f"{out['ref']['recall_at_16']}")
    check_launches({p: path_launches[p] for p in path_launches
                    if p.startswith("knnlm/")})

    # the first rows against the CPU on the saved datastore
    k = KNNLM_CPU_QUERIES
    with tempfile.TemporaryDirectory() as tmp:
        path = ds.index.save(os.path.join(tmp, "datastore.npz"))
        cpu_ds = tk.KNNLMDatastore(AnnIndex.load(path, device="cpu"),
                                   ds.values.cpu(), ds.vocab_size)
    p = params.with_(backend="rowgather")
    c_mixed, c_ids = tk.knnlm_logits(cpu_ds, hidden[:k].cpu(), lm[:k].cpu(),
                                     p, lam=KNNLM_LAM, tau=KNNLM_TAU)
    c_dists = cpu_ds.index.search(hq[:k].cpu(), p).dists
    g_mixed, g_ids, g_dists = (t[:k].cpu() for t in res["rowgather"])
    same = (c_ids == g_ids).all(dim=1)
    near = (c_dists - g_dists).abs() <= 1e-5 * c_dists.abs()
    if not bool(near[~same].all()):
        raise AssertionError("knnlm: card ids differ from the CPU's beyond "
                             "near-ties")
    tol = 2 * 1e-5 * float(c_dists.max()) / KNNLM_TAU + 1e-4
    err = float((c_mixed[same] - g_mixed[same]).abs().max()) \
        if bool(same.any()) else 0.0
    if not bool(same.any()) or err > tol:
        raise AssertionError(f"knnlm: card log-probs {err} off the CPU's "
                             f"(tolerance {tol}; rows equal {same.tolist()})")
    out["cpu"] = {"rows": k, "rows_ids_equal": int(same.sum()),
                  "max_abs_logprob_err": err, "tolerance": tol}
    return out, params


def knnlm_timings(model, params, ds, qs, sparams):
    """Phase 15 (6): each part of one kNN-LM call over the held-out
    prompts (LM forward, hidden states, retrieval through rowgather, the
    mix), p50 of KNNLM_REPS, then the whole call under torch.profiler."""
    import torch
    from repro_torch.serve import knnlm as tk

    p = sparams.with_(backend="rowgather")
    index = ds.index
    parts = {"lm_forward": [], "hidden": [], "retrieval": [], "mix": []}

    def timed_search(*a, **kw):
        out, ms = _synced_ms(type(index).search, index, *a, **kw)
        parts["retrieval"].append(ms)
        return out

    def call(record: bool):
        with torch.inference_mode():
            lm, ms_f = _synced_ms(lambda: model.forward(params, qs)[0][:, -1])
            h, ms_h = _synced_ms(
                lambda: tk._final_hidden(model, params, qs)[:, -1])
            _, ms_k = _synced_ms(tk.knnlm_logits, ds, h, lm, p,
                                 lam=KNNLM_LAM, tau=KNNLM_TAU)
        if record:
            parts["lm_forward"].append(ms_f)
            parts["hidden"].append(ms_h)
            parts["mix"].append(ms_k - parts["retrieval"][-1])

    index.search = timed_search
    try:
        call(False)
        parts["retrieval"].clear()
        for _ in range(KNNLM_REPS):
            call(True)
    finally:
        del index.search
    out = {k: {"p50_ms": float(np.median(v)), "ms": v}
           for k, v in parts.items()}
    out["call_p50_ms"] = sum(v["p50_ms"] for v in out.values())
    out["profile_call"] = profile_call(lambda: call(False), "rowgather")
    return out


def knnlm_phase(seed: int, smi, n_batches: int = KNNLM_BATCHES):
    """Phase 15: qwen2.5-3b at full width and depth on the card (random
    weights from ``seed``); the port's CausalLM on the card against the
    CPU at 2 layers; ServeEngine; the kNN-LM datastore of ``n_batches``
    stream batches (8,192 keys each) built through l2dist_rowgather; the
    retrieval and mix through every f32 backend; the call's split and its
    profile.  Returns (the phase's line, its path launches)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    cfg = get_config(KNNLM_ARCH)
    out = {"phase": "knnlm", "arch": cfg.name, "card": smi}
    out["card_vs_cpu_2_layers"] = lm_card_vs_cpu(cfg, seed)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params, init_ms = _synced_ms(
        model.init, torch.Generator(device="cuda").manual_seed(seed))
    out["model"] = {
        "layers": cfg.num_layers, "d_model": cfg.d_model,
        "params": sum(p.numel() for p in params.parameters()),
        "param_count": cfg.param_count(),
        "param_bytes": sum(p.numel() * p.element_size()
                           for p in params.parameters()),
        "param_dtype": cfg.param_dtype, "dtype": cfg.dtype,
        "init_ms": init_ms, "peak_bytes": torch.cuda.max_memory_allocated()}
    out["engine"], state = lm_engine(model, params, seed)
    tok = torch.zeros((KNNLM_PROMPTS, 1), dtype=torch.long, device="cuda")
    st = [state._replace(pos=state.pos - KNNLM_STEPS)]

    def decode():
        with torch.inference_mode():
            st[0] = model.decode_step(params, st[0], tok, inplace=True)[1]
    out["engine"]["profile_decode_step"] = profile_call(decode, "rowgather")
    del state, st
    torch.cuda.empty_cache()
    path_launches = {}
    ds, stream, seen, out["datastore"] = knnlm_datastore(model, params, seed,
                                                         n_batches)
    path_launches["knnlm_build/rowgather"] = out["datastore"]["launches"]
    qs, hidden, lm = knnlm_queries(model, params, stream, n_batches)
    out["retrieval"], sparams = knnlm_retrieval(ds, hidden, lm, seen,
                                                path_launches)
    unchecked = seen - set(knnlm_gather_shapes(ds.graph.n_nodes))
    if not seen or unchecked:
        raise AssertionError(f"knnlm gather shapes outside phase 3's: "
                             f"{sorted(unchecked) or 'none recorded'}")
    out["gather_shapes"] = len(seen)
    out["timings"] = knnlm_timings(model, params, ds, qs, sparams)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t_phase
    del model, params, ds, hidden, lm, qs
    torch.cuda.empty_cache()
    return out, path_launches


def _leaf_items(tree):
    from repro_torch.treepath import flatten_with_path, keystr_simple
    return [(keystr_simple(p), x) for p, x in flatten_with_path(tree)]


def _stream_batch(cfg, rows: int, seq: int, seed: int, step: int, device):
    from repro_torch.data.tokens import TokenStream, _batch_at
    import torch
    batch = _batch_at(TokenStream(cfg.vocab_size, seq + 1, rows, seed, 0, 1),
                      step)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train_card_vs_cpu(cfg, seed: int):
    """Phase 16 (1): qwen2.5-3b at full width, 2 layers, f32, one batch of
    2 × 64 tokens: the card's loss and global gradient norm within 1e-4
    relative of the CPU's and every gradient leaf within 1e-4 of its
    largest magnitude; AdamW fed the CPU's gradients gives the CPU's
    update and moments on the card (1e-6 relative, of each leaf's
    largest)."""
    import dataclasses
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_update, global_norm
    from repro_torch.train.train_step import (_zeros, init_train_state,
                                              loss_and_grad)
    from repro_torch.treepath import tree_map

    small = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    tcfg = TrainConfig(total_steps=10, warmup_steps=2, learning_rate=3e-3)
    m_cpu = build_model(small, device="cpu")
    state = init_train_state(m_cpu, torch.Generator().manual_seed(seed),
                             tcfg)
    card = tree_map(lambda t: t.cuda(), state)
    batch = _stream_batch(small, 2, 64, seed + 11, 0, "cpu")
    g_cpu, g_card = _zeros(state.params), _zeros(card.params)
    loss_cpu = float(loss_and_grad(m_cpu, state.params, batch, True, g_cpu))
    loss_card = float(loss_and_grad(build_model(small), card.params,
                                    {k: v.cuda() for k, v in batch.items()},
                                    True, g_card))
    n_cpu, n_card = float(global_norm(g_cpu)), float(global_norm(g_card))
    rel = {"loss": abs(loss_card - loss_cpu) / abs(loss_cpu),
           "grad_norm": abs(n_card - n_cpu) / n_cpu}
    worst = max((float((a.cpu() - b).abs().max() / b.abs().max()), k)
                for (k, a), (_, b) in zip(_leaf_items(g_card),
                                          _leaf_items(g_cpu)))
    if max(rel.values()) > 1e-4 or worst[0] > 1e-4:
        raise AssertionError(f"train card vs CPU: {rel}, gradient {worst}")
    want = adamw_update(g_cpu, state.opt, state.params, tcfg)
    got = adamw_update(tree_map(lambda t: t.cuda(), g_cpu), card.opt,
                       card.params, tcfg)
    upd = max((float((a.cpu() - b).abs().max() / b.abs().max()), k)
              for (k, a), (_, b) in zip(_leaf_items(got), _leaf_items(want))
              if b.abs().max() > 0)
    if upd[0] > 1e-6:
        raise AssertionError(f"adamw on the card vs the CPU: {upd}")
    del state, card, g_cpu, g_card, want, got
    torch.cuda.empty_cache()
    return {"layers": 2, "tokens": 2 * 64, "loss": loss_card,
            "rel_err": rel, "max_grad_err_rel_to_leaf_max": worst[0],
            "max_adamw_err_rel_to_leaf_max": upd[0],
            "tolerance": {"loss_grads": 1e-4, "adamw": 1e-6}}


def train_bound(cfg, params, tokens: int, rows: int, seq: int):
    """The least time one step could take: its operations over the bf16
    peak (layers 8·N·T with remat: forward, recompute, two backward
    products; the tied head 6·d·V·T; causal attention's two products,
    4 passes, half of S²) against its bytes over HBM's rate (AdamW reads
    params, gradients and both moments and writes params and moments:
    7 × the f32 parameter bytes)."""
    from repro_torch.treepath import tree_leaves
    n_layers = sum(t.numel() for t in tree_leaves(params["layers"]))
    p_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    attn = (8 * cfg.num_layers * rows * cfg.num_heads
            * cfg.resolved_head_dim * seq * seq)
    flops = 8 * n_layers * tokens + 6 * cfg.d_model * cfg.vocab_size \
        * tokens + attn
    nbytes = 7 * p_bytes
    ms = {"operations": flops / BF16_FLOP_PER_S * 1e3,
          "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    by = max(ms, key=ms.get)
    return {"bound_ms": ms[by], "bound_by": by, "flops": flops,
            "bytes": nbytes, "operations_ms": ms["operations"],
            "bytes_ms": ms["bytes"]}


def train_full(cfg, seed: int):
    """Phase 16 (2): qwen2.5-3b at full width and depth (f32 storage, bf16
    compute, AdamW f32 moments, remat "full") through make_train_step: one
    warm step, TRAIN_STEPS timed steps (their launches counted: none of the
    six kernels), one profiled, one with microbatches = 2 whose loss is
    held within 1e-3, and its gradient norm within 1e-2 relative, of the
    unsplit batch's at the same parameters (one unsplit forward and
    backward, which the unsplit step would report)."""
    import dataclasses
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.optim import global_norm
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import (_zeros, init_train_state,
                                              loss_and_grad)

    torch.cuda.reset_peak_memory_stats()
    tcfg = TrainConfig(total_steps=100, warmup_steps=2, learning_rate=3e-4)
    model = build_model(cfg)
    (state, init_ms) = _synced_ms(
        init_train_state, model,
        torch.Generator(device="cuda").manual_seed(seed), tcfg)
    step = make_train_step(model, tcfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def batch(i):
        return _stream_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed + 13, i,
                             "cuda")
    st = [state]
    del state
    metrics = []

    def run(i):
        st[0], m = step(st[0], batch(i))
        metrics.append({k: float(v) for k, v in m.items()})

    _, warm_ms = _synced_ms(run, 0)
    step_ms = []

    def timed():
        for i in range(1, 1 + TRAIN_STEPS):
            step_ms.append(_synced_ms(run, i)[1])
    _, launches = counted(timed)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    first = losses[0]
    ln_v = float(np.log(cfg.vocab_size))
    if not all(np.isfinite(losses)) or abs(first - ln_v) > 0.5:
        raise AssertionError(f"train losses {losses}, ln V = {ln_v}")
    nxt = [1 + TRAIN_STEPS]

    def one_step():
        run(nxt[0])
        nxt[0] += 1
    prof = profile_call(one_step, None)
    mb = batch(nxt[0])
    grads = _zeros(st[0].params)
    unsplit = float(loss_and_grad(model, st[0].params, mb, True, grads))
    unsplit_norm = float(global_norm(grads))
    del grads
    mb_step = make_train_step(model, dataclasses.replace(tcfg,
                                                         microbatches=2))
    st[0], m_mb = mb_step(st[0], mb)
    norm_rel = abs(float(m_mb["grad_norm"]) - unsplit_norm) / unsplit_norm
    if abs(float(m_mb["loss"]) - unsplit) > 1e-3 or norm_rel > 1e-2:
        raise AssertionError(f"microbatches=2 loss {float(m_mb['loss'])}, "
                             f"unsplit {unsplit}; gradient norm "
                             f"{float(m_mb['grad_norm'])}, unsplit "
                             f"{unsplit_norm}")
    p50 = float(np.median(step_ms))
    out = {"layers": cfg.num_layers, "d_model": cfg.d_model,
           "param_dtype": cfg.param_dtype, "dtype": cfg.dtype,
           "optimizer": tcfg.optimizer, "moment_dtype": tcfg.moment_dtype,
           "remat": tcfg.remat, "rows": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "params": sum(t.numel() for _, t in _leaf_items(st[0].params)),
           "init_ms": init_ms, "warm_step_ms": warm_ms, "step_ms": step_ms,
           "step_p50_ms": p50, "tokens_per_s": tokens / (p50 / 1e3),
           "peak_bytes": peak, "losses": losses,
           "grad_norms": [m["grad_norm"] for m in metrics],
           "ln_vocab": ln_v, "launches": launches, "profile_step": prof,
           "microbatches_2": {"loss": float(m_mb["loss"]),
                              "unsplit_loss": unsplit,
                              "grad_norm": float(m_mb["grad_norm"]),
                              "unsplit_grad_norm": unsplit_norm,
                              "grad_norm_rel_err": norm_rel,
                              "tolerance": {"loss": 1e-3,
                                            "grad_norm_rel": 1e-2}},
           **train_bound(cfg, st[0].params, tokens, TRAIN_BATCH,
                         TRAIN_SEQ)}
    del st, model, step, mb_step, mb
    torch.cuda.empty_cache()
    return out, launches


def train_recovery(cfg, seed: int):
    """Phase 16 (3): the Trainer at full width and 2 layers (bf16 compute,
    AdamW f32), TRAIN_RUN_STEPS steps of 4 × 128 tokens, a checkpoint
    every TRAIN_CKPT_EVERY steps (keep 1), run clean and then with a
    failure before step TRAIN_FAIL_AT: the final parameters equal, bit for
    bit (else within 1e-5, recorded); the checkpoints' bytes, their
    background saves' seconds and the recovery's restore seconds."""
    import dataclasses
    import shutil
    import torch
    import repro_torch.checkpoint.ckpt as ckpt_mod
    from repro_torch.config import TrainConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import build_model
    from repro_torch.runtime import FailureInjector
    from repro_torch.train import Trainer
    from repro_torch.treepath import tree_leaves

    small = dataclasses.replace(cfg, num_layers=2)
    model = build_model(small)
    stream = TokenStream(small.vocab_size, 129, 4, seed + 17, 0, 1)
    out = {"layers": 2, "steps": TRAIN_RUN_STEPS, "rows": 4, "seq": 128,
           "checkpoint_every": TRAIN_CKPT_EVERY, "fail_at": TRAIN_FAIL_AT}
    save, saves, restores = ckpt_mod.save_checkpoint, [], []

    def timed_save(*a, **kw):        # the manager's background thread
        t0 = time.perf_counter()
        path = save(*a, **kw)
        saves.append(time.perf_counter() - t0)
        return path
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainConfig(total_steps=TRAIN_RUN_STEPS, warmup_steps=2,
                           learning_rate=3e-4, seed=seed,
                           checkpoint_every=TRAIN_CKPT_EVERY,
                           keep_checkpoints=1, checkpoint_dir=tmp)
        ckpt_mod.save_checkpoint = timed_save
        try:
            (clean, clean_ms) = _synced_ms(Trainer(model, tcfg, stream).run)
            shutil.rmtree(tmp)
            inj = FailureInjector([TRAIN_FAIL_AT])
            tr = Trainer(model, tcfg, stream)
            restore = tr.ckpt.restore_latest

            def timed_restore(like):
                got, ms = _synced_ms(restore, like)
                restores.append(ms / 1e3)
                return got
            tr.ckpt.restore_latest = timed_restore
            (faulty, faulty_ms) = _synced_ms(tr.run, fault_hook=inj)
        finally:
            ckpt_mod.save_checkpoint = save
        nbytes = os.path.getsize(os.path.join(
            tmp, f"step_{TRAIN_RUN_STEPS:08d}", "arrays.npz"))
    if inj.fired != {TRAIN_FAIL_AT} or int(faulty.opt["step"]) \
            != TRAIN_RUN_STEPS:
        raise AssertionError(f"recovery: fired {inj.fired}, step "
                             f"{int(faulty.opt['step'])}")
    pairs = list(zip(tree_leaves(clean.params), tree_leaves(faulty.params)))
    equal = all(torch.equal(a, b) for a, b in pairs)
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    if diff > 1e-5:
        raise AssertionError(f"recovered params {diff} from clean")
    out.update(clean_run_ms=clean_ms, recovered_run_ms=faulty_ms,
               recovered_equals_clean_bitwise=equal,
               recovered_max_abs_diff=diff, checkpoint_bytes=nbytes,
               save_s=saves, restore_s=restores)
    del clean, faulty, tr, pairs, model
    torch.cuda.empty_cache()
    return out


def _check_close(got: dict, want: dict, rel: float, what: str) -> float:
    """The largest |got - want| over all leaves relative to each leaf's
    largest |want|; raises above ``rel``."""
    worst = max((float((got[k] - want[k]).abs().max()
                       / want[k].abs().max().clamp(min=1e-30)), k)
                for k in want)
    if worst[0] > rel:
        raise AssertionError(f"{what}: {worst} above {rel}")
    return worst[0]


def train_first_moments(cfg, seed: int):
    """Phase 16 (4): qwen2.5-3b at full width, 2 layers, f32, one batch of
    8 × 64 tokens, three first steps from one state (AdamW, int8
    residuals): unsplit, microbatches = 2, and the compressed step on a
    4-lane ``data`` axis.  A first step's moment is m = (1 - b1)·c·g (c
    the clip scale), linear in the gradient, so g is read back from it.
    Microbatched: its m within 1e-5 of the unsplit step's (relative to each
    leaf's largest).  Compressed: tests/elastic_compress_check.py's bounds
    (loss 1e-3, params 5e-3, residuals non-zero); its g within half an int8
    step (the leaf's largest lane gradient / 127) of the exact g entry by
    entry, and equal to it within 1e-5 once the lanes' mean residual is
    added back; each lane's residual within half a step of its own
    gradient (taken here, lane by lane) and a whole number of steps away
    from it."""
    import dataclasses
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import (_zeros, init_train_state,
                                              loss_and_grad,
                                              make_compressed_dp_train_step)
    from repro_torch.treepath import tree_leaves, tree_map

    small = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    model = build_model(small)
    tcfg = TrainConfig(grad_compression="int8", learning_rate=1e-3,
                       warmup_steps=1, total_steps=10)
    state = init_train_state(model, torch.Generator(
        device="cuda").manual_seed(seed), tcfg)
    batch = _stream_batch(small, 8, 64, seed + 19, 0, "cuda")

    def first(step, **kw):
        new, m = step(tree_map(torch.clone, state), batch)
        c = min(1.0, tcfg.grad_clip / max(float(m["grad_norm"]), 1e-6))
        g = {k: v / ((1 - tcfg.beta1) * c)
             for k, v in _leaf_items(new.opt["m"])}
        return new, {k: float(v) for k, v in m.items()}, g

    se, me, g_e = first(make_train_step(model, tcfg))
    p_exact = dict(_leaf_items(se.params))
    del se
    out = {"layers": 2, "rows": 8, "seq": 64}
    s2, m2, g_2 = first(make_train_step(
        model, dataclasses.replace(tcfg, microbatches=2)))
    out["microbatches_2"] = {
        "loss_diff": abs(m2["loss"] - me["loss"]),
        "max_m_err_rel_to_leaf_max": _check_close(
            dict(_leaf_items(s2.opt["m"])),
            {k: v * (1 - tcfg.beta1) * min(1.0, tcfg.grad_clip
                                           / me["grad_norm"])
             for k, v in g_e.items()}, 1e-5, "microbatches=2 first moment"),
        "tolerance": {"loss": 1e-3, "m": 1e-5}}
    if out["microbatches_2"]["loss_diff"] > 1e-3:
        raise AssertionError(f"microbatches=2 loss {m2['loss']}, unsplit "
                             f"{me['loss']}")
    del s2, g_2
    sc, mc, g_c = first(make_compressed_dp_train_step(
        model, tcfg, make_host_mesh(4, 1)))
    loss_diff = abs(mc["loss"] - me["loss"])
    p_diff = max(float((a - p_exact[k]).abs().max())
                 for k, a in _leaf_items(sc.params))
    resid = sum(float(e.abs().sum()) for e in tree_leaves(sc.err))
    if loss_diff >= 1e-3 or p_diff >= 5e-3 or not resid > 0:
        raise AssertionError(f"compressed step: loss {loss_diff}, params "
                             f"{p_diff}, residual {resid}")
    err = dict(_leaf_items(sc.err))
    lanes = []
    for i in range(4):
        g = _zeros(state.params)
        loss_and_grad(model, state.params,
                      {k: v[2 * i:2 * i + 2] for k, v in batch.items()},
                      True, g)
        lanes.append(dict(_leaf_items(g)))
    worst = {"payload_err_in_half_steps": 0.0, "lane_off_whole_steps": 0.0,
             "lane_residual_in_half_steps": 0.0}
    for k in g_e:
        step = max(float(lane[k].abs().max()) for lane in lanes) / 127
        if step == 0:
            continue
        tol = 1e-5 * float(g_e[k].abs().max())
        worst["payload_err_in_half_steps"] = max(
            worst["payload_err_in_half_steps"],
            float((g_c[k] - g_e[k]).abs().max() - tol) / (step / 2))
        for i, lane in enumerate(lanes):
            q = (lane[k] - err[k][i]) / step
            worst["lane_off_whole_steps"] = max(
                worst["lane_off_whole_steps"],
                float((q - q.round()).abs().max()))
            worst["lane_residual_in_half_steps"] = max(
                worst["lane_residual_in_half_steps"],
                float(err[k][i].abs().max()) / (step / 2))
    # g / step and q·step round at |g| <= 127 steps: an ulp there is
    # 1.5e-5 of a half step, so a residual may pass s/2 by a few of them
    lim = {"payload_err_in_half_steps": 1 + 1e-4,
           "lane_off_whole_steps": 1e-3,
           "lane_residual_in_half_steps": 1 + 1e-4}
    if any(worst[k] > lim[k] for k in lim):
        raise AssertionError(f"compressed step: {worst} against {lim}")
    with_err = _check_close(
        {k: g_c[k] + err[k].mean(dim=0) for k in g_c}, g_e, 1e-5,
        "compressed gradient + mean residual")
    out["compressed_4_lanes"] = {
        "loss_diff": loss_diff, "max_param_diff": p_diff,
        "residual_abs_sum": resid, **worst,
        "max_g_plus_residual_err_rel_to_leaf_max": with_err,
        "bounds": {"loss": 1e-3, "params": 5e-3, **lim,
                   "g_plus_residual": 1e-5}}
    del state, sc, lanes, err, g_c, g_e, p_exact, model
    torch.cuda.empty_cache()
    return out


def train_phase(seed: int, smi):
    """Phase 16: training qwen2.5-3b on the card.  Returns (the phase's
    line, its path launches)."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    out = {"phase": "train", "arch": cfg.name, "card": smi}
    t0 = time.perf_counter()
    out["card_vs_cpu_2_layers"] = train_card_vs_cpu(cfg, seed)
    out["card_vs_cpu_2_layers"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["full"], launches = train_full(cfg, seed)
    out["full"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["trainer_2_layers"] = train_recovery(cfg, seed)
    out["trainer_2_layers"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["first_moments_2_layers"] = train_first_moments(cfg, seed)
    out["first_moments_2_layers"]["seconds"] = time.perf_counter() - t0
    path_launches = {"train/ref": launches}
    check_launches(path_launches)
    out["seconds"] = time.perf_counter() - t_phase
    return out, path_launches

@contextlib.contextmanager
def routing_record(calls: list):
    """Inside the block, every routing of ``models.moe.moe_ffn`` appends
    (its top-k experts, sorted per token; each token's gap between its
    k-th and (k+1)-th probability; its k-th probability) to ``calls``."""
    import torch
    from repro_torch.models import moe
    route = moe.route

    def recording(x, router, k):
        probs, top_p, top_e = route(x, router, k)
        top = torch.topk(probs.detach(), k + 1, dim=-1).values
        calls.append((top_e.sort(-1).values, top[..., k - 1] - top[..., k],
                      top[..., k - 1]))
        return probs, top_p, top_e
    moe.route = recording
    try:
        yield calls
    finally:
        moe.route = route


def moe_card_vs_cpu(cfg, seed: int):
    """Phase 17 (a): qwen3-moe-30b-a3b at full width and 2 layers, f32,
    one batch of MOE_CHECK_ROWS × MOE_CHECK_SEQ tokens: the card's forward
    logits within rtol = atol = 1e-4 of the CPU's and its aux loss within
    1e-6; the loss within 1e-4 relative and every gradient leaf (the
    router and the three expert stacks among them) within 1e-4 of its
    largest magnitude (phase 16's bars).  The weights are drawn on the
    card and copied to the CPU.  The smallest gap between a token's k-th
    and (k+1)-th expert probability is recorded: a gap below the two
    devices' rounding would route a token differently."""
    import dataclasses
    import torch
    from repro_torch.models import build_model
    from repro_torch.train.train_step import _zeros, loss_and_grad
    from repro_torch.treepath import tree_map

    small = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    m_card, m_cpu = build_model(small), build_model(small, device="cpu")
    card = m_card.init_tree(torch.Generator(device="cuda").manual_seed(seed))
    cpu = tree_map(lambda t: t.cpu(), card)
    batch = _stream_batch(small, MOE_CHECK_ROWS, MOE_CHECK_SEQ, seed + 19,
                          0, "cpu")
    batch_g = {k: v.cuda() for k, v in batch.items()}
    calls = []
    with torch.inference_mode():
        with routing_record(calls):
            want, aux_cpu = m_cpu.forward(cpu, batch["tokens"])
        got, aux_card = m_card.forward(card, batch_g["tokens"])
    gap = min(float(g.min()) for _, g, _ in calls)
    logit_err = float((got.cpu() - want).abs().max())
    aux_err = abs(float(aux_card) - float(aux_cpu))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4,
                               msg=lambda m: f"moe logits, card vs CPU "
                               f"(smallest routing gap {gap}): {m}")
    if aux_err > 1e-6:
        raise AssertionError(f"moe aux, card vs CPU: {aux_err}")
    del want, got
    g_cpu, g_card = _zeros(cpu), _zeros(card)
    loss_cpu = float(loss_and_grad(m_cpu, cpu, batch, True, g_cpu))
    loss_card = float(loss_and_grad(m_card, card, batch_g, True, g_card))
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    worst = max((float((a.cpu() - b).abs().max() / b.abs().max()), k)
                for (k, a), (_, b) in zip(_leaf_items(g_card),
                                          _leaf_items(g_cpu)))
    if rel > 1e-4 or worst[0] > 1e-4:
        raise AssertionError(f"moe train card vs CPU: loss {rel}, "
                             f"gradient {worst}")
    moe_leaves = sorted(k for k, _ in _leaf_items(g_card)
                        if k.startswith("layers/moe/"))
    del card, cpu, g_cpu, g_card
    torch.cuda.empty_cache()
    return {"layers": 2, "tokens": MOE_CHECK_ROWS * MOE_CHECK_SEQ,
            "max_abs_logit_err": logit_err, "aux": float(aux_card),
            "aux_abs_err": aux_err, "loss": loss_card, "loss_rel_err": rel,
            "max_grad_err_rel_to_leaf_max": worst[0],
            "worst_leaf": worst[1], "moe_leaves": moe_leaves,
            "min_routing_gap": gap,
            "tolerance": {"logits": 1e-4, "aux": 1e-6, "loss_grads": 1e-4}}


def moe_lanes(cfg, seed: int):
    """Phase 17 (b): ``moe_ffn_sharded`` on one full-width layer's
    experts (f32) and MOE_LANE_TOKENS tokens over each of MOE_LANE_MESHES:
    (2, 4) takes the a2a path (32 experts a position), (1, 3) the tp path
    (128 % 3 != 0; an f-slice of 768 / 3 = 256 a position).  At the
    config's capacity factor the card equals the CPU within 1e-5 of the
    output's largest magnitude (aux 1e-6); at capacity factor 8, where
    nothing drops, each equals ``moe_ffn`` on the card as closely.  A
    router of zeros routes every token to experts 0..k−1 (``lax.top_k``'s
    tie order).  The tokens are integers in [-3, 3] and the router a
    multiple of 2^-12, so every router logit is exact in f32 on both
    devices and both route alike."""
    import dataclasses
    import torch
    from repro_torch.core.distributed import make_search_mesh
    from repro_torch.models import moe, moe_a2a
    from repro_torch.sharding import DEFAULT_RULES, use_rules

    one = dataclasses.replace(cfg, num_layers=1, dtype="float32")
    eight = dataclasses.replace(one, moe=dataclasses.replace(
        one.moe, capacity_factor=8.0))
    p_card = moe.moe_init(torch.Generator(device="cuda").manual_seed(
        seed + 23), one, torch.float32)
    p_card["router"] = torch.round(p_card["router"] * 4096) / 4096
    p_cpu = {k: v.cpu() for k, v in p_card.items()}
    x_cpu = torch.randint(-3, 4, (1, MOE_LANE_TOKENS, cfg.d_model),
                          generator=torch.Generator().manual_seed(seed + 29)
                          ).float()
    x_card = x_cpu.cuda()

    def sharded(c, p, x, shape, dev):
        with use_rules(DEFAULT_RULES, make_search_mesh(shape, device=dev)):
            return moe_a2a.moe_ffn_sharded(p, x, c)
    out = {"tokens": MOE_LANE_TOKENS, "tolerance_rel": 1e-5,
           "aux_tolerance": 1e-6}
    with torch.inference_mode():
        # a router of zeros ties every probability: the lowest k experts
        _, _, tie_e = moe.route(x_card[0], torch.zeros_like(
            p_card["router"]), cfg.moe.top_k)
        if not torch.equal(tie_e, torch.arange(
                cfg.moe.top_k, device="cuda").expand_as(tie_e)):
            raise AssertionError("moe: tied probabilities route to other "
                                 "experts than 0..k-1")
        out["ties_route_to_lowest_experts"] = True
        y0, aux0 = moe.moe_ffn(p_card, x_card, eight)
        for shape in MOE_LANE_MESHES:
            path = "a2a" if cfg.moe.num_experts % shape[1] == 0 else "tp"
            name = f"{path}_{shape[0]}x{shape[1]}"
            want, aux_cpu = sharded(one, p_cpu, x_cpu, shape, "cpu")
            (got, aux_card), ms = _synced_ms(sharded, one, p_card, x_card,
                                             shape, "cuda")
            scale = float(want.abs().max())
            err = float((got.cpu() - want).abs().max()) / scale
            aux_err = abs(float(aux_card) - float(aux_cpu))
            y8, aux8 = sharded(eight, p_card, x_card, shape, "cuda")
            err8 = float((y8 - y0).abs().max() / y0.abs().max())
            aux8_err = abs(float(aux8) - float(aux0))
            if max(err, err8) > 1e-5 or max(aux_err, aux8_err) > 1e-6:
                raise AssertionError(
                    f"moe lanes {name}: card vs CPU {err} (aux {aux_err}); "
                    f"cf 8 vs moe_ffn {err8} (aux {aux8_err})")
            out[name] = {"path": path, "card_ms": ms,
                         "rel_err_card_cpu": err, "aux_err_card_cpu": aux_err,
                         "rel_err_cf8_vs_moe_ffn": err8,
                         "aux_err_cf8_vs_moe_ffn": aux8_err}
    del p_card, p_cpu, x_card, y0
    torch.cuda.empty_cache()
    return out


def moe_bounds(cfg, params, b: int, plen: int, state):
    """The least time of a decode step of ``b`` tokens and of a prefill of
    ``b`` × ``plen`` tokens.  Bytes: every weight read once, the embedding
    table only its ``b`` rows (dense-capacity dispatch runs every expert
    whenever each has a slot, as at decode, so every expert's weights are
    read), and the caches.  Operations (bf16 peak): the expert products
    over their capacity buffers (E · capacity slots, filled or not: the
    work the reference's dispatch does), the router, the attention
    projections, attention's two products, and the head at the last
    position."""
    from repro_torch.models.moe import _capacity

    emb = params.embedding
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    w_bytes += (b - emb.shape[0]) * emb.shape[1] * emb.element_size()
    cache_bytes = sum(t.numel() * t.element_size() for t in state.caches)
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    e, hd = cfg.moe.num_experts, cfg.resolved_head_dim
    proj = d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)

    def flops(t: int, pairs: int):
        """t tokens whose queries meet ``pairs`` keys a row and head."""
        experts = L * 6 * e * _capacity(cfg, t) * d * f
        rest = L * 2 * t * (d * e + proj) + 2 * b * d * cfg.vocab_size
        attn = L * 4 * b * cfg.num_heads * hd * pairs
        return experts, experts + rest + attn

    s_max = state.caches.k.shape[2]
    out = {}
    # a decode step's query meets every slot of the cache; the prefill's
    # causal pairs are half of plen²
    for name, t, pairs in (("decode", b, s_max),
                           ("prefill", b * plen, plen * plen // 2)):
        ex, total = flops(t, pairs)
        ms = {"bytes": (w_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3,
              "operations": total / BF16_FLOP_PER_S * 1e3}
        by = max(ms, key=ms.get)
        out[name] = {"bound_ms": ms[by], "bound_by": by, "bytes_ms":
                     ms["bytes"], "operations_ms": ms["operations"],
                     "flops": total, "expert_flops": ex,
                     "expert_ms": ex / BF16_FLOP_PER_S * 1e3,
                     "capacity": _capacity(cfg, t)}
    out["bytes"] = {"weights": w_bytes, "caches": cache_bytes}
    return out


def moe_split(cfg, params, b: int, plen: int):
    """Layer 0's ``moe_ffn`` on the card at a decode batch (b tokens) and
    a prefill (b × plen tokens) of bf16 normal inputs: the whole call and
    its parts (router: logits, softmax, top-k; dispatch: ranks and the
    capacity buffers; experts: the three batched products; combine: the
    gather and the slot-order sum), each the median of MOE_SPLIT_REPS
    synced calls (host time included: the parts are launch-bound at
    decode)."""
    import torch
    from repro_torch.models import moe

    p = {k: v[0] for k, v in params.layers["moe"].items()}
    m = cfg.moe
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(31)
    for name, t in (("decode", b), ("prefill", b * plen)):
        xt = torch.randn((t, cfg.d_model), generator=gen, device="cuda"
                         ).to(torch.bfloat16)
        cap = moe._capacity(cfg, t)

        def router():
            return moe.route(xt, p["router"], m.top_k)
        _, top_p, top_e = router()
        flat_e = top_e.reshape(-1)

        def dispatch():
            pos = moe.rank_within(flat_e, m.num_experts)
            keep = pos < cap
            pos = torch.where(keep, pos, 0)
            rows = xt[:, None].expand(t, m.top_k, -1).reshape(
                t * m.top_k, -1)
            return moe.dispatch(rows, (flat_e, pos), keep,
                                (m.num_experts, cap, cfg.d_model)), pos, keep
        disp, pos, keep = dispatch()

        def experts():
            return moe.swiglu_experts(disp, p["moe_gate"], p["moe_up"],
                                      p["moe_down"])
        y_e = experts()

        def combine():
            return moe.combine(y_e[flat_e, pos], top_p.reshape(-1), keep,
                               m.top_k)
        parts = {"router": router, "dispatch": dispatch,
                 "experts": experts, "combine": combine,
                 "moe_ffn": lambda: moe.moe_ffn(p, xt[None], cfg)}
        with torch.inference_mode():
            out[name] = {"tokens": t, "capacity": cap, "ms": {
                k: float(np.median([_synced_ms(fn)[1]
                                    for _ in range(MOE_SPLIT_REPS)]))
                for k, fn in parts.items()}}
    return out


def moe_replay(cfg, params, seed: int):
    """Phase 17 (c), the replay check: at capacity factor E/k (capacity =
    tokens, so nothing drops anywhere) and float32 compute (the bf16
    weights cast at use), ServeEngine's greedy tokens on MOE_PROMPTS
    prompts of MOE_REPLAY_LEN tokens, MOE_REPLAY_STEPS steps; the prefill
    and decode steps replayed on them pick the same tokens, and their
    logits equal the teacher-forced ``forward``'s over prompt + generated
    tokens (rtol = atol = 1e-4), whose argmax each token is wherever the
    top-2 margin exceeds twice the row's replay error.  Every routing of
    the replay (layer, row, position) is held to the forward's.  Where a
    row's top-k sets first differ (its first such position, lowest
    layer), the forward's gap between the k-th and (k+1)-th probability
    must be a rounding-level tie (< 1e-5); the row's logits from that
    position on are left out of the check, since the other route reaches
    later layers and, through attention, later positions."""
    import dataclasses
    import torch
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    m = cfg.moe
    c16 = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    model = build_model(c16)
    b, plen, steps = MOE_PROMPTS, MOE_REPLAY_LEN, MOE_REPLAY_STEPS
    s_max = plen + steps
    prompts = _stream_batch(c16, b, plen, seed + 37, 0, "cuda")["tokens"]
    gen, _ = ServeEngine(model, params, s_max=s_max).generate(prompts, steps)
    gen = gen.long()
    L = cfg.num_layers
    n = plen + steps - 1                     # positions the replay routes
    with torch.inference_mode():
        replay = []
        with routing_record(replay):
            logits, state = model.prefill(params, prompts, s_max)
            picked = [logits[:, 0].float()]
            for t in range(steps - 1):
                logits, state = model.decode_step(params, state,
                                                  gen[:, t:t + 1],
                                                  inplace=True)
                picked.append(logits[:, 0].float())
        picked = torch.stack(picked, dim=1)
        forward = []
        with routing_record(forward):
            seq = torch.cat([prompts, gen], 1)
            tf = model.forward(params, seq)[0][:, plen - 1:n].float()
    if not torch.equal(gen, picked.argmax(-1)):
        raise AssertionError("moe replay: the replayed steps pick other "
                             "tokens than generate")
    k = m.top_k
    diffs, gaps, kth = [], [], []
    for layer in range(L):
        r = [replay[layer][0].reshape(b, plen, k)]
        r += [replay[L * (1 + t) + layer][0].reshape(b, 1, k)
              for t in range(steps - 1)]
        f_e, f_gap, f_kth = forward[layer]
        diffs.append((torch.cat(r, 1) != f_e.reshape(b, n + 1, k)[:, :n]
                      ).any(-1))
        gaps.append(f_gap.reshape(b, n + 1)[:, :n])
        kth.append(f_kth.reshape(b, n + 1)[:, :n])
    diff, gap = torch.stack(diffs), torch.stack(gaps)          # (L, b, n)
    at = torch.arange(n, device="cuda")
    first_off = torch.where(diff.any(0), at, n).min(-1).values  # (b,)
    # a row's first flip (its first position, lowest layer) is the one
    # rounding may cause; the others follow from it
    roots = []
    for i in range(b):
        p0 = int(first_off[i])
        if p0 < n:
            l0 = int(diff[:, i, p0].nonzero()[0, 0])
            roots.append({"row": i, "position": p0, "layer": l0,
                          "gap": float(gap[l0, i, p0]),
                          "kth_prob": float(kth[l0][i, p0])})
    worst_gap = max((r["gap"] for r in roots), default=0.0)
    flips = int(diff.sum())
    if worst_gap >= 1e-5:
        raise AssertionError(f"moe replay: a token routed to other experts "
                             f"than in the forward at a gap of {worst_gap}: "
                             f"{roots}")
    rows = (torch.arange(steps, device="cuda")[None] + plen - 1
            < first_off[:, None])                              # (b, steps)
    if not bool(rows.any()):
        raise AssertionError("moe replay: every row routed otherwise than "
                             "the forward at its first position")
    err = (picked - tf).abs()
    bad = err > 1e-4 + 1e-4 * tf.abs()
    if bool((bad & rows[..., None]).any()):
        raise AssertionError(f"moe replay: decode logits "
                             f"{float(err[rows].max())} from the forward's")
    eps = err.amax(-1)
    top2 = torch.topk(tf, 2, dim=-1).values
    checked = (top2[..., 0] - top2[..., 1] > 2 * eps) & rows
    agree = gen == tf.argmax(-1)
    if not bool(agree[checked].all()):
        raise AssertionError(f"moe replay: {int((~agree & checked).sum())} "
                             f"greedy tokens differ from the teacher-forced "
                             f"argmax")
    out = {"prompts": b, "prompt_len": plen, "steps": steps,
           "capacity_factor": c16.moe.capacity_factor, "dtype": "float32",
           "max_abs_replay_teacher": float(err[rows].max()),
           "rows_checked": int(rows.sum()), "rows": rows.numel(),
           "routing_flips": flips, "first_flips": roots,
           "max_gap_at_first_flip": worst_gap,
           "min_routing_gap": min(float(g.min()) for _, g, _ in forward),
           "min_kth_prob": min(float(p.min()) for _, _, p in forward),
           "tokens_checked": int(checked.sum()),
           "tokens_equal_teacher_argmax": int(agree.sum()),
           "tolerance": {"logits": 1e-4, "flip_gap": 1e-5}}
    del state, tf, picked, model
    torch.cuda.empty_cache()
    return out


def moe_serve(cfg, seed: int):
    """Phase 17 (c): qwen3-moe-30b-a3b at full width and depth, bf16
    storage and compute, random weights from ``seed``: ServeEngine
    (:func:`engine_timings`) on MOE_PROMPTS prompts of MOE_PROMPT_LEN
    tokens, MOE_STEPS greedy steps, at the config's capacity factor (its
    launches of the six kernels counted: none); one profiled decode step
    and one profiled prefill; a decode step at this capacity factor equal
    bit for bit to one at E/k (a decode batch never drops); the steps'
    bounds (:func:`moe_bounds`), the split of one layer's ``moe_ffn``
    (:func:`moe_split`) and the replay check (:func:`moe_replay`).
    Returns (facts, launches)."""
    import dataclasses
    import torch
    from repro_torch.models import build_model

    full = dataclasses.replace(cfg, param_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(full)
    params, init_ms = _synced_ms(
        model.init, torch.Generator(device="cuda").manual_seed(seed))
    out = {"model": {
        "layers": full.num_layers, "d_model": full.d_model,
        "experts": full.moe.num_experts, "top_k": full.moe.top_k,
        "capacity_factor": full.moe.capacity_factor,
        "params": sum(p.numel() for p in params.parameters()),
        "param_count": full.param_count(),
        "active_param_count": full.active_param_count(),
        "param_bytes": sum(p.numel() * p.element_size()
                           for p in params.parameters()),
        "param_dtype": full.param_dtype, "dtype": full.dtype,
        "init_ms": init_ms, "peak_bytes": torch.cuda.max_memory_allocated()}}
    b, plen, steps = MOE_PROMPTS, MOE_PROMPT_LEN, MOE_STEPS
    prompts = _stream_batch(full, b, plen, seed + 7, 0, "cuda")["tokens"]
    (facts, gen, picked, state), launches = counted(
        engine_timings, model, params, prompts, steps)
    if not (bool(torch.isfinite(picked).all())
            and 0 <= int(gen.min()) and int(gen.max()) < full.vocab_size):
        raise AssertionError("moe ServeEngine: non-finite logits or tokens "
                             "out of the vocabulary")
    del picked
    facts.update(moe_bounds(full, params, b, plen, state))
    tok = torch.zeros((b, 1), dtype=torch.long, device="cuda")
    st = [state._replace(pos=state.pos - steps)]

    def decode():
        with torch.inference_mode():
            st[0] = model.decode_step(params, st[0], tok, inplace=True)[1]

    def prefill():
        with torch.inference_mode():
            model.prefill(params, prompts, plen + steps)
    facts["profile_decode_step"] = profile_call(decode, None)
    facts["profile_prefill"] = profile_call(prefill, None)
    m16 = build_model(dataclasses.replace(full, moe=dataclasses.replace(
        full.moe, capacity_factor=full.moe.num_experts / full.moe.top_k)))
    with torch.inference_mode():
        l_cf = model.decode_step(params, st[0], tok)[0]
        l_16 = m16.decode_step(params, st[0], tok)[0]
    if not torch.equal(l_cf, l_16):
        raise AssertionError("moe decode: capacity factor 1.25 and E/k "
                             "differ at a decode batch")
    facts["decode_equal_at_cf_e_over_k"] = True
    del st, state, l_cf, l_16
    facts["split"] = moe_split(full, params, b, plen)
    out["engine"] = facts
    out["replay"] = moe_replay(full, params, seed)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del model, params
    torch.cuda.empty_cache()
    return out, launches


def moe_phase(seed: int, smi):
    """Phase 17: the moe family on the card, qwen3-moe-30b-a3b.  Returns
    (the phase's line, its path launches)."""
    import torch
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config(MOE_ARCH)
    out = {"phase": "moe", "arch": cfg.name, "card": smi,
           "allocated_bytes_at_start": torch.cuda.memory_allocated(),
           "threads_at_start": sorted(t.name for t in threading.enumerate())}
    for name, fn in (("card_vs_cpu_2_layers", moe_card_vs_cpu),
                     ("lanes", moe_lanes)):
        t0 = time.perf_counter()
        out[name] = fn(cfg, seed)
        out[name]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["full"], launches = moe_serve(cfg, seed)
    out["full"]["seconds"] = time.perf_counter() - t0
    path_launches = {"moe/ref": launches}
    check_launches(path_launches)
    out["seconds"] = time.perf_counter() - t_phase
    return out, path_launches


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
    # cuBLAS may otherwise reduce bf16 products in bf16 (phase 15's model)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    cases3, wide = check_wide_kernels(args.seed)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "cases": cases + cases2 + cases3, "max_abs_err_f32": err,
          "d2048": {"cases": cases3, "shapes": len(KNNLM_SHAPES),
                    "plans": wide},
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
    served, serve_launches = serve_phase(index, qindex, queries, args.seed,
                                         smi)
    emit(served)
    for row in rows:
        # the serve phase's engine requests are a further main path
        n = sum(c[row["name"]] for c in serve_launches.values())
        if n:
            row["launches_serve"] = n
    del qindex
    torch.cuda.empty_cache()
    sharded, shard_launches = sharded_phase(index, facts["base"], queries,
                                            gt, smi)
    emit(sharded)
    for row in rows:
        # the sharded paths (walker and corpus, the corpus build included)
        n = sum(c[row["name"]] for c in shard_launches.values())
        if n:
            row["launches_sharded"] = n
    del index
    torch.cuda.empty_cache()

    built = construct(args.seed, facts["base"], facts["more"], queries,
                      recall, smi, N_BUILD)
    emit(built)
    for row in rows:
        if row["name"] == "l2dist_rowgather":
            # the construct phase's build is this kernel's second main path
            row["launches_construct"] = \
                built["build"]["launches"]["l2dist_rowgather"]
    knn, knn_launches = knnlm_phase(args.seed, smi)
    emit(knn)
    for row in rows:
        # the datastore build and the four backends' knnlm_logits calls
        n = sum(c[row["name"]] for c in knn_launches.values())
        if n:
            row["launches_knnlm"] = n
    trained, train_launches = train_phase(args.seed, smi)
    emit(trained)
    for row in rows:
        # the training path launches none of the six kernels
        row["launches_train"] = train_launches["train/ref"][row["name"]]
    moe, moe_launches = moe_phase(args.seed, smi)
    emit(moe)
    for row in rows:
        # the moe path launches none of the six kernels
        row["launches_moe"] = moe_launches["moe/ref"][row["name"]]
    emit({"phase": "done", "total_seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
