"""Dry run of the paper's own system at production scale (the port's
counterpart of ``repro.launch.dryrun_ann``): the Speed-ANN search service
on the reference's 16×16 and 2×16×16 meshes.

Two configurations, mirroring §5.5 (billion-scale practicality), with the
reference's constants and ``SearchParams``:

* corpus-sharded: a DEEP-like d = 96 corpus, 48M nodes × R = 24 a shard,
  one shard a ``model`` position (16 shards: 768M nodes); a card holds
  48M × (96 × 2 B + 24 × 4 B) = 13.824 GB of graph;
* walker-sharded (the paper's intra-query parallelism): a DEEP10M-scale
  graph replicated on every card, 16 walkers along ``model``, hash
  visited sets (memory independent of N), queries split over ``data``.

On the meta device (the default) each cell runs as rank 0 of a counting
group of 256 or 512 ranks (``ranks.init_counting_ranks``, in the dry
run's spawned worker, ``launch.dryrun.counting_worker``) on
``make_production_mesh(multi_pod, "meta", ranks=True)``: the walker cell
``walker_sharded_search`` over the replicated 10M graph with the whole
batch, the corpus cell ``corpus_sharded_search`` over this rank's block
of the 16 shards (``local_shards``; ``pod`` holds replicas), both under
``launch.op_profile.OpCounter``, where ``BACKEND``'s wrapper reports each
launch as on a card (its bytes and FLOPs) and computes nothing.  A loop
body counts once, as the reference reads it from the compiled module's
text: the host-tested loops run one trip on the meta device
(``core.bfis.loop_test``) and the search runs ``global_rounds=1``;
``loop_trips`` holds the caps the trace stands for.  Each cell records
the reference's keys (``hlo_flops`` by dtype, ``hlo_bytes`` and
``collectives``, one card's count times ``chips``; the roofline terms;
``compile_s``, the trace seconds), ``port_only_collectives`` (the port's
final gather of every rank's answer over ``data``, which the reference's
``out_specs`` leave split: also in ``collectives``) and ``memory``: the
bytes one card holds of its shard or graph, its queries (the reference's
1,024 over 16 ``data`` rows, and the whole batch the port passes every
rank) and its visited tables, the trace's live peak, and the fit.  With
``--run`` one card's share is run on the card:
the corpus cell's one 48M-row shard on a (1, 1) mesh taking one data
row's 64 queries, and the walker cell's 10M graph with 64 queries and
16 walkers as a (1, 16) mesh of lanes (the work of one data row's 16
cards).  Data comes from ``--seed``: bf16 vectors with integer
coordinates in [-8, 8] (every f32 distance sum is exact) and uniform
random out-edges.  The run records wall and busy time, launches, peak
memory, the op counter's bytes and FLOPs (``launch.op_profile``; the
distance kernels report their own) and the roofline terms against one
H100.  Results go to ``torch_ann_dryrun_results.json`` (or ``--out``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun_ann
    PYTHONPATH=src python -m repro_torch.launch.dryrun_ann --run   # a card
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import torch

from repro_torch.ann import SearchParams
from repro_torch.core import visited as vs
from repro_torch.core.distributed import (ShardedIndex,
                                          corpus_sharded_search,
                                          local_shards, make_search_mesh,
                                          walker_sharded_search)
from repro_torch.core.graph import PaddedCSR
from repro_torch.device import resolve_device
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun import tree_bytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_profile import OpCounter, tensor_bytes

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "../../../torch_ann_dryrun_results.json")

D = 96                  # DEEP dimensionality
R = 24                  # graph out-degree
N_SHARD = 48_000_000
N_WALKER_GRAPH = 10_000_000
QUERIES = 1024
SHARDS = 16             # the model axis: one shard a position
ROW_QUERIES = QUERIES // 16   # one data row's share
PARAMS = SearchParams(k=10, queue_len=128, m_max=16, num_walkers=16,
                      max_steps=64, local_steps=8, sync_ratio=0.8,
                      visited_mode="hash", hash_bits=16, global_rounds=12)
CFG = PARAMS.to_search_config("l2")
# the corpus path searches each shard with one walker
CORPUS_CFG = CFG.with_(m_max=1, num_walkers=1, staged=False)
BACKEND = "rowgather"   # the kernel a card's share runs through
# the caps a traced loop body stands for (the trace runs each once)
LOOP_TRIPS = {"global_rounds": CFG.global_rounds,
              "local_steps": CFG.local_steps, "max_steps": CFG.max_steps}
CHECK = 8               # queries held to the ref backend
FILL_ROWS = 1 << 22     # rows drawn at once

# name -> (kind, multi_pod)
CELLS = {
    "speedann-corpus-768M|serve|single": ("corpus", False),
    "speedann-corpus-1.5B|serve|multi": ("corpus", True),
    "speedann-walker-10M|serve|single": ("walker", False),
    "speedann-walker-10M|serve|multi": ("walker", True),
}


def row_bytes(d: int = D, r: int = R) -> int:
    """Bytes of one node: its bf16 vector and its int32 out-edges."""
    return d * 2 + r * 4


def corpus_bytes(n: int = N_SHARD, shards: int = 1, d: int = D,
                 r: int = R) -> int:
    """Analytic bytes of a :func:`make_corpus` index of ``shards`` shards
    of ``n`` nodes (vectors, out-edges, medoids and offsets)."""
    return shards * (n * row_bytes(d, r) + 4 + 4)


def graph_bytes(n: int = N_WALKER_GRAPH, d: int = D, r: int = R) -> int:
    """Analytic bytes of a :func:`make_graph` graph (vectors, out-edges,
    the medoid; no flattened top level)."""
    return n * row_bytes(d, r) + 4


def _fill(gen, shape, lo: int, hi: int, dtype, device):
    """A tensor of uniform integers in [lo, hi) drawn in chunks of
    FILL_ROWS rows (no int32 temporary of the whole: 4.6 GB for a shard's
    vectors); empty on the meta device."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    for s in range(0, shape[0], FILL_ROWS):
        part = out[s:s + FILL_ROWS]
        part.copy_(torch.randint(lo, hi, part.shape, generator=gen,
                                 device=device, dtype=torch.int32))
    return out


def _generator(seed: int, device):
    dev = torch.device(device)
    if dev.type == "meta":
        return None
    return torch.Generator(device=dev).manual_seed(seed)


def make_graph(n: int = N_WALKER_GRAPH, seed: int = 0, device=None,
               d: int = D, r: int = R) -> PaddedCSR:
    """A random graph of ``n`` nodes on ``device``: bf16 vectors with
    integer coordinates in [-8, 8], ``r`` uniform random out-edges a node
    (no padding), medoid 0."""
    gen = _generator(seed, device)
    vectors = _fill(gen, (n, d), -8, 9, torch.bfloat16, device)
    nbrs = _fill(gen, (n, r), 0, n, torch.int32, device)
    return PaddedCSR(nbrs=nbrs, vectors=vectors,
                     medoid=torch.zeros((), dtype=torch.int32,
                                        device=vectors.device),
                     n_top=0, flat=vectors.new_zeros((0, r, d)))


def make_corpus(n: int = N_SHARD, shards: int = 1, seed: int = 0,
                device=None, d: int = D, r: int = R) -> ShardedIndex:
    """``shards`` random shards of ``n`` nodes (:func:`make_graph`'s data,
    shard-local ids), stacked as a :class:`ShardedIndex`."""
    gen = _generator(seed, device)
    vectors = _fill(gen, (shards * n, d), -8, 9, torch.bfloat16,
                    device).view(shards, n, d)
    nbrs = _fill(gen, (shards * n, r), 0, n, torch.int32,
                 device).view(shards, n, r)
    dev = vectors.device
    return ShardedIndex(
        nbrs=nbrs, vectors=vectors,
        medoids=torch.zeros((shards,), dtype=torch.int32, device=dev),
        offsets=torch.arange(shards, dtype=torch.int32, device=dev) * n)


def make_queries(b: int, seed: int = 0, device=None,
                 d: int = D) -> torch.Tensor:
    """(b, d) f32 queries with integer coordinates in [-8, 8]."""
    gen = _generator(seed + 1, device)
    return _fill(gen, (b, d), -8, 9, torch.float32, device)


def visited_bytes(cfg, lanes) -> int:
    """Bytes of the visited tables the search makes for ``lanes`` (the
    leading axes of :func:`core.visited.make_visited_batch`)."""
    return tree_bytes(vs.make_visited_batch(cfg.visited_mode, 1, lanes,
                                            cfg.hash_bits,
                                            "meta").table)


def per_card(kind: str, multi_pod: bool) -> Dict:
    """Bytes one card of the production mesh holds in cell ``kind``: its
    share of the index (corpus: the shard axis over ``model``; walker:
    the whole graph, replicated), its queries (over ``data``) and its
    visited tables (a walker a card), built on the meta device."""
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta",
                                ranks=False)
    data, model = mesh.axis_size("data"), mesh.axis_size("model")
    q = make_queries(QUERIES, device="meta")
    rows = QUERIES // data
    if kind == "corpus":
        index = make_corpus(N_SHARD, SHARDS, device="meta")
        share = tree_bytes(index) // model
        vis = visited_bytes(CORPUS_CFG, (rows,))
    else:
        share = tree_bytes(make_graph(N_WALKER_GRAPH, device="meta"))
        vis = visited_bytes(CFG, (rows, 1))
    qbytes = tree_bytes(q) // data
    return {"mesh": "2x16x16" if multi_pod else "16x16",
            "chips": 512 if multi_pod else 256,
            "memory": {"index_bytes": share, "query_bytes": qbytes,
                       "visited_bytes": vis,
                       "argument_bytes": share + qbytes + vis},
            "queries_per_card": rows}


def card_share(kind: str, seed: int) -> Dict:
    """One card's share of cell ``kind`` on the card: its index (or
    graph), its 64 queries and the mesh of lanes that runs them."""
    device = resolve_device(None)
    if kind == "corpus":
        index = make_corpus(N_SHARD, 1, seed, device)
        mesh = make_search_mesh((1, 1), device=index.device)
        nbytes, want = tree_bytes(index), corpus_bytes(N_SHARD, 1)
        shard_bytes = tree_bytes((index.nbrs, index.vectors))
    else:
        index = make_graph(N_WALKER_GRAPH, seed, device)
        mesh = make_search_mesh((1, SHARDS), device=index.nbrs.device)
        nbytes, want = tree_bytes(index), graph_bytes(N_WALKER_GRAPH)
        shard_bytes = tree_bytes((index.nbrs, index.vectors))
    q = make_queries(ROW_QUERIES, seed, index.nbrs.device)
    return {"index": index, "queries": q, "mesh": mesh,
            "index_bytes": nbytes, "analytic_bytes": want,
            "shard_bytes": shard_bytes}


def search(kind: str, share: Dict, backend: str, queries=None):
    """The cell's search on ``share`` through ``backend``: the corpus
    shard's top-M engine (what ``corpus_sharded_search`` runs a shard)
    or the walker path.  Returns (ids, dists, stats)."""
    from repro_torch.core.bfis import search_topm_batch
    q = share["queries"] if queries is None else queries
    if kind == "corpus":
        cfg = CORPUS_CFG.with_(dist_backend=backend)
        return search_topm_batch(share["index"].shard(0), q, cfg)
    cfg = CFG.with_(dist_backend=backend)
    return walker_sharded_search(share["index"], q, cfg, share["mesh"])


def _same(a, b) -> bool:
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and all(torch.equal(x, y) for x, y in zip(a[2], b[2])))


def run_share(kind: str, seed: int, profile: bool = True) -> Dict:
    """Run one card's share of cell ``kind`` on the card (data from
    ``seed``): its bytes beside :func:`per_card`'s count on the meta
    device; the first CHECK queries through BACKEND and through ``ref``
    (``same_as_ref``: ids, dists and the 8 counters equal); one
    search of all 64 under the op counter (its launches, FLOPs and bytes,
    wall time), then with ``profile`` :func:`op_profile.device_profile`
    of it; the roofline terms."""
    from repro_torch.kernels import _cuda
    from repro_torch.launch.op_profile import OpCounter, device_profile

    def launches(fn, *a, **kw):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, dict(_cuda.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    share = card_share(kind, seed)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    meta = per_card(kind, False)["memory"]
    q = share["queries"]
    t1 = time.perf_counter()
    want, ref_launches = launches(search, kind, share, "ref", q[:CHECK])
    t2 = time.perf_counter()
    got, check_launches = launches(search, kind, share, BACKEND,
                                   q[:CHECK])
    t3 = time.perf_counter()
    with OpCounter() as counter:
        _, run_launches = launches(search, kind, share, BACKEND)
    t4 = time.perf_counter()
    prof = (device_profile(lambda: search(kind, share, BACKEND), reps=1)
            if profile else {})
    t5 = time.perf_counter()
    fby = counter.flops_by_dtype()
    nbytes = counter.bytes()
    out = {"kind": kind, "backend": BACKEND, "queries": q.shape[0],
           "walkers": SHARDS if kind == "walker" else 1,
           "index_bytes": share["index_bytes"],
           "analytic_bytes": share["analytic_bytes"],
           "meta_index_bytes": meta["index_bytes"],
           "shard_bytes": share["shard_bytes"],
           "query_bytes": tree_bytes(q),
           "meta_query_bytes": meta["query_bytes"], "make_s": make_s,
           "checked_queries": CHECK,
           "same_as_ref": _same(got, want),
           "launches": {"ref": ref_launches, "check": check_launches,
                        "run": run_launches},
           "counted_wall_ms": (t4 - t3) * 1e3,
           "split_s": {"ref": t2 - t1, "check": t3 - t2, "counted": t4 - t3,
                       "profiled": t5 - t4},
           "ops": len(counter.record), "flops_by_dtype": fby,
           "bytes": nbytes, "peak_bytes": torch.cuda.max_memory_allocated(),
           **prof, **rl.roofline_terms(fby, nbytes, None, 1)}
    del share, q
    torch.cuda.empty_cache()
    return out


def rank_search(kind: str, index, queries: torch.Tensor, mesh, cfg):
    """Cell ``kind``'s search as this rank of ``mesh`` (over ranks) runs
    it: the walker path over the replicated graph ``index``, or the corpus
    path over this rank's block of the shards of ``index``.  Every rank
    passes the whole batch."""
    if kind == "corpus":
        return corpus_sharded_search(local_shards(index, mesh), queries, cfg,
                                     mesh, data_axis="data",
                                     shard_axis="model")
    return walker_sharded_search(index, queries, cfg, mesh,
                                 data_axis="data", walker_axis="model")


def trace_search(kind: str, index, queries: torch.Tensor, mesh, cfg):
    """:func:`rank_search` under an :class:`OpCounter`: (counter, output,
    seconds).  On the meta device a boolean-mask index (the hash visited
    set's winning claims) takes every lane, the most it could write."""
    import torch.fx.experimental._config as fx_config
    t0 = time.perf_counter()
    with fx_config.patch(meta_nonzero_assume_all_nonzero=True), \
            OpCounter() as counter:
        out = rank_search(kind, index, queries, mesh, cfg)
    return counter, out, time.perf_counter() - t0


def collective_keys(record) -> list:
    """The collectives of an op record (``OpEntry.key``), in order."""
    return [e.key() for e in record if rl.collective_kind(e.name)]


def _port_only(record, out) -> Dict[str, int]:
    """Per-kind bytes of the port's final gather of the answer over
    ``data`` (``core.distributed._gather_rows``): the record's last
    collectives, one all-gather a returned tensor, whose results are
    those tensors."""
    flat = [t for t in out if isinstance(t, torch.Tensor)] + [
        t for part in out if not isinstance(part, torch.Tensor)
        for t in part]
    tail = [e for e in record if rl.collective_kind(e.name)][-len(flat):]
    got = [rl.collective_bytes([e])["all-gather"] for e in tail]
    want = [tensor_bytes(t) for t in flat]
    if got != want:
        raise AssertionError(f"the record's last collectives {got} are not "
                             f"the gather of the answer's rows {want}")
    return {"all-gather": sum(got)}


def record_task(mesh_shape, rank_shape, n: int, b: int, cfg) -> list:
    """The collectives (:func:`collective_keys`) of the walker search with
    ``cfg`` over a ("data", "model") mesh of ``mesh_shape`` laid over
    ``rank_shape`` ranks of the worker's counting group, on the meta
    device: a graph of ``n`` nodes and ``b`` queries of the cells'
    shapes."""
    mesh = make_search_mesh(mesh_shape, ("data", "model"), device="meta",
                            ranks=rank_shape)
    counter, _, _ = trace_search("walker", make_graph(n, device="meta"),
                                 make_queries(b, device="meta"), mesh, cfg)
    return collective_keys(counter.record)


def partition_cell(kind: str, multi_pod: bool) -> Dict:
    """Cell ``kind`` on the production mesh as rank 0 of the counting group
    (run in :func:`launch.dryrun.counting_worker`): the reference's keys,
    ``loop_trips``, ``port_only_collectives`` and ``memory`` (see the
    module's docstring)."""
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta",
                                ranks=True)
    base = per_card(kind, multi_pod)
    chips = base["chips"]
    q = make_queries(QUERIES, device="meta")
    if kind == "corpus":
        index = make_corpus(N_SHARD, SHARDS, device="meta")
        held = local_shards(index, mesh)
        cfg = CORPUS_CFG
    else:
        index = held = make_graph(N_WALKER_GRAPH, device="meta")
        cfg = CFG
    counter, out, seconds = trace_search(
        kind, index, q, mesh, cfg.with_(dist_backend=BACKEND,
                                        global_rounds=1))
    mem = base["memory"]
    index_bytes = sum(tensor_bytes(t) for t in held
                      if isinstance(t, torch.Tensor))
    if index_bytes != mem["index_bytes"]:
        raise AssertionError(f"{kind}: the rank holds {index_bytes} B of "
                             f"index, the count {mem['index_bytes']}")
    fby = {k: v * chips for k, v in counter.flops_by_dtype().items()}
    nbytes = float(counter.bytes()) * chips
    coll = {k: v * chips for k, v in
            rl.collective_bytes(counter.record).items()}
    port_only = {k: v * chips for k, v in _port_only(counter.record,
                                                      out).items()}
    args = index_bytes + tensor_bytes(q)
    peak = args + counter.peak_bytes
    return dict(
        base, status="ok", compile_s=seconds, ops=len(counter.record),
        hlo_flops=float(sum(fby.values())), flops_by_dtype=fby,
        hlo_bytes=nbytes, collectives=coll, port_only_collectives=port_only,
        loop_trips=dict(LOOP_TRIPS), backend=BACKEND,
        memory=dict(mem, query_bytes_passed=tensor_bytes(q),
                    argument_bytes=args,
                    trace_peak_bytes=counter.peak_bytes, peak_bytes=peak),
        fits=peak <= rl.HBM_BYTES,
        **rl.roofline_terms(fby, nbytes, coll, chips))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run", action="store_true",
                    help="also run one card's share of each cell on the "
                         "card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args(argv)
    res = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            res = json.load(f)
    futures = {name: dryrun.partition_worker(
        "2x16x16" if multi else "16x16").submit(partition_cell, kind, multi)
        for name, (kind, multi) in CELLS.items()}
    for name, fut in futures.items():
        out = res[name] = fut.result()
        m, chips = out["memory"], out["chips"]
        port = out["port_only_collectives"]["all-gather"] // chips
        print(f"[ok] {name}  trace={out['compile_s']:.1f}s "
              f"index/card={m['index_bytes'] / 1e9:.3f} GB peak/card="
              f"{m['peak_bytes'] / 1e9:.3f} GB coll/card="
              + json.dumps({k: v // chips for k, v in
                            out["collectives"].items() if v})
              + f" port-only={port} t_coll="
              f"{out['t_collective_s'] * 1e3:.3f} ms "
              f"dominant={out['dominant']}")
    dryrun.close_workers()
    if args.run:
        for kind in ("corpus", "walker"):
            out = run_share(kind, args.seed)
            res[f"speedann-{kind}|card-share|1xh100"] = out
            print(f"[run] {kind}: wall {out['wall_ms']:.1f} ms, busy "
                  f"{out['device_busy_ms']}, peak "
                  f"{out['peak_bytes'] / 1e9:.2f} GB")
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1, sort_keys=True, default=str)
    print("ann dry-run complete ->", os.path.abspath(args.out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
