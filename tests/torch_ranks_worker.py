"""Rank bodies for ``tests/test_torch_ranks.py``: the port's mesh over the
ranks of a gloo process group on the CPU.

:func:`spawn` starts 4 processes once; each runs :func:`rank_main`:

* part A, 4 ranks: ``RankAxis.all_to_all`` and ``ranks.broadcast``; the
  walker-sharded search on (1, 4) over ranks (1, 4) in the bitmap, hash
  and loose modes, on (2, 4) over ranks (2, 2) in the three modes, on
  (2, 2, 2) over ranks (2, 1, 2); ``index.search`` with no mesh (the
  default (1, world) mesh over the ranks) and the engine on that mesh;
  the partitioned build and the corpus search on (1, 4) over ranks (1, 4)
  and (2, 4) over (2, 2); serving over the ranks (SERVE_RANKS: rank 0
  serves requests, a coalescer's queries, two threads' requests and two
  bad requests, the others run the worker loop until rank 0 closes);
  ``moe_ffn_sharded`` on ``tests/torch_moe_ref.py``'s (2, 4) cases over
  ranks (2, 2), whole and DTensor weights, beside the lanes, and the moe
  ``CausalLM`` under ``set_moe_impl("a2a")``; the compressed DP step on a
  4-position ``data`` axis over 4 ranks beside the same step as 4 lanes,
  and the moe ``CausalLM``'s compressed step under ``set_moe_impl("a2a")``
  on (2, 2) over ranks (2, 2) beside its lanes run; ``reshard_state``
  (2, 2) -> (4, 1) -> (1, 4) -> one device with the specs of every mesh;
  a checkpoint saved over the ranks and restored against
  ``param_shardings``;
* part B, ranks 0 and 1 in a new 2-rank group: (1, 4) bitmap over ranks
  (1, 2) (two walker lanes a rank), the corpus path on (1, 4) over ranks
  (1, 2), the compressed step as 2 ranks × 2 lanes, the ``Trainer``
  resumed over those ranks from a checkpoint they wrote beside the
  unbroken 4-lane run, and ``launch.train --compress --data 2`` over the
  2 ranks beside rank 0's 2-lane run before the group is up;
* part C, ranks 0 and 1 in a group with a 10 s timeout: rank 0 idles 13 s
  with an engine over the two ranks open, then serves.

Each rank saves what it returned (numpy) to ``<out>/rank<r>.pt``; the
test holds it to ``tests/torch_distributed_ref.py``'s and
``tests/torch_moe_ref.py``'s npz and to the lanes runs.  Rendezvous is a file under the test's tmp dir (no TCP port),
every group has a timeout, and each rank runs one thread.
"""
import datetime
import multiprocessing
import os
import threading
import time

import numpy as np
import torch

import torch_distributed_cases as cases
import torch_moe_cases as moe_cases

TIMEOUT = datetime.timedelta(seconds=120)
JOIN_S = 170          # each join's limit
WORLD = 4
# (case, mesh shape, axis names, visited mode, ranks): part A's walker cases
WALKER_RANKS = ([(f"walker_1x4_{m}", (1, 4), ("data", "model"), m, (1, 4))
                 for m in ("bitmap", "hash", "loose")]
                + [(f"walker_2x4_{m}", (2, 4), ("data", "model"), m, (2, 2))
                   for m in ("bitmap", "hash", "loose")]
                + [("walker_2x2x2_bitmap", (2, 2, 2),
                    ("pod", "data", "model"), "bitmap", (2, 1, 2))])
# (ref case, mesh, ranks) of the corpus path; part A's, then part B's
CORPUS_RANKS = [("corpus_1x4", (1, 4), (1, 4)), ("corpus_2x4", (2, 4), (2, 2))]
CORPUS_RANKS_B = [("corpus_1x4", (1, 4), (1, 2))]
RESHARD_MESHES = ((2, 2), (4, 1), (1, 4))
# (ref case, mesh, ranks) served by an engine over the ranks
SERVE_RANKS = [("walker_1x4_bitmap", (1, 4), (1, 4)),
               ("walker_2x4_bitmap", (2, 4), (2, 2)),
               ("corpus_1x4", (1, 4), (1, 4))]
# rank 0's engine requests: (first query, size); 3 pads to bucket 4
SERVE_REQUESTS = ((0, 8), (0, 1), (5, 3), (2, 2))
MOE_RANKS = (2, 2)               # the (2, 4) mesh's ranks
# part C: a group timeout an idle controller outlives
KEEPALIVE_TIMEOUT = datetime.timedelta(seconds=10)
KEEPALIVE_IDLE_S = 13


def _np(tree):
    """A tree of tensors (DTensors gathered) as numpy."""
    from repro_torch.sharding import whole
    from repro_torch.treepath import tree_map
    return tree_map(lambda t: whole(t).detach().cpu().numpy(), tree)


def _flat(tree):
    from repro_torch.treepath import flatten_with_path, keystr_simple
    return {keystr_simple(p): v for p, v in flatten_with_path(tree)}


def _search_out(ids, dists, stats=None):
    out = {"ids": ids.numpy(), "dists": dists.numpy()}
    if stats is not None:
        out.update({f: v.numpy() for f, v in stats._asdict().items()})
    return out


def _walker(ref, name, shape, names, mode, ranks):
    from repro_torch.core.config import SearchConfig
    from repro_torch.core.distributed import (make_search_mesh,
                                              walker_sharded_search)
    from repro_torch.core.graph import make_padded_csr
    graph = make_padded_csr(ref["nbrs"], ref["x"], device="cpu")
    cfg = SearchConfig(visited_mode=mode, **cases.WALKER_CFG)
    mesh = make_search_mesh(shape, names, device="cpu", ranks=ranks)
    return _search_out(*walker_sharded_search(
        graph, torch.from_numpy(ref["q"]), cfg, mesh))


def _default_mesh(ref):
    """``index.search`` with no mesh (the default (1, world) mesh over the
    ranks) and with the explicit (1, 4) mesh over ranks (1, 4); then the
    engine with no mesh, which serves on the default mesh: rank 0's answer
    to the 8 queries (the others run the worker loop)."""
    from repro_torch import ranks
    from repro_torch.ann import SearchParams
    from repro_torch.core.distributed import make_search_mesh
    index = _index(ref)
    params = SearchParams(k=10, queue_len=24, m_max=4, algorithm="sharded")
    q = torch.from_numpy(ref["q"])
    a = index.search(q, params)
    mesh = make_search_mesh((1, 4), device="cpu", ranks=(1, 4))
    b = index.search(q, params, mesh=mesh)
    out = {"default": _search_out(a.ids, a.dists, a.stats),
           "explicit": _search_out(b.ids, b.dists, b.stats)}
    engine = index.serve(params)
    out["engine_mesh"] = (engine.mesh.shape, engine.mesh.ranks)
    if ranks.rank() == 0:
        r = engine.search(ref["q"])
        engine.close()
        out["served"] = {"ids": r.ids, "dists": r.dists,
                         **{f: v for f, v in r.stats._asdict().items()}}
    else:
        out["worker_served"] = engine.run_worker()
    return out


def _corpus(ref, shape, ranks):
    """The partitioned build over the mesh's ranks (this rank's block) and
    the corpus search over it."""
    from repro_torch.core.config import SearchConfig
    from repro_torch.core.distributed import (build_partitioned,
                                              corpus_sharded_search,
                                              make_search_mesh)
    mesh = make_search_mesh(shape, device="cpu", ranks=ranks)
    block = build_partitioned(ref["x"], mesh=mesh, **cases.PARTITION)
    ids, dists = corpus_sharded_search(
        block, torch.from_numpy(ref["q"]),
        SearchConfig(**cases.CORPUS_CFG), mesh)
    return {"block": {f: getattr(block, f).numpy() for f in block._fields},
            "first_shard": mesh.coord("model") * mesh.lanes("model"),
            **_search_out(ids, dists)}


def _collectives():
    """``RankAxis.all_to_all`` over the ``model`` ranks of (2, 2);
    ``ranks.broadcast`` from rank 1 (f32) and from rank 3 (int64 over
    gloo)."""
    from repro_torch import ranks
    from repro_torch.core.distributed import make_search_mesh
    mesh = make_search_mesh((2, 2), device="cpu", ranks=(2, 2))
    r = ranks.rank()
    blocks = torch.arange(4, dtype=torch.int32).reshape(2, 2) + 10 * r
    got = mesh.axis("model").all_to_all(blocks)
    sent = torch.full((3,), float(r))
    return {"all_to_all": got.numpy(),
            "broadcast": ranks.broadcast(sent, 1).numpy(),
            "world_broadcast": ranks.broadcast(
                torch.tensor([r, 7 * r], dtype=torch.int64), 3).numpy()}


def _serve_queries(engine, q, out):
    """Rank 0: SERVE_REQUESTS, the queries one by one through a coalescer
    (closed at the end, which closes the engine), two threads' requests
    and two bad requests, then the engine's buckets dispatched."""
    from repro_torch.serve import AsyncAnnEngine, CoalescePolicy
    qn = q.numpy()
    out["requests"] = []
    for lo, n in SERVE_REQUESTS:
        r = engine.search(qn[lo:lo + n])
        out["requests"].append({"lo": lo, "buckets": r.buckets,
                                "ids": r.ids, "dists": r.dists,
                                **r.stats._asdict()})
    out["bad"] = []
    for bad in (np.zeros((2, qn.shape[1] + 1), np.float32),
                np.zeros((0, qn.shape[1]), np.float32)):
        try:
            engine.search(bad)
        except ValueError as e:
            out["bad"].append(str(e))
    srv = AsyncAnnEngine(engine, CoalescePolicy(max_batch=8,
                                                max_wait_ms=20.0))
    futs = [srv.submit(x) for x in qn]
    got = [f.result(timeout=60) for f in futs]
    out["coalesced"] = {"ids": np.stack([g.ids for g in got]),
                        "dists": np.stack([g.dists for g in got])}
    threads = {}

    def serve(name, rows):
        threads[name] = [engine.search(qn[rows]).ids for _ in range(3)]
    ts = [threading.Thread(target=serve, args=(i, sl)) for i, sl in
          enumerate((slice(0, 4), slice(4, 8)))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    out["threads_alive"] = [t.is_alive() for t in ts]
    out["threads"] = [np.concatenate([threads[0][i], threads[1][i]])
                      for i in range(3)]
    out["dispatched"] = engine.cache_hits + engine.cache_misses
    srv.close()
    try:
        engine.search(qn[:1])
    except RuntimeError as e:
        out["after_close"] = str(e)


def _serve(ref, name, shape, grid, corpus):
    """``index.search`` (or the corpus search) on ``shape`` over ranks
    ``grid`` on every rank, then an engine over the same mesh: rank 0
    serves (:func:`_serve_queries`), the others run the worker loop."""
    from repro_torch.ann import SearchParams
    from repro_torch.core.config import SearchConfig
    from repro_torch.core.distributed import (build_partitioned,
                                              corpus_sharded_search,
                                              make_search_mesh)
    from repro_torch.serve import AnnEngine
    from repro_torch import ranks
    mesh = make_search_mesh(shape, device="cpu", ranks=grid)
    q = torch.from_numpy(ref["q"])
    buckets = tuple(b for b in (1, 2, 4, 8) if b % shape[0] == 0)
    if corpus:
        cfg = SearchConfig(**cases.CORPUS_CFG)
        block = build_partitioned(ref["x"], mesh=mesh, **cases.PARTITION)
        out = {"direct": _search_out(*corpus_sharded_search(block, q, cfg,
                                                            mesh))}
        engine = AnnEngine(block, SearchParams.from_search_config(cfg),
                           mesh=mesh, bucket_sizes=buckets)
    else:
        params = SearchParams.from_search_config(
            SearchConfig(visited_mode=name.split("_")[-1],
                         **cases.WALKER_CFG), algorithm="sharded")
        index = _index(ref)
        a = index.search(q, params, mesh=mesh)
        out = {"direct": _search_out(a.ids, a.dists, a.stats)}
        engine = index.serve(params, mesh=mesh, bucket_sizes=buckets)
    out["over_ranks"] = engine.over_ranks
    t0 = time.perf_counter()
    if ranks.rank() == 0:
        _serve_queries(engine, q, out)
    else:
        out["worker_served"] = engine.run_worker()
    out["serve_seconds"] = time.perf_counter() - t0
    return out


def _keepalive(ref, tmp, rank):
    """Part C, ranks 0 and 1 in a group whose collectives wait at most
    KEEPALIVE_TIMEOUT: an engine on (1, 2) over the two ranks; rank 0
    idles KEEPALIVE_IDLE_S, longer than that, then serves the first two
    queries and closes, while rank 1 waits in the worker loop."""
    from repro_torch import ranks
    from repro_torch.ann import SearchParams
    from repro_torch.core.distributed import make_search_mesh
    ranks.init_ranks(device="cpu", init_method=f"file://{tmp}/rdv_keep",
                     rank=rank, world=2, timeout=KEEPALIVE_TIMEOUT)
    try:
        params = SearchParams(k=10, queue_len=24, m_max=4,
                              algorithm="sharded")
        index = _index(ref)
        mesh = make_search_mesh((1, 2), device="cpu", ranks=(1, 2))
        a = index.search(torch.from_numpy(ref["q"][:2]), params, mesh=mesh)
        out = {"direct": _search_out(a.ids, a.dists)}
        engine = index.serve(params, mesh=mesh, bucket_sizes=(1, 2))
        if rank == 0:
            time.sleep(KEEPALIVE_IDLE_S)
            r = engine.search(ref["q"][:2])
            engine.close()
            return dict(out, ids=r.ids, dists=r.dists)
        return dict(out, worker_served=engine.run_worker())
    finally:
        ranks.shutdown()


def _index(ref):
    from repro_torch.ann import AnnIndex, IndexSpec
    from repro_torch.core.graph import make_padded_csr
    return AnnIndex(IndexSpec(metric="l2", degree=12),
                    make_padded_csr(ref["nbrs"], ref["x"], device="cpu"))


def _moe_config(e, cf):
    from repro_torch.config import FAMILY_MOE, ModelConfig, MoEConfig
    return ModelConfig(family=FAMILY_MOE, **moe_cases.FFN_FIELDS,
                       moe=MoEConfig(num_experts=e, top_k=moe_cases.TOP_K,
                                     capacity_factor=cf))


def _moe_step(p, x, cfg, mesh, gy, block):
    """``moe_ffn_sharded`` on ``mesh`` and the backward of sum(y · gy) +
    3 aux; with ``block`` x and gy are this rank's block (their whole
    otherwise).  Returns y, aux and the gradients of x and of each leaf
    of p (a DTensor's as its local part)."""
    from repro_torch.models import moe_a2a
    from repro_torch.sharding import DEFAULT_RULES, use_rules
    x = x.detach().clone().requires_grad_(True)
    with use_rules(DEFAULT_RULES, mesh):
        if block:
            y, aux = moe_a2a.moe_ffn_sharded(p, x, cfg)
        else:
            y, aux = moe_a2a.moe_ffn_whole(p, x, cfg)
    ((y * gy).sum() + 3.0 * aux).backward()
    grads = {k: _local(v.grad).numpy() for k, v in p.items()}
    return {"y": y.detach().numpy(), "aux": float(aux),
            "x_grad": x.grad.numpy(), "grads": grads}


def _moe(moe_ref):
    """Each FFN case of ``tests/torch_moe_ref.py`` on its (2, 4) mesh over
    ranks MOE_RANKS (this rank's token block; whole weights, and the
    weights as DTensors placed by ``param_shardings``) and as lanes, the
    same loss's gradients; the moe ``CausalLM``'s forward, loss and
    gradients under ``set_moe_impl("a2a")`` over the ranks and as
    lanes."""
    from repro_torch.core.distributed import make_search_mesh
    from repro_torch.models import moe_a2a
    from repro_torch.sharding import param_shardings, place
    shape, names = moe_cases.MESH
    ranked = make_search_mesh(shape, names, device="cpu", ranks=MOE_RANKS)
    lanes = make_search_mesh(shape, names, device="cpu")
    out = {}
    for name, e, cf in moe_cases.FFN_CASES:
        cfg = _moe_config(e, cf)
        x = torch.from_numpy(moe_ref[f"{name}/x"])
        gy = torch.randn(x.shape, generator=torch.Generator().manual_seed(e))
        whole = {k: torch.from_numpy(moe_ref[f"{name}/p/{k}"])
                 for k in ("router", "moe_gate", "moe_up", "moe_down")}

        def leaves(placed):
            if not placed:
                return {k: v.clone().requires_grad_(True)
                        for k, v in whole.items()}
            sh = param_shardings(whole, ranked)
            return {k: place(v, sh[k]).requires_grad_(True)
                    for k, v in whole.items()}
        xb = moe_a2a.token_block(x, cfg, ranked)
        gb = moe_a2a.token_block(gy, cfg, ranked)
        out[name] = {
            "block": {"x": xb.numpy()},
            "ranks": _moe_step(leaves(False), xb, cfg, ranked, gb, True),
            "dtensor": _moe_step(leaves(True), xb, cfg, ranked, gb, True),
            "whole": _moe_step(leaves(False), x, cfg, ranked, gy, False),
            "lanes": _moe_step(leaves(False), x, cfg, lanes, gy, False),
            "specs": {k: list(v.spec) for k, v in param_shardings(
                whole, ranked).items()}}
    out["lm"] = _moe_lm(moe_ref, ranked, lanes)
    return out


def _moe_lm(moe_ref, ranked, lanes):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe_a2a
    from repro_torch.models.convert import params_from_jax
    from repro_torch.sharding import DEFAULT_RULES, use_rules
    cfg = dataclasses.replace(get_smoke_config(moe_cases.LM_ARCH),
                              dtype="float32")
    tree = {}
    for k, v in moe_ref.items():
        if k.startswith("lm/p/"):
            node = tree
            *parents, leaf = k[len("lm/p/"):].split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = v
    toks = torch.from_numpy(moe_ref["lm/tokens"])
    out = {}
    moe_a2a.set_moe_impl("a2a")
    try:
        for name, mesh in (("ranks", ranked), ("lanes", lanes)):
            model = params_from_jax(tree, cfg, device="cpu")
            for v in model.parameters():
                v.requires_grad_(True)
            with use_rules(DEFAULT_RULES, mesh):
                logits, aux = model.forward(model, toks, remat=False)
                g = torch.randn(logits.shape,
                                generator=torch.Generator().manual_seed(4))
                ((logits * g).sum() + aux).backward()
            out[name] = {"logits": logits.detach().numpy(),
                         "aux": float(aux),
                         "grads": {k: v.grad.numpy() for k, v in
                                   model.named_parameters()}}
    finally:
        moe_a2a.set_moe_impl("gspmd")
    return out


def _train_setup(device="cpu", arch=cases.SPEC_ARCH):
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import TokenStream, _batch_at
    from repro_torch.models import build_model
    from repro_torch.train.train_step import init_train_state
    model = build_model(get_smoke_config(arch), device=device)
    tcfg = TrainConfig(grad_compression="int8", learning_rate=1e-3,
                       warmup_steps=1, total_steps=10)
    stream = TokenStream(model.cfg.vocab_size, 16, 16, 0, 0, 1)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in _batch_at(stream, 0).items()}
    state = init_train_state(model, torch.Generator(
        device=device).manual_seed(0), tcfg)
    return model, tcfg, batch, state


def _compressed(grid, shape=(4, 1), arch=cases.SPEC_ARCH, a2a=False):
    """Two steps of the compressed DP step on ``shape`` (its ``data`` axis
    the DP axis) over ranks ``grid``, and the same two steps as lanes.
    With ``a2a`` the steps run inside ``use_rules(DEFAULT_RULES, mesh)``
    under ``set_moe_impl("a2a")``, so a moe model's layers split over the
    mesh."""
    from repro_torch.core.distributed import make_search_mesh
    from repro_torch.models import moe_a2a
    from repro_torch.sharding import DEFAULT_RULES, use_rules
    from repro_torch.train.train_step import make_compressed_dp_train_step
    from repro_torch.treepath import tree_map
    model, tcfg, batch, state = _train_setup(arch=arch)
    out = {}
    for name, mesh in (("lanes", make_search_mesh(shape, device="cpu")),
                       ("ranks", make_search_mesh(shape, device="cpu",
                                                  ranks=grid))):
        s = tree_map(torch.clone, state)
        step = make_compressed_dp_train_step(model, tcfg, mesh)
        metrics = []
        moe_a2a.set_moe_impl("a2a" if a2a else "gspmd")
        try:
            with use_rules(DEFAULT_RULES, mesh if a2a else None):
                for _ in range(2):
                    s, m = step(s, batch)
                    metrics.append({k: float(v) for k, v in m.items()})
        finally:
            moe_a2a.set_moe_impl("gspmd")
        out[name] = {"params": _flat(_np(s.params)),
                     "opt": _flat(_np(s.opt)), "err": _flat(_np(s.err)),
                     "err_here": {k: _local(v).numpy()
                                  for k, v in _flat(s.err).items()},
                     "metrics": metrics}
    return out


def _local(t):
    """This rank's part of a DTensor (a plain tensor as it is)."""
    return t.to_local() if hasattr(t, "to_local") else t


def _resume(tmp, ranks, device="cpu"):
    """The ``Trainer`` with the compressed step on a 4-position ``data``
    axis over ``ranks`` (ranks, 1): two steps and a checkpoint, then a new
    ``Trainer`` resumes from it for two more; beside it the same four
    steps as 4 lanes of ``device`` without a break."""
    import dataclasses
    from repro_torch.core.distributed import make_search_mesh
    from repro_torch.data.tokens import TokenStream
    from repro_torch.train import Trainer
    from repro_torch.train.train_step import make_compressed_dp_train_step
    model, tcfg, _, _ = _train_setup(device)
    stream = TokenStream(model.cfg.vocab_size, 16, 16, 0, 0, 1)
    out = {}
    for name, mesh, stops in (
            ("lanes", make_search_mesh((4, 1), device=device), (4,)),
            ("ranks", make_search_mesh((4, 1), ranks=(ranks, 1)), (2, 4))):
        cfg = dataclasses.replace(
            tcfg, checkpoint_every=2,
            checkpoint_dir=os.path.join(tmp, f"resume_{ranks}_{name}"))
        step = make_compressed_dp_train_step(model, cfg, mesh)
        metrics = []
        for stop in stops:
            trainer = Trainer(model, cfg, stream, train_step=step)
            s = trainer.run(steps=stop)
            metrics += trainer.metrics_log
        out[name] = {"params": _flat(_np(s.params)),
                     "opt": _flat(_np(s.opt)), "err": _flat(_np(s.err)),
                     "metrics": metrics}
    return out


def _reshard(tmp):
    """``reshard_state`` through RESHARD_MESHES and back to one device;
    each mesh's specs and local parts; a checkpoint saved over the ranks
    and restored against ``param_shardings`` on (2, 2)."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core.distributed import make_search_mesh
    from repro_torch.runtime import reshard_state
    from repro_torch.sharding import param_shardings
    _, _, _, state = _train_setup()
    host = _flat(_np(state))
    out = {"host": host, "meshes": {}}
    cur = state
    for shape in RESHARD_MESHES:
        mesh = make_search_mesh(shape, device="cpu", ranks=shape)
        cur = reshard_state(cur, mesh)
        sh = _flat(param_shardings(cur, mesh))
        out["meshes"]["x".join(map(str, shape))] = {
            "whole": _flat(_np(cur)),
            "specs": {k: list(v.spec) for k, v in sh.items()},
            "placements": {k: repr(v.placements) for k, v in sh.items()},
            "local": {k: v.to_local().numpy() for k, v in _flat(cur).items()},
        }
    single = reshard_state(cur, make_search_mesh((1, 1), device="cpu"))
    out["single"] = {k: (type(v).__name__, v.numpy())
                     for k, v in _flat(single).items()}
    mesh = make_search_mesh((2, 2), device="cpu", ranks=(2, 2))
    save_checkpoint(os.path.join(tmp, "ckpt"), 3, state)
    restored = load_checkpoint(os.path.join(tmp, "ckpt"), 3, state,
                               shardings=param_shardings(state, mesh))
    out["restored"] = {"whole": _flat(_np(restored)),
                       "local": {k: v.to_local().numpy()
                                 for k, v in _flat(restored).items()}}
    return out


def _launch_train(tmp, name):
    from repro_torch.launch import train as t_launch
    return t_launch.main(["--arch", cases.SPEC_ARCH, "--smoke", "--steps",
                          "4", "--seq", "17", "--batch", "4", "--data", "2",
                          "--compress", "--device", "cpu",
                          "--ckpt-dir", os.path.join(tmp, name)])


def rank_main(rank: int, tmp: str, ref_path: str, moe_path: str) -> None:
    torch.set_num_threads(1)
    from repro_torch import ranks
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files if not k.startswith("specs/")}
    with np.load(moe_path) as z:
        moe_ref = {k: z[k] for k in z.files}
    res = {"rank": rank, "seconds": {}}
    t0 = time.perf_counter()
    ranks.init_ranks(device="cpu", init_method=f"file://{tmp}/rdv4",
                     rank=rank, world=WORLD, timeout=TIMEOUT)
    res["transport"] = ranks.transport()
    res["collectives"] = _collectives()
    res["walker"] = {c[0]: _walker(ref, *c) for c in WALKER_RANKS}
    res["default_mesh"] = _default_mesh(ref)
    res["corpus"] = {f"{c[0]}@{c[2]}": _corpus(ref, c[1], c[2])
                     for c in CORPUS_RANKS}
    res["seconds"]["search"] = time.perf_counter() - t0
    res["served"] = {f"{c[0]}@{c[2]}": _serve(ref, *c,
                                              corpus=c[0].startswith("corpus"))
                     for c in SERVE_RANKS}
    res["seconds"]["serve"] = time.perf_counter() - t0
    res["moe"] = _moe(moe_ref)
    res["seconds"]["moe"] = time.perf_counter() - t0
    res["compressed_4"] = _compressed((4, 1))
    res["compressed_moe"] = _compressed((2, 2), (2, 2), moe_cases.LM_ARCH,
                                        a2a=True)
    res["reshard"] = _reshard(tmp)
    ranks.shutdown()
    res["seconds"]["part_a"] = time.perf_counter() - t0
    if rank < 2:
        if rank == 0:       # the 2-lane run, before the 2-rank group
            res["train_lanes"] = _launch_train(tmp, "lanes")
        ranks.init_ranks(device="cpu", init_method=f"file://{tmp}/rdv2",
                         rank=rank, world=2, timeout=TIMEOUT)
        res["walker_b"] = _walker(ref, "walker_1x4_bitmap", (1, 4),
                                  ("data", "model"), "bitmap", (1, 2))
        res["corpus"].update({f"{c[0]}@{c[2]}": _corpus(ref, c[1], c[2])
                              for c in CORPUS_RANKS_B})
        res["compressed_2x2"] = _compressed((2, 1))
        res["resume_2x2"] = _resume(tmp, 2)
        res["train_ranks"] = _launch_train(tmp, "ranks")
        ranks.shutdown()
        res["keepalive"] = _keepalive(ref, tmp, rank)
    res["seconds"]["total"] = time.perf_counter() - t0
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))


def spawn(tmp: str, ref_path: str, moe_path: str) -> list:
    """Run :func:`rank_main` on WORLD spawned ranks; returns each rank's
    results.  A rank that fails, or outlives its join limit, fails the
    call (the others are killed)."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, tmp, ref_path,
                                                 moe_path))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
            if p.is_alive():
                raise TimeoutError(f"rank {procs.index(p)} still runs after "
                                   f"{JOIN_S} s")
            if p.exitcode != 0:
                raise RuntimeError(f"rank {procs.index(p)} exited with "
                                   f"{p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


# ---------------------------------------------------------------------------
# The NCCL path on the card (tests/test_torch_cuda.py): one rank a card
# ---------------------------------------------------------------------------

def card_rank_main(rank: int, world: int, tmp: str) -> None:
    """NCCL over ``world`` cards: the walker path ((1, 4) bitmap and hash,
    (2, 4) bitmap), the partitioned build and the corpus search on
    (1, 4), and two compressed steps on a 4-position ``data`` axis, each
    over the ranks and as lanes of this rank's card, on integer data; the
    ``Trainer`` resumed over the ranks from their checkpoint beside the
    unbroken 4-lane run; ``reshard_state`` of the parameters over
    (world, 1), (1, world) and back onto the card.  Saves what differs (empty: nothing) and what ran
    to ``<tmp>/card<rank>.pt``."""
    from repro_torch import ranks
    from repro_torch.core.config import SearchConfig
    from repro_torch.core.distributed import (build_partitioned,
                                              corpus_sharded_search,
                                              make_search_mesh,
                                              walker_sharded_search)
    from repro_torch.core.graph import make_padded_csr
    from repro_torch.launch.mesh import rank_grid
    from repro_torch.runtime import reshard_state
    from repro_torch.sharding import whole
    from repro_torch.train.train_step import make_compressed_dp_train_step
    from repro_torch.treepath import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = ranks.init_ranks(init_method=f"file://{tmp}/rdv", rank=rank,
                           world=world, timeout=TIMEOUT)
    rng = np.random.RandomState(5)
    x = rng.randint(-8, 9, size=(600, 16)).astype(np.float32)
    q = torch.from_numpy(x[rng.randint(0, 600, 8)] + rng.randint(
        -1, 2, size=(8, 16)).astype(np.float32)).to(dev)
    graph = make_padded_csr(rng.randint(0, 600, size=(600, 12)), x,
                            device=dev)
    diff, ran = [], []

    def same(name, a, b):
        ran.append(name)
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            diff.append(name)
    try:
        for mode, shape in (("bitmap", (1, 4)), ("hash", (1, 4)),
                            ("bitmap", (2, 4))):
            grid = rank_grid(*shape, world)
            if grid is None:
                continue
            cfg = SearchConfig(k=10, queue_len=24, m_max=4, max_steps=48,
                               local_steps=3, global_rounds=6,
                               hash_bits=10, visited_mode=mode)
            a = walker_sharded_search(graph, q, cfg, make_search_mesh(
                shape, ranks=grid))
            b = walker_sharded_search(graph, q, cfg, make_search_mesh(
                shape, device=dev))
            same(f"walker {shape} {mode}", a[:2] + tuple(a[2]),
                 b[:2] + tuple(b[2]))
        grid = rank_grid(1, 4, world)
        if grid is not None:
            part = dict(num_shards=4, degree=8, ef_construction=16,
                        passes=1)
            mesh = make_search_mesh((1, 4), ranks=grid)
            block = build_partitioned(x, mesh=mesh, **part)
            serial = build_partitioned(x, device=dev, **part)
            lo = mesh.coord("model") * mesh.lanes("model")
            same("partitioned build", tuple(block),
                 tuple(t[lo:lo + block.num_shards] for t in serial))
            cfg = SearchConfig(k=10, queue_len=24, m_max=1, staged=False,
                               max_steps=64)
            same("corpus (1, 4)",
                 corpus_sharded_search(block, q, cfg, mesh),
                 corpus_sharded_search(serial, q, cfg, make_search_mesh(
                     (1, 4), device=dev)))
        grid = rank_grid(4, 1, world)
        if grid is not None:
            model, tcfg, batch, state = _train_setup(dev)
            got = {}
            for name, mesh in (("ranks", make_search_mesh((4, 1),
                                                          ranks=grid)),
                               ("lanes", make_search_mesh((4, 1),
                                                          device=dev))):
                s = tree_map(torch.clone, state)
                step = make_compressed_dp_train_step(model, tcfg, mesh)
                ms = []
                for _ in range(2):
                    s, m = step(s, batch)
                    ms.append(torch.stack([m["loss"], m["grad_norm"]]))
                got[name] = (s, ms)
            (sr, mr), (sl, ml) = got["ranks"], got["lanes"]
            lanes, c = 4 // grid[0], rank // grid[1]
            same("compressed params, opt, loss", [
                *_flat(sr.params).values(), *_flat(sr.opt).values(), *mr],
                [*_flat(sl.params).values(), *_flat(sl.opt).values(), *ml])
            same("compressed residual rows",
                 [e.to_local() for e in _flat(sr.err).values()],
                 [e[c * lanes:(c + 1) * lanes]
                  for e in _flat(sl.err).values()])
            r = _resume(tmp, grid[0], dev)
            ran.append("compressed resume")
            if r["ranks"]["metrics"] != r["lanes"]["metrics"] or not all(
                    np.array_equal(r["ranks"][part][k], v)
                    for part in ("params", "opt", "err")
                    for k, v in r["lanes"][part].items()):
                diff.append("compressed resume")
            moved = sr.params
            for shape in ((world, 1), (1, world)):
                moved = reshard_state(moved, make_search_mesh(
                    shape, ranks=shape))
                same(f"reshard {shape}",
                     [whole(t) for t in _flat(moved).values()],
                     list(_flat(sr.params).values()))
            moved = reshard_state(moved, make_search_mesh((1, 1),
                                                          device=dev))
            same("reshard onto the card", list(_flat(moved).values()),
                 list(_flat(sr.params).values()))
        torch.save({"diff": diff, "ran": ran, "backend": ranks.backend(),
                    "device": str(dev)}, os.path.join(tmp, f"card{rank}.pt"))
    finally:
        ranks.shutdown()


def spawn_cards(tmp: str) -> list:
    """:func:`card_rank_main` on one spawned rank a card."""
    world = torch.cuda.device_count()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=card_rank_main, args=(r, world, tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for r, p in enumerate(procs):
            p.join(JOIN_S)
            assert not p.is_alive(), f"rank {r} still runs after {JOIN_S} s"
            assert p.exitcode == 0, f"rank {r} exited with {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [torch.load(os.path.join(tmp, f"card{r}.pt"), weights_only=False)
            for r in range(world)]
