"""Rank bodies for ``tests/test_torch_partition.py``: the partitioned
``CausalLM`` (DTensor parameters, the reference's constraint points) over
the ranks of a gloo process group on the CPU, and the dry run's counting
group.

:func:`spawn` starts 4 gloo ranks and one counting process together:

* each gloo rank (:func:`rank_main`) joins a (2, 2) ``("data", "model")``
  mesh over the 4 ranks and, for each of :data:`LM_ARCHS` (smoke configs
  in f32, one with a single kv head, one MoE under ``--moe-impl a2a``;
  the reference's weights from the test's npz), runs
  ``chip_smoke.partition_run``: the forward's logits, a prefill and
  :data:`DECODE_STEPS` decode steps (in place) and one train step of
  several microbatches; then qwen2-vl's prefill with M-RoPE positions;
  then :data:`FAMILY_ARCHS` (mamba2, zamba2, whisper) alike; it also
  records the op record of :data:`RECORD_ARCH`'s decode step (qwen2.5's
  smoke config) under ``OpCounter`` and the collectives of the ANN dry
  run's walker and corpus searches on small CPU graphs (:func:`ann_records`);
* the counting process (:func:`counting_main`) joins a counting group of
  4 ranks as rank 0 (``ranks.init_counting_ranks``) and makes the same
  record on the meta device, and the ANN searches' collectives on meta
  graphs of the same shapes, counts a DTensor matmul of known placements
  and a shard move (:func:`shard_move`, which the gloo ranks run too),
  and checks that the real entry points refuse the group.

Each process saves its results (gathered whole) to ``<tmp>/<name>.pt``.
Rendezvous is a file under the test's tmp dir, every group has a
timeout, and each process runs one thread.
"""
import dataclasses
import datetime
import multiprocessing
import os

import numpy as np
import torch

TIMEOUT = datetime.timedelta(seconds=120)
JOIN_S = 170
WORLD = 4
MESH = (2, 2)
LM_ARCHS = ("llama3.2-3b", "llama3.2-3b-kv1", "qwen3-moe-30b-a3b",
            "qwen3-moe-30b-a3b-a2a")
# cases of their own: one kv head, so that q's heads split over the model
# ranks and k/v's do not (sharding.repeat_heads); the MoE under
# set_moe_impl("a2a") (moe_a2a.moe_ffn_whole on DTensors)
VARIANTS = {"llama3.2-3b-kv1": ("llama3.2-3b", {"num_kv_heads": 1}),
            "qwen3-moe-30b-a3b-a2a": ("qwen3-moe-30b-a3b", {})}
A2A = ("qwen3-moe-30b-a3b-a2a",)
# the ssm, hybrid and encdec families
FAMILY_ARCHS = ("mamba2-2.7b", "zamba2-7b", "whisper-large-v3")
VLM_ARCH = "qwen2-vl-7b"
B, S, S_MAX = 4, 8, 16
DECODE_STEPS = 4
MICROBATCHES = 2
# (batch, prompt, microbatches) where not (B, S, MICROBATCHES): a data
# rank's 3 rows, 21 tokens, a decode step's 3 and a microbatch's 7, none
# of which splits over the 2 model ranks, so the a2a layer pads each
SHAPES = {"qwen3-moe-30b-a3b-a2a": (6, 7, 3),
          # two SSD chunks of the smoke config's 8
          "mamba2-2.7b": (4, 16, 2)}
RECORD_ARCH = "qwen2.5-3b"


def smoke_cfg(arch: str, get=None):
    """The arch's smoke config (of ``get``, default the port's) computing
    in f32, with a variant's changes."""
    if get is None:
        from repro_torch.configs import get_smoke_config as get
    base, changes = VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(get(base), dtype="float32", **changes)


def inputs(arch: str) -> dict:
    """The numpy-seeded inputs every run of ``arch`` takes: prompt tokens
    (b, s), the decode tokens (steps, b, 1), train targets and a 0/1 mask,
    the vlm's (3, b, s) positions and, for an encoder-decoder, its frames
    (b, encoder_ctx, d_model)."""
    cfg = smoke_cfg(arch)
    b, s, _ = SHAPES.get(arch, (B, S, MICROBATCHES))
    rng = np.random.RandomState(3)
    v = cfg.vocab_size
    out = {"tokens": rng.randint(0, v, (b, s)).astype(np.int32),
           "steps": rng.randint(0, v, (DECODE_STEPS, b, 1)).astype(np.int32),
           "targets": rng.randint(0, v, (b, s)).astype(np.int32),
           "mask": (rng.rand(b, s) > 0.25).astype(np.float32),
           "positions": rng.randint(0, 3 * s, (3, b, s)).astype(np.int32)}
    if cfg.encoder_layers:
        out["frames"] = rng.randn(b, cfg.encoder_ctx,
                                  cfg.d_model).astype(np.float32)
    return out


def run_lm(arch: str, tree, mesh=None) -> dict:
    """``chip_smoke.partition_run`` of ``arch`` on ``tree`` (the port's
    parameter tree) and :func:`inputs`: on ``mesh`` (over ranks), or on
    one device with the train batch's rows in the order of the mesh's
    microbatches."""
    import chip_smoke
    from repro_torch.models import build_model
    from repro_torch.models import moe_a2a
    cfg = smoke_cfg(arch)
    before = moe_a2a.moe_impl()
    moe_a2a.set_moe_impl("a2a" if arch in A2A else "gspmd")
    try:
        return chip_smoke.partition_run(
            build_model(cfg, device="cpu"), tree, cfg, inputs(arch), mesh,
            data=MESH[0], s_max=S_MAX,
            microbatches=SHAPES.get(arch, (B, S, MICROBATCHES))[2])
    finally:
        moe_a2a.set_moe_impl(before)


def load_tree(path: str, arch: str) -> dict:
    """The reference's parameter tree of ``arch`` from the npz (keys
    ``arch/a/b/c``), as numpy leaves."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            name, *parts = key.split("/")
            if name != arch:
                continue
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return tree


def _np(t):
    from repro_torch.sharding import whole
    return whole(t).detach().cpu().numpy()


def decode_record(device: str, mesh) -> tuple:
    """The op record (``OpEntry.key``) and argument bytes of one decode
    step of ``RECORD_ARCH``'s smoke config at (B, S_MAX), its state and
    token placed on ``mesh`` as the dry run places them."""
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import dryrun
    gen = None if device == "meta" else torch.Generator().manual_seed(0)
    return dryrun.record_cell(smoke_cfg(RECORD_ARCH),
                              ShapeConfig("decode_rec", S_MAX, B, "decode"),
                              mesh, generator=gen)


def rank_main(rank: int, tmp: str, weights: str) -> None:
    torch.set_num_threads(1)
    from repro_torch import ranks
    from repro_torch.core.distributed import make_search_mesh
    from repro_torch.launch.dryrun import place_arguments
    from repro_torch.models import build_model
    from repro_torch.models.convert import tree_from_jax
    from repro_torch.sharding import (ACT_RULES, DEFAULT_RULES, RankSharding,
                                      _placements, place, resolve_spec,
                                      use_rules)
    ranks.init_ranks(device="cpu", init_method=f"file://{tmp}/rdv",
                     rank=rank, world=WORLD, timeout=TIMEOUT)
    mesh = make_search_mesh(MESH, ("data", "model"), device="cpu",
                            ranks=MESH)

    def put(t, *logical):
        if isinstance(t, dict):       # the step's arguments
            return place_arguments(t, mesh)
        spec = resolve_spec(tuple(t.shape), logical, mesh, ACT_RULES)
        return place(t, RankSharding(mesh.device_mesh, _placements(
            spec, mesh.axis_names), spec, mesh.device))
    res = {"rank": rank}
    for arch in LM_ARCHS + FAMILY_ARCHS:
        res[arch] = run_lm(arch, tree_from_jax(load_tree(weights, arch),
                                               "cpu"), mesh)
    with use_rules(DEFAULT_RULES, mesh):
        cfg = smoke_cfg(VLM_ARCH)
        model = build_model(cfg, device="cpu")
        params = place_arguments({"params": tree_from_jax(
            load_tree(weights, VLM_ARCH), "cpu")}, mesh)["params"]
        x = inputs(VLM_ARCH)
        logits, st = model.prefill(
            params, put(torch.from_numpy(x["tokens"]), "batch", "seq"),
            s_max=S_MAX, positions=put(torch.from_numpy(x["positions"]),
                                       None, "batch", "seq"))
        res[VLM_ARCH] = {"prefill": _np(logits),
                         "cache_k": _np(st.caches.k)}
    res["record"], res["arg_bytes"] = decode_record("cpu", mesh)
    res["shard_move"] = shard_move(mesh, torch.arange(
        64.).reshape(8, 8))
    res["ann"] = ann_records("cpu", mesh)
    ranks.shutdown()
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))


def shard_move(mesh, x) -> dict:
    """``x`` (8, 8) placed with rows split over ``data`` and moved to
    columns split over it, under ``OpCounter``: the moved tensor gathered
    whole (None on the meta device), the op names and the collective
    bytes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.op_profile import OpCounter
    from repro_torch.launch.roofline import collective_bytes
    from repro_torch.sharding import whole
    dm = mesh.device_mesh
    r = dm.get_local_rank("data")
    t = DTensor.from_local(x[4 * r:4 * (r + 1)], dm,
                           (Shard(0), Replicate()), run_check=False)
    with OpCounter() as counter:
        moved = t.redistribute(placements=(Shard(1), Replicate()))
    return {"whole": None if x.is_meta else whole(moved),
            "local": tuple(moved.to_local().shape),
            "names": [e.name for e in counter.record],
            "collectives": collective_bytes(counter.record)}


def ann_records(device: str, mesh) -> dict:
    """The collectives (``OpEntry.key``) of the ANN dry run's two searches
    (``dryrun_ann.trace_search``) as this rank of ``mesh`` runs them on
    small graphs with one trip of each loop: the walker path
    (``global_rounds=1, local_steps=1``) and the corpus path (one shard a
    ``model`` position, ``max_steps=1``), hash visited sets of 2**10
    slots."""
    from repro_torch.launch import dryrun_ann as da
    model = mesh.axis_size("model")
    q = da.make_queries(8, seed=0, device=device, d=8)
    out = {}
    for kind, index, cfg in (
            ("walker", da.make_graph(400, 0, device, d=8, r=5),
             da.CFG.with_(global_rounds=1, local_steps=1)),
            ("corpus", da.make_corpus(200, model, 0, device, d=8, r=5),
             da.CORPUS_CFG.with_(max_steps=1))):
        counter, _, _ = da.trace_search(kind, index, q, mesh, cfg.with_(
            dist_backend=da.BACKEND, hash_bits=10))
        out[kind] = da.collective_keys(counter.record)
    return out


def counting_main(tmp: str) -> None:
    torch.set_num_threads(1)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch import ranks
    from repro_torch.core.distributed import make_search_mesh
    from repro_torch.launch.op_profile import OpCounter
    from repro_torch.launch.roofline import collective_bytes
    res = {}
    ranks.init_counting_ranks(WORLD)
    mesh = make_search_mesh(MESH, ("data", "model"), device="meta",
                            ranks=MESH)
    res["record"], res["arg_bytes"] = decode_record("meta", mesh)
    # a (64, 64) x (64, 32) product, rows over data, the contraction over
    # model: each rank a (32, 32) x (32, 32) product, one all-reduce of
    # its (32, 32) partial sums at the end
    a = DTensor.from_local(torch.empty(32, 32, device="meta"),
                           mesh.device_mesh, (Shard(0), Shard(1)),
                           run_check=False)
    b = DTensor.from_local(torch.empty(32, 32, device="meta"),
                           mesh.device_mesh, (Replicate(), Shard(0)),
                           run_check=False)
    for _ in range(2):      # the second trace runs no shape propagation
        with OpCounter() as counter:
            (a @ b).redistribute(placements=(Shard(0), Replicate()))
        res.setdefault("matmul", []).append({
            "names": [e.name for e in counter.record],
            "flops": counter.flops_by_dtype(),
            "collectives": collective_bytes(counter.record),
            "peak": counter.peak_bytes})
    res["shard_move"] = shard_move(mesh, torch.empty(8, 8, device="meta"))
    res["ann"] = ann_records("meta", mesh)
    res["refused"] = _refusals()
    ranks.shutdown()
    torch.save(res, os.path.join(tmp, "counting.pt"))


def _refusals() -> dict:
    """Each real entry point's error under the counting group (None when
    it did not raise)."""
    from repro_torch.ann.index import AnnIndex
    from repro_torch.config import TrainConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.ann_engine import AnnEngine
    from repro_torch.train.trainer import Trainer
    cfg = smoke_cfg(RECORD_ARCH)
    model = build_model(cfg, device="cpu")
    calls = {
        "build": lambda: AnnIndex.build(np.zeros((8, 4), np.float32),
                                        device="cpu"),
        "serve_ann": lambda: AnnEngine(None, None),
        "serve_lm": lambda: ServeEngine(model, model),
        "train": lambda: Trainer(model, TrainConfig(), TokenStream(
            cfg.vocab_size, 8, 2, 0, 0, 1)),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except RuntimeError as e:
            out[name] = str(e)
    return out


def spawn(tmp: str, weights: str) -> dict:
    """:func:`rank_main` on WORLD gloo ranks and :func:`counting_main`,
    all started together; returns each one's results by name.  A process
    that fails, or outlives its join limit, fails the call."""
    ctx = multiprocessing.get_context("spawn")
    procs = {f"rank{r}": ctx.Process(target=rank_main,
                                     args=(r, tmp, weights))
             for r in range(WORLD)}
    procs["counting"] = ctx.Process(target=counting_main, args=(tmp,))
    for p in procs.values():
        p.start()
    try:
        for name, p in procs.items():
            p.join(JOIN_S)
            if p.is_alive():
                raise TimeoutError(f"{name} still runs after {JOIN_S} s")
            if p.exitcode != 0:
                raise RuntimeError(f"{name} exited with {p.exitcode}")
    finally:
        for p in procs.values():
            if p.is_alive():
                p.kill()
                p.join(10)
    return {name: torch.load(os.path.join(tmp, f"{name}.pt"),
                             weights_only=False) for name in procs}
