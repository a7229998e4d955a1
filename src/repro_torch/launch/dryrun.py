"""Dry run of every (arch × shape × mesh) cell on the meta device (the
port's counterpart of ``repro.launch.dryrun``).

For each cell this tool:
  1. builds the model and every input of its step on the ``meta`` device
     (shapes and dtypes, no weights, no memory; ``input_specs``,
     ``cell_arguments``);
  2. runs the cell's real step (``make_train_step``, ``prefill`` or
     ``decode_step(..., inplace=True)``) at FULL depth under
     ``launch.op_profile.OpCounter``, which counts every op as it runs;
  3. records the FLOPs by dtype, the bytes, the bytes each card holds and,
     on one card, the live peak and whether it fits, with the roofline
     terms against the H100 (``launch.roofline``), into
     ``torch_dryrun_results.json`` (incremental, resumable).

The reference compiles two reduced unrolled depths and extrapolates,
because XLA's ``cost_analysis`` counts a while-loop body once.  The port
runs every layer as it would on the card, so its counts are whole and
there is nothing to extrapolate.

Meshes: ``1xh100`` is the whole cell on one card: ``memory`` holds the
argument bytes (parameters or train state, caches, batch), the peak (the
arguments plus the counter's live peak) and ``fits`` (peak <= 80 GB);
no collective is counted.  ``16x16`` and ``2x16x16`` are the reference's
production meshes (``launch.mesh.make_production_mesh``).

The partitioner (every family): the cell runs as rank 0 of a counting
group of 256 or 512 ranks
(``ranks.init_counting_ranks``, torch's ``fake`` backend, which moves no
data), in a spawned process a mesh.  The arguments are DTensors on the
meta device, placed by ``sharding.spec_for_path`` (DEFAULT_RULES; the
batch by ACT_RULES), and DTensor's sharding propagation, with the
reference's constraint points (``sharding.shard``), inserts the
collectives, as XLA's partitioner compiles one device's SPMD module.
``resolve_spec`` drops the axes that do not divide, so every rank's
shapes are rank 0's.  The counter records that one rank's ops and
collectives: FLOPs by dtype, bytes and ``collectives`` (kind -> result
bytes, ``roofline.collective_bytes``) are one card's times ``chips`` (the
reference's module-global convention), so the terms divide them back;
``memory`` holds the local shards' bytes and the peak (those plus the
rank's live peak), and ``fits``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape train_4k --mesh 1xh100,16x16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --shape prefill_32k \\
        --mesh 1xh100 --batch 1 --tag b1 --out /tmp/b1.json

``--batch`` cuts every cell's global batch (with ``--tag``, the results
sit beside the whole cells').  ``--all`` runs the two partitioned meshes'
workers beside the main process's one-card traces.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Optional

import torch

from repro_torch import ranks
from repro_torch.config import (FAMILY_DENSE, FAMILY_ENCDEC, FAMILY_HYBRID,
                                FAMILY_MOE, FAMILY_SSM, FAMILY_VLM,
                                SHAPES_BY_NAME, ModelConfig, ShapeConfig,
                                TrainConfig)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.shapes import cell_matrix
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_profile import OpCounter
from repro_torch.models import build_model
from repro_torch.sharding import (ACT_RULES, DEFAULT_RULES, RankSharding,
                                  _placements, place, resolve_spec,
                                  sharding_for, spec_for_path, use_rules)
from repro_torch.treepath import (flatten_with_path, keystr_simple, tree_map,
                                  tree_map_with_path)

RESULTS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "../../../torch_dryrun_results.json")

# mesh name -> (chips, multi_pod); None: one card, the whole cell
MESHES = {"1xh100": (1, None), "16x16": (256, False),
          "2x16x16": (512, True)}
# the reference's mesh names
MESH_ALIASES = {"single": "16x16", "multi": "2x16x16"}
# the one-card mesh's reason, as before the partitioner
ONE_CARD = ("no partitioner: collectives are not counted and nothing "
            "is split across cards (ROADMAP.md §1 item 8, the dry "
            "run's partitioner)")
# the families the partitioner runs
PARTITIONED = (FAMILY_DENSE, FAMILY_MOE, FAMILY_VLM, FAMILY_SSM,
               FAMILY_HYBRID, FAMILY_ENCDEC)

# logical axes of the batch inputs (the reference's batch_specs)
BATCH_LOGICAL = {
    "tokens": ("batch", "seq"), "targets": ("batch", "seq"),
    "mask": ("batch", "seq"),
    "frames": ("batch", "frames", "embed"),
    "positions": (None, "batch", "seq"),
    "token": ("batch", None),
}


def train_config_for(cfg: ModelConfig) -> TrainConfig:
    """>=100B params: bf16 moments so optimizer state fits a 256-chip pod;
    full remat; 8 microbatches (the reference's baseline job config)."""
    big = cfg.param_count() >= 1e11
    return TrainConfig(
        moment_dtype="bfloat16" if big else "float32",
        remat="full", microbatches=8)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, device="meta",
                batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Every model input of this cell, with the reference's keys and
    dtypes, on ``device``: empty on ``meta``, else zeros (valid token ids,
    positions) and a mask of ones.  ``batch`` cuts the global batch."""
    b, s = batch or shape.global_batch, shape.seq_len
    dev = torch.device(device)

    def make(size, dtype, fill=0):
        if dev.type == "meta":
            return torch.empty(size, dtype=dtype, device=dev)
        return torch.full(size, fill, dtype=dtype, device=dev)
    if shape.kind == "decode":      # one new token against a seq_len cache
        return {"token": make((b, 1), torch.int32)}
    out = {"tokens": make((b, s), torch.int32)}
    if shape.kind == "train":
        out["targets"] = make((b, s), torch.int32)
        out["mask"] = make((b, s), torch.float32, 1)
    if cfg.family == FAMILY_ENCDEC:  # stub frontend: frame embeddings
        out["frames"] = make((b, cfg.encoder_ctx, cfg.d_model),
                             torch.bfloat16)
    if cfg.family == FAMILY_VLM:
        out["positions"] = make((3, b, s), torch.int32)
    return out


def cell_arguments(model, cfg: ModelConfig, shape: ShapeConfig,
                   tcfg: TrainConfig, batch: Optional[int] = None,
                   generator: Optional[torch.Generator] = None) -> Dict:
    """The step's arguments on the model's device: ``state`` (train) or
    ``params`` (the reference's tree, drawn from ``generator``; none on
    ``meta``), ``dstate`` (decode) and ``batch``."""
    from repro_torch.train.train_step import init_train_state
    dev = model.device
    args = {}
    if shape.kind == "train":
        args["state"] = init_train_state(model, generator, tcfg)
    else:
        args["params"] = model.init_tree(generator)
    if shape.kind == "decode":
        args["dstate"] = model.init_decode_state(batch or shape.global_batch,
                                                 shape.seq_len)
    args["batch"] = input_specs(cfg, shape, dev, batch)
    return args


def cell_step(model, cfg: ModelConfig, shape: ShapeConfig,
              tcfg: TrainConfig):
    """``step(args)``: the cell's real step on :func:`cell_arguments`."""
    if shape.kind == "train":
        from repro_torch.train import make_train_step
        train = make_train_step(model, tcfg)
        return lambda a: train(a["state"], a["batch"])
    if shape.kind == "decode":
        return lambda a: model.decode_step(a["params"], a["dstate"],
                                           a["batch"]["token"], inplace=True)
    s = shape.seq_len
    if cfg.family == FAMILY_ENCDEC:
        return lambda a: model.prefill(a["params"], a["batch"]["frames"],
                                       a["batch"]["tokens"], s_max=s)
    if cfg.family == FAMILY_VLM:
        return lambda a: model.prefill(a["params"], a["batch"]["tokens"],
                                       s_max=s,
                                       positions=a["batch"]["positions"])
    return lambda a: model.prefill(a["params"], a["batch"]["tokens"],
                                   s_max=s)


def _storages(tree) -> Dict[int, int]:
    out = {}
    for _, t in flatten_with_path(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages the tensors of ``tree`` hold."""
    return sum(_storages(tree).values())


def per_card_bytes(args: Dict, mesh) -> int:
    """Bytes one card of ``mesh`` holds of the arguments: each leaf of the
    state (``params``, ``state``, ``dstate``) under its spec by path
    (``sharding.spec_for_path``, DEFAULT_RULES, as ``param_specs`` gives
    it for that tree), each batch input under ``ACT_RULES``, divided over
    the mesh axes its spec names."""
    sizes = mesh.shape

    def share(t, spec) -> int:
        n = t.numel() * t.element_size()
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    n //= sizes[a]
        return n
    total = 0
    for k, tree in args.items():
        for path, t in flatten_with_path(tree):
            if k == "batch":
                spec = resolve_spec(tuple(t.shape), BATCH_LOGICAL[path[0]],
                                    mesh, ACT_RULES)
            else:
                spec = spec_for_path(keystr_simple(path), tuple(t.shape),
                                     mesh, DEFAULT_RULES)
            total += share(t, spec)
    return total


def _outputs_bytes(out, args) -> int:
    held = _storages(args)
    return sum(n for k, n in _storages(out).items() if k not in held)


def place_arguments(args: Dict, mesh) -> Dict:
    """``args`` as DTensors on ``mesh`` (a mesh over ranks): each leaf of
    the state (``params``, ``state``, ``dstate``) placed by its path
    (``sharding.sharding_for``, DEFAULT_RULES), each batch input by
    ``ACT_RULES``, as :func:`per_card_bytes` counts them."""
    out = {}
    for k, tree in args.items():
        if k == "batch":
            def one(path, t):
                spec = resolve_spec(tuple(t.shape), BATCH_LOGICAL[path[0]],
                                    mesh, ACT_RULES)
                return place(t, RankSharding(
                    mesh.device_mesh, _placements(spec, mesh.axis_names),
                    spec, mesh.device))
        else:
            def one(path, t):
                return place(t, sharding_for(keystr_simple(path),
                                             tuple(t.shape), mesh,
                                             DEFAULT_RULES))
        out[k] = tree_map_with_path(one, tree)
    return out


def local_bytes(tree) -> int:
    """Bytes of the distinct storages this rank holds of ``tree`` (a
    DTensor's local shard)."""
    from repro_torch.sharding import is_dtensor
    return tree_bytes(tree_map(lambda t: t.to_local() if is_dtensor(t)
                               else t, tree))


def trace(model, cfg: ModelConfig, shape: ShapeConfig, tcfg: TrainConfig,
          args: Dict, mesh=None) -> Dict:
    """Run the cell's step on ``args`` under an :class:`OpCounter` (inside
    ``use_rules(DEFAULT_RULES, mesh)`` when a mesh is given: ``moe_a2a``'s
    lanes, or the partitioner's mesh over ranks).  Returns the counter,
    the step's output and the seconds it took."""
    step = cell_step(model, cfg, shape, tcfg)
    t0 = time.perf_counter()
    with use_rules(DEFAULT_RULES, mesh), OpCounter() as counter:
        out = step(args)
    return {"counter": counter, "out": out,
            "trace_s": time.perf_counter() - t0}


def trace_cell(arch: str, shape_name: str, mesh_kind: str = "1xh100",
               param_dtype: Optional[str] = None, smoke: bool = False,
               batch: Optional[int] = None,
               microbatches: Optional[int] = None,
               moe_impl: str = "gspmd") -> Dict:
    """Build cell ``arch|shape_name`` on the meta device and trace its
    step at full depth (``batch`` cuts the global batch, ``microbatches``
    the train config's).  Returns the trace (:func:`trace`) with ``cfg``,
    ``shape``, ``tcfg``, ``args``, ``mesh`` and ``mesh_kind``."""
    from repro_torch.models import moe_a2a
    cfg = (get_smoke_config if smoke else get_config)(arch)
    if param_dtype:   # parameter storage dtype (the reference's knob)
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    shape = SHAPES_BY_NAME[shape_name]
    mesh_kind = MESH_ALIASES.get(mesh_kind, mesh_kind)
    chips, multi = MESHES[mesh_kind]
    split = partitioned(cfg, mesh_kind)
    if split and not (ranks.counting() and ranks.world() == chips):
        raise RuntimeError(
            f"the {mesh_kind} partitioner traces rank 0 of a counting group "
            f"of {chips} ranks (ranks.init_counting_ranks({chips})) in a "
            "process of its own: main() spawns it")
    mesh = (make_production_mesh(multi_pod=multi, device="meta",
                                 ranks=split)
            if multi is not None else None)
    tcfg = train_config_for(cfg)
    if microbatches:
        tcfg = dataclasses.replace(tcfg, microbatches=microbatches)
    model = build_model(cfg, device="meta")
    args = cell_arguments(model, cfg, shape, tcfg, batch)
    if split:
        args = place_arguments(args, mesh)
    before = moe_a2a.moe_impl()
    moe_a2a.set_moe_impl(moe_impl)
    try:
        res = trace(model, cfg, shape, tcfg, args,
                    mesh if moe_impl == "a2a" or split else None)
    finally:
        moe_a2a.set_moe_impl(before)
    res.update(cfg=cfg, shape=shape, tcfg=tcfg, args=args, mesh=mesh,
               mesh_kind=mesh_kind, chips=chips, arch=arch,
               partitioned=split)
    return res


def partitioned(cfg: ModelConfig, mesh_kind: str) -> bool:
    """Whether the partitioner runs ``cfg``'s cells on ``mesh_kind``."""
    return (MESHES[MESH_ALIASES.get(mesh_kind, mesh_kind)][1] is not None
            and cfg.family in PARTITIONED)


def trace_facts(arch: str, shape_name: str, record: bool = False,
                **kw) -> Dict:
    """:func:`analyze` of :func:`trace_cell` on ``1xh100`` (``kw`` as
    there), with the op record's keys (``OpEntry.key``) under ``record``
    when asked: a picklable summary for another process."""
    res = trace_cell(arch, shape_name, "1xh100", **kw)
    facts = analyze(res)
    if record:
        facts["record"] = [e.key() for e in res["counter"].record]
    return facts


def analyze(res: Dict) -> Dict:
    """The reference's keys for a traced cell (``hlo_flops``/``hlo_bytes``
    are ``flops`` (+ ``flops_by_dtype``)/``bytes``, ``compile_s`` is
    ``trace_s``; no ``scan_hlo_flops`` or ``extrapolation``)."""
    counter, chips = res["counter"], res["chips"]
    fby = counter.flops_by_dtype()
    nbytes = float(counter.bytes())
    args = res["args"]
    coll = None
    reason = ONE_CARD
    if res.get("partitioned"):     # one card's counts, times the cards
        fby = {k: v * chips for k, v in fby.items()}
        nbytes *= chips
        coll = {k: v * chips for k, v in
                rl.collective_bytes(counter.record).items()}
        arg_bytes = local_bytes(args)
        peak = arg_bytes + counter.peak_bytes
        memory = {"argument_bytes": arg_bytes,
                  "output_bytes": _outputs_bytes(
                      tree_map(_local, res["out"]), tree_map(_local, args)),
                  "trace_peak_bytes": counter.peak_bytes,
                  "peak_bytes": peak}
        fits = peak <= rl.HBM_BYTES
        reason = None
    else:
        arg_bytes = tree_bytes(args)
        peak = arg_bytes + counter.peak_bytes
        memory = {"argument_bytes": arg_bytes,
                  "output_bytes": _outputs_bytes(res["out"], args),
                  "trace_peak_bytes": counter.peak_bytes,
                  "peak_bytes": peak}
        fits = peak <= rl.HBM_BYTES
    flops = float(sum(fby.values()))
    terms = rl.roofline_terms(fby, nbytes, coll, chips)
    mf = rl.model_flops(res["cfg"], res["shape"])
    return {
        "arch": res["arch"], "shape": res["shape"].name,
        "mesh": res["mesh_kind"], "chips": chips,
        "trace_s": res["trace_s"], "ops": len(counter.record),
        "flops": flops, "flops_by_dtype": fby, "bytes": nbytes,
        "collectives": coll, "memory": memory, "fits": fits,
        "model_flops": mf,
        "useful_flops_ratio": (mf / flops) if flops else None,
        "reason": reason, **terms,
    }


def _local(t):
    from repro_torch.sharding import is_dtensor
    return t.to_local() if is_dtensor(t) else t


def load_results(path: str = RESULTS_PATH) -> Dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(res: Dict, path: str = RESULTS_PATH) -> None:
    with open(path, "w") as f:
        json.dump(res, f, indent=1, sort_keys=True)


def record_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                generator: Optional[torch.Generator] = None):
    """(the op record's keys, the argument bytes this rank holds) of the
    cell's step on ``mesh`` (a mesh over ranks, on its device), its
    arguments placed as the partitioner places them (weights drawn from
    ``generator``; none on ``meta``)."""
    model = build_model(cfg, device=mesh.device)
    tcfg = train_config_for(cfg)
    args = place_arguments(cell_arguments(model, cfg, shape, tcfg,
                                          generator=generator), mesh)
    res = trace(model, cfg, shape, tcfg, args, mesh)
    return [e.key() for e in res["counter"].record], local_bytes(args)


_POOLS: Dict[int, ProcessPoolExecutor] = {}


def _join_counting(world: int) -> None:
    torch.set_num_threads(1)
    ranks.init_counting_ranks(world)


def _partition_task(arch: str, shape_name: str, mesh_kind: str,
                    kw: Dict) -> Dict:
    return analyze(trace_cell(arch, shape_name, mesh_kind, **kw))


def record_task(cfg: ModelConfig, shape: ShapeConfig, mesh_shape) -> tuple:
    """:func:`record_cell` as rank 0 of the worker's counting group, on a
    ("data", "model") mesh of ``mesh_shape`` over its ranks."""
    from repro_torch.core.distributed import make_search_mesh
    mesh = make_search_mesh(mesh_shape, ("data", "model"), device="meta",
                            ranks=mesh_shape)
    return record_cell(cfg, shape, mesh)


def counting_worker(world: int) -> ProcessPoolExecutor:
    """A spawned process that is rank 0 of a counting group of ``world``
    ranks (a process holds one default group), for :func:`_partition_task`
    and :func:`record_task`; kept until :func:`close_workers`."""
    if world not in _POOLS:
        _POOLS[world] = ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"),
            initializer=_join_counting, initargs=(world,))
    return _POOLS[world]


def partition_worker(mesh_kind: str) -> ProcessPoolExecutor:
    """The counting worker that traces ``mesh_kind``'s partitioned
    cells."""
    return counting_worker(MESHES[MESH_ALIASES.get(mesh_kind,
                                                   mesh_kind)][0])


def close_workers() -> None:
    for pool in _POOLS.values():
        pool.shutdown()
    _POOLS.clear()


def run_cell(arch: str, shape_name: str, meshes, res: Dict, path: str,
             force: bool = False, tag: str = "", **kw) -> int:
    """Trace one cell on each of ``meshes`` (the partitioned meshes'
    traces run in their workers meanwhile, ``1xh100``'s here); returns
    how many meshes failed."""
    todo = [m for m in meshes
            if force or res.get(f"{arch}|{shape_name}|{m}"
                                + (f"#{tag}" if tag else ""),
                                {}).get("status") != "ok"]
    for m in meshes:
        if m not in todo:
            print(f"[skip cached] {arch}|{shape_name}|{m}")
    cfg = (get_smoke_config if kw.get("smoke") else get_config)(arch)
    futures = {m: partition_worker(m).submit(_partition_task, arch,
                                             shape_name, m, kw)
               for m in todo if partitioned(cfg, m)}
    fails = 0
    for m in todo:
        key = f"{arch}|{shape_name}|{m}" + (f"#{tag}" if tag else "")
        t0 = time.perf_counter()
        try:
            out = (futures[m].result() if m in futures
                   else analyze(trace_cell(arch, shape_name, m, **kw)))
            out["status"] = "ok"
            res[key] = out
            print(f"[ok] {key}  trace={out['trace_s']:.1f}s "
                  f"flops={out['flops']:.3e} bytes={out['bytes']:.3e} "
                  f"dominant={out['dominant']} args/card="
                  f"{out['memory']['argument_bytes'] / 1e9:.2f}GB "
                  f"peak={out['memory']['peak_bytes'] / 1e9:.2f}GB "
                  f"fits={out['fits']}"
                  + (" wire/card={:.3f}GB".format(
                      out["collective_wire_bytes"] / MESHES[m][0] / 1e9)
                     if out["collective_wire_bytes"] is not None else "")
                  + f"  ({time.perf_counter() - t0:.1f}s)")
        except Exception as e:  # noqa: BLE001 — record the failure
            res[key] = {"status": "fail",
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-2000:]}
            print(f"[FAIL] {key}: {type(e).__name__}: {e}")
            fails += 1
        save_results(res, path)
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="1xh100,16x16,2x16x16",
                    help="comma-separated: 1xh100, 16x16 (single), "
                         "2x16x16 (multi)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--moe-impl", default="gspmd", choices=("gspmd", "a2a"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--param-dtype", default=None,
                    help="parameter storage dtype (float32, bfloat16)")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs in place of the full ones")
    ap.add_argument("--batch", type=int, default=None,
                    help="cut each cell's global batch to this")
    ap.add_argument("--out", default=RESULTS_PATH)
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.shape):
        ap.error("name --arch and/or --shape, or --all")
    meshes = [MESH_ALIASES.get(m, m) for m in args.mesh.split(",")]
    for m in meshes:
        if m not in MESHES:
            ap.error(f"unknown mesh {m!r}; one of {tuple(MESHES)}")
    res = load_results(args.out)
    n_ok = n_fail = 0
    t0 = time.perf_counter()
    for cell in cell_matrix():
        if args.arch and cell.arch != args.arch:
            continue
        if args.shape and cell.shape.name != args.shape:
            continue
        if cell.skip is not None:
            key_base = f"{cell.arch}|{cell.shape.name}"
            for m in meshes:
                res[f"{key_base}|{m}"] = {"status": "skip",
                                          "reason": cell.skip}
            save_results(res, args.out)
            print(f"[documented skip] {key_base}: "
                  f"{cell.skip.split(';')[0]}")
            continue
        fails = run_cell(cell.arch, cell.shape.name, meshes, res, args.out,
                         force=args.force, tag=args.tag,
                         param_dtype=args.param_dtype, smoke=args.smoke,
                         batch=args.batch, moe_impl=args.moe_impl)
        n_fail += fails
        n_ok += len(meshes) - fails
    close_workers()
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed in "
          f"{time.perf_counter() - t0:.0f} s "
          f"(results -> {os.path.abspath(args.out)})")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
