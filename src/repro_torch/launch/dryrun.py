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
arguments plus the counter's live peak) and ``fits`` (peak <= 80 GB).
``16x16`` and ``2x16x16`` are the reference's production meshes (lanes of
the meta device, ``launch.mesh.make_production_mesh``): the argument bytes
one card holds under ``sharding.param_specs`` (DEFAULT_RULES) and the
batch under ``ACT_RULES``; the peak is null there.  No partitioner exists
(ROADMAP.md §1 item 8), so on every mesh ``t_collective_s`` is null and
``dominant`` is chosen from compute and memory; FLOPs and bytes are the
whole cell's, and the terms divide them over the mesh's cards, as the
reference's do.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape train_4k --mesh 1xh100,16x16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --shape prefill_32k \\
        --mesh 1xh100 --batch 1 --tag b1 --out /tmp/b1.json

``--batch`` cuts every cell's global batch (with ``--tag``, the results
sit beside the whole cells').  ``--all`` takes ~8 minutes on one CPU core
(the train cells' traces, 16-96 s each, most of it).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.config import (FAMILY_ENCDEC, FAMILY_VLM, SHAPES_BY_NAME,
                                ModelConfig, ShapeConfig, TrainConfig)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.shapes import cell_matrix
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_profile import OpCounter
from repro_torch.models import build_model
from repro_torch.sharding import (ACT_RULES, DEFAULT_RULES, resolve_spec,
                                  spec_for_path, use_rules)
from repro_torch.treepath import flatten_with_path, keystr_simple

RESULTS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "../../../torch_dryrun_results.json")

# mesh name -> (chips, multi_pod); None: one card, the whole cell
MESHES = {"1xh100": (1, None), "16x16": (256, False),
          "2x16x16": (512, True)}
# the reference's mesh names
MESH_ALIASES = {"single": "16x16", "multi": "2x16x16"}
NO_PARTITIONER = ("no partitioner: collectives are not counted and nothing "
                  "is split across cards (ROADMAP.md §1 item 8, the dry "
                  "run's partitioner)")

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


def trace(model, cfg: ModelConfig, shape: ShapeConfig, tcfg: TrainConfig,
          args: Dict, mesh=None) -> Dict:
    """Run the cell's step on ``args`` under an :class:`OpCounter` (inside
    ``use_rules(DEFAULT_RULES, mesh)`` when a mesh is given, for
    ``moe_a2a``'s lanes).  Returns the counter, the step's output and the
    seconds it took."""
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
    mesh = (make_production_mesh(multi_pod=multi, device="meta")
            if multi is not None else None)
    tcfg = train_config_for(cfg)
    if microbatches:
        tcfg = dataclasses.replace(tcfg, microbatches=microbatches)
    model = build_model(cfg, device="meta")
    args = cell_arguments(model, cfg, shape, tcfg, batch)
    before = moe_a2a.moe_impl()
    moe_a2a.set_moe_impl(moe_impl)
    try:
        res = trace(model, cfg, shape, tcfg, args,
                    mesh if moe_impl == "a2a" else None)
    finally:
        moe_a2a.set_moe_impl(before)
    res.update(cfg=cfg, shape=shape, tcfg=tcfg, args=args, mesh=mesh,
               mesh_kind=mesh_kind, chips=chips, arch=arch)
    return res


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
    flops = float(sum(fby.values()))
    nbytes = float(counter.bytes())
    args = res["args"]
    if res["mesh"] is None:
        arg_bytes = tree_bytes(args)
        peak = arg_bytes + counter.peak_bytes
        memory = {"argument_bytes": arg_bytes,
                  "output_bytes": _outputs_bytes(res["out"], args),
                  "trace_peak_bytes": counter.peak_bytes,
                  "peak_bytes": peak}
        fits = peak <= rl.HBM_BYTES
    else:
        memory = {"argument_bytes": per_card_bytes(args, res["mesh"]),
                  "output_bytes": None, "trace_peak_bytes": None,
                  "peak_bytes": None}
        fits = None
    terms = rl.roofline_terms(fby, nbytes, None, chips)
    mf = rl.model_flops(res["cfg"], res["shape"])
    return {
        "arch": res["arch"], "shape": res["shape"].name,
        "mesh": res["mesh_kind"], "chips": chips,
        "trace_s": res["trace_s"], "ops": len(counter.record),
        "flops": flops, "flops_by_dtype": fby, "bytes": nbytes,
        "collectives": None, "memory": memory, "fits": fits,
        "model_flops": mf,
        "useful_flops_ratio": (mf / flops) if flops else None,
        "reason": NO_PARTITIONER, **terms,
    }


def load_results(path: str = RESULTS_PATH) -> Dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(res: Dict, path: str = RESULTS_PATH) -> None:
    with open(path, "w") as f:
        json.dump(res, f, indent=1, sort_keys=True)


def run_cell(arch: str, shape_name: str, meshes, res: Dict, path: str,
             force: bool = False, tag: str = "", **kw) -> int:
    """Trace one cell once and record it on each of ``meshes``; returns
    how many meshes failed."""
    todo = [m for m in meshes
            if force or res.get(f"{arch}|{shape_name}|{m}"
                                + (f"#{tag}" if tag else ""),
                                {}).get("status") != "ok"]
    for m in meshes:
        if m not in todo:
            print(f"[skip cached] {arch}|{shape_name}|{m}")
    base = None
    fails = 0
    for m in todo:
        key = f"{arch}|{shape_name}|{m}" + (f"#{tag}" if tag else "")
        t0 = time.perf_counter()
        try:
            if base is None or kw.get("moe_impl") == "a2a":
                base = trace_cell(arch, shape_name, m, **kw)
            cell = dict(base, mesh_kind=m, chips=MESHES[m][0],
                        mesh=(make_production_mesh(multi_pod=MESHES[m][1],
                                                   device="meta")
                              if MESHES[m][1] is not None else None))
            out = analyze(cell)
            out["status"] = "ok"
            res[key] = out
            print(f"[ok] {key}  trace={out['trace_s']:.1f}s "
                  f"flops={out['flops']:.3e} bytes={out['bytes']:.3e} "
                  f"dominant={out['dominant']} args/card="
                  f"{out['memory']['argument_bytes'] / 1e9:.2f}GB"
                  + (f" peak={out['memory']['peak_bytes'] / 1e9:.2f}GB "
                     f"fits={out['fits']}" if out["fits"] is not None
                     else "")
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
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed in "
          f"{time.perf_counter() - t0:.0f} s "
          f"(results -> {os.path.abspath(args.out)})")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
