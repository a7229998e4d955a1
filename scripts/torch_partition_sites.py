#!/usr/bin/env python3
"""Where the partitioned dry run's collectives come from: one cell of
``repro_torch.launch.dryrun`` (or ``launch.dryrun_ann``) traced on a
production mesh as rank 0 of a counting group, each collective's result
bytes (one card's) summed by the place in the port that issued it.

    PYTHONPATH=src python3 scripts/torch_partition_sites.py \\
        --arch qwen2.5-3b --shape decode_32k --mesh 16x16 [--batch 128] \\
        [--moe-impl a2a] [--top 12]
    PYTHONPATH=src python3 scripts/torch_partition_sites.py --ann walker

A place is the innermost frame of the model, optimizer, train-step or
search code on the stack when the collective ran, beside the innermost
frame of ``sharding.py``, ``models/moe_a2a.py`` or ``ranks.py`` (the
constraint or helper that moved the data), if any; a collective that
autograd's engine issues from a DTensor op's backward has no such frame
and is "backward of a DTensor op".  Prints one JSON line a place, largest
first, then the totals.  The counts are of the meta device's trace, not a
measurement.
"""
import argparse
import collections
import json
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

HELPERS = ("repro_torch/sharding.py", "repro_torch/models/moe_a2a.py",
           "repro_torch/ranks.py")
CALLERS = ("repro_torch/models/", "repro_torch/optim/", "repro_torch/train/",
           "repro_torch/core/")


def _where(stack) -> str:
    """The place a collective ran from (see the module's docstring)."""
    helper = caller = None
    for f in reversed(stack):
        path = f.filename.replace(os.sep, "/")
        # a shard move's all-to-all (core/distributed.py's ``move``) is
        # DTensor's, not the search's
        shard_move = path.endswith("core/distributed.py") and f.name == "move"
        if shard_move:
            continue
        if helper is None and any(h in path for h in HELPERS):
            helper = f"{path.split('repro_torch/')[-1]}:{f.lineno} {f.name}"
        if caller is None and any(c in path for c in CALLERS) \
                and "moe_a2a" not in path:
            caller = f"{path.split('repro_torch/')[-1]}:{f.lineno} {f.name}"
    if caller is None and helper is None:
        return "backward of a DTensor op"
    return " <- ".join(x for x in (helper, caller) if x)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--ann", choices=("walker", "corpus"),
                    help="an ANN dry-run cell in place of --arch/--shape")
    ap.add_argument("--mesh", default="16x16", choices=("16x16", "2x16x16"))
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--moe-impl", default="gspmd", choices=("gspmd", "a2a"))
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not args.ann and not (args.arch and args.shape):
        ap.error("name --arch and --shape, or --ann")
    from repro_torch import ranks
    from repro_torch.launch import dryrun, dryrun_ann, op_profile
    from repro_torch.launch.roofline import collective_kind
    chips = dryrun.MESHES[args.mesh][0]
    ranks.init_counting_ranks(chips)
    sites = collections.defaultdict(lambda: [0, 0])
    append = op_profile.OpCounter._append

    def record(self, name, ins, outs, *rest):
        kind = collective_kind(name)
        if kind is not None:
            nbytes = sum(op_profile.tensor_bytes(t) for t in outs) or sum(
                op_profile.tensor_bytes(t) for t in ins)
            s = sites[(kind, _where(traceback.extract_stack()))]
            s[0] += nbytes
            s[1] += 1
        return append(self, name, ins, outs, *rest)
    op_profile.OpCounter._append = record
    if args.ann:
        facts = dryrun_ann.partition_cell(args.ann, args.mesh == "2x16x16")
        facts.update(trace_s=facts["compile_s"], arch=f"speedann-{args.ann}",
                     shape="serve")
    else:
        facts = dryrun.analyze(dryrun.trace_cell(
            args.arch, args.shape, args.mesh, batch=args.batch,
            moe_impl=args.moe_impl))
    rows = sorted(sites.items(), key=lambda kv: -kv[1][0])
    for (kind, where), (nbytes, n) in rows[:args.top]:
        print(json.dumps({"kind": kind, "bytes_per_card": nbytes,
                          "collectives": n, "site": where}))
    print(json.dumps({
        "arch": facts["arch"], "shape": facts["shape"], "mesh": args.mesh,
        "moe_impl": args.moe_impl, "batch": args.batch,
        "sites": len(rows),
        "bytes_per_card": {k: v / chips
                           for k, v in facts["collectives"].items()},
        "t_collective_s": facts["t_collective_s"],
        "t_compute_s": facts["t_compute_s"],
        "t_memory_s": facts["t_memory_s"],
        "peak_bytes": facts["memory"]["peak_bytes"],
        "trace_s": facts["trace_s"], "device": "meta (counted, not run)"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
