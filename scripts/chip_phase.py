#!/usr/bin/env python3
"""Run one LM phase of ``chip_smoke.py`` alone on the card, with the torch
flags its ``main`` sets, and print the phase's line.

    PYTHONPATH=src python3 scripts/chip_phase.py ssm [--seed 0] > ssm.json

Phases: ``train`` (16), ``moe`` (17), ``ssm`` (18), ``encdec`` (19),
``launch`` (20) and ``partition`` (22): the ones that need no index
(``launch`` builds the rowgather kernel at its first launch); ``ranks``
(21) first runs the phases that make its inputs (4-5, 14 and 16's first
steps; ``chip_smoke.ranks_alone``).
Needs a CUDA device.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("phase",
                    choices=("train", "moe", "ssm", "encdec", "launch",
                             "ranks", "partition"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("chip_phase: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = cs.smi_line()
    print(json.dumps({"card": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    t0 = time.perf_counter()
    run = (cs.ranks_alone if args.phase == "ranks"
           else getattr(cs, f"{args.phase}_phase"))
    out, launches = run(args.seed, smi)
    print(json.dumps(out, default=str))
    print(json.dumps({"launches": launches,
                      "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
