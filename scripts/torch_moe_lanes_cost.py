"""Time ``moe_a2a.moe_ffn_sharded`` as lanes of one card, and take the
peak memory of its forward and backward, on the exact set-up of
``chip_smoke.py`` phase 17 (one full-width qwen3-moe-30b-a3b layer, f32,
2,048 integer tokens, a router on a 2^-12 grid), for the meshes of phases
17 and 21: (2, 4) a2a, (1, 3) tp and (2, 6) tp.  ``--src`` names the
``src`` directory whose ``repro_torch`` runs, so that one call can time
two trees:

    python3 scripts/torch_moe_lanes_cost.py [--src DIR] [--seed 0]

Per mesh: ``fwd_ms``, the forward under ``torch.inference_mode()`` (the
call phase 17 times); ``fwd_bwd_ms``, the forward and the backward of
sum(y · gy) + aux with the four leaves and x requiring gradients; each the
median of 3 synced walls after one warm call; ``peak_bytes``, the most
memory allocated during one forward and backward beyond what was
allocated before it (``torch.cuda.max_memory_allocated``).  Prints the
card's line, then ``MOE_LANES_COST {...}``.  Needs a CUDA device.
"""
import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((2, 4), (1, 3), (2, 6))
REPS = 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.src))   # before any port import
    if not torch.cuda.is_available():
        print("torch_moe_lanes_cost: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch
    from repro_torch.core.distributed import make_search_mesh
    from repro_torch.models import moe_a2a
    from repro_torch.sharding import DEFAULT_RULES, use_rules

    cfg, p, x, gy = cs.moe_exact_setup(args.seed, "cuda")

    def fwd(mesh):
        with torch.inference_mode(), use_rules(DEFAULT_RULES, mesh):
            return moe_a2a.moe_ffn_sharded(p, x, cfg)

    def fwd_bwd(mesh):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        xg = x.detach().clone().requires_grad_(True)
        with use_rules(DEFAULT_RULES, mesh):
            y, aux = moe_a2a.moe_ffn_sharded(leaves, xg, cfg)
        ((y * gy).sum() + aux).backward()

    def walls(fn, mesh):
        fn(mesh)
        out = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(mesh)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    res = {"src": os.path.dirname(os.path.abspath(repro_torch.__file__)),
           "tokens": cs.MOE_LANE_TOKENS}
    for shape in MESHES:
        mesh = make_search_mesh(shape)
        name = "a2a" if cfg.moe.num_experts % shape[1] == 0 else "tp"
        fw, fb = walls(fwd, mesh), walls(fwd_bwd, mesh)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fwd_bwd(mesh)
        torch.cuda.synchronize()
        res[f"{name}_{shape[0]}x{shape[1]}"] = {
            "fwd_ms": statistics.median(fw), "fwd_ms_all": fw,
            "fwd_bwd_ms": statistics.median(fb), "fwd_bwd_ms_all": fb,
            "peak_bytes": torch.cuda.max_memory_allocated() - base}
        torch.cuda.empty_cache()
    print(json.dumps({"card": cs.smi_line()}))
    print("MOE_LANES_COST " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
