"""Serving launcher: ANN search service or LM decode service, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode ann [--n 8000]
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \\
        --arch yi-9b --smoke

Port of ``repro.launch.serve``.  ``--device`` defaults to CUDA (and fails
without a card); ``--device cpu`` runs the plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_ann(args, device: torch.device) -> None:
    from repro_torch.config import SearchConfig
    from repro_torch.core import build_nsg, recall_at_k, search_speedann_batch
    from repro_torch.data import make_vector_dataset

    ds = make_vector_dataset("sift", n=args.n, n_queries=args.batch, k=10,
                             dim=32, device=device)
    graph = build_nsg(ds.base, degree=32, knn_k=32, ef_construction=96,
                      device=device)
    cfg = SearchConfig(k=10, queue_len=96, m_max=8, num_walkers=8,
                       max_steps=384, local_steps=8)
    q = torch.from_numpy(ds.queries).to(device)
    search_speedann_batch(graph, q, cfg)
    _sync(device)
    t0 = time.perf_counter()
    ids, _, _ = search_speedann_batch(graph, q, cfg)
    _sync(device)
    dt = time.perf_counter() - t0
    r = recall_at_k(ids.cpu().numpy(), ds.gt_ids, 10)
    print(f"ann-serve: {args.batch} queries in {dt * 1e3:.1f}ms "
          f"({dt / args.batch * 1e3:.2f}ms/q) recall@10={r:.3f} "
          f"device={device}")


def serve_lm(args, device: torch.device) -> None:
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    eng = ServeEngine(model, params, s_max=64)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, 8),
                           generator=torch.Generator().manual_seed(1))
    eng.generate(prompt, steps=16, temperature=0.8)
    _sync(device)
    t0 = time.perf_counter()
    toks, _ = eng.generate(prompt, steps=16, temperature=0.8)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"lm-serve: arch={cfg.name} {args.batch}x16 tokens in "
          f"{dt * 1e3:.1f}ms; sample row: {np.asarray(toks.cpu())[0][:8]} "
          f"device={device}")


def main(argv=None) -> None:
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("ann", "lm"), default="ann")
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    (serve_ann if args.mode == "ann" else serve_lm)(args, device)


if __name__ == "__main__":
    main()
