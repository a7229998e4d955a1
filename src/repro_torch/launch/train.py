"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        [--smoke] [--steps 100] [--data N] [--model M] [--compress] \\
        [--ckpt-dir DIR] [--device cpu]

Port of ``repro.launch.train``.  ``--device`` defaults to CUDA (and fails
without a card); ``--device cpu`` trains on the CPU.  The mesh's positions
are lanes of that one device (``--data`` splits the batch for
``--compress``'s int8 all-reduce), and the run is inside
``use_rules(DEFAULT_RULES, mesh)`` as the reference's is (the mesh a
moe model's ``moe_ffn_sharded`` splits over under
``set_moe_impl("a2a")``).  Checkpoints default to a directory under the
temp dir.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.config import TrainConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.sharding import DEFAULT_RULES, use_rules
from repro_torch.train import Trainer
from repro_torch.train.train_step import make_compressed_dp_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient all-reduce (explicit-DP step)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' trains on the "
                         "CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    model = build_model(cfg, device=device)
    tcfg = TrainConfig(
        total_steps=args.steps, warmup_steps=max(args.steps // 10, 1),
        learning_rate=3e-3, checkpoint_every=max(args.steps // 5, 1),
        checkpoint_dir=args.ckpt_dir or os.path.join(
            tempfile.gettempdir(), f"repro_torch_train_{args.arch}"),
        grad_compression="int8" if args.compress else "none")
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         batch=args.batch, seed=0, shard=0, num_shards=1)

    mesh = make_host_mesh(args.data, args.model, device=device)
    with use_rules(DEFAULT_RULES, mesh):
        step = None
        if args.compress:
            step = make_compressed_dp_train_step(model, tcfg, mesh)
        trainer = Trainer(model, tcfg, stream, train_step=step)
        trainer.run(steps=args.steps)
    losses = [m["loss"] for m in trainer.metrics_log]
    print(f"done: arch={cfg.name} loss {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
