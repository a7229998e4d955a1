"""Learning-rate schedules (port of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr``, then a cosine to ``final_frac`` of it
    at ``total``: a float32 scalar on ``step``'s device (a Python number
    gives a CPU scalar)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                              * prog))
    return torch.where(step < warmup, warm, base_lr * cos)
