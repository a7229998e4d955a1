"""Device resolution for the port's entry points.

Entry points run on the card: ``device=None`` means CUDA, and raises when no
CUDA device is present rather than silently falling back to the CPU.  Tests
and CPU callers name ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)
