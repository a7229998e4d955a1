"""The assigned (architecture × input-shape) cell matrix — 40 cells (port
of ``repro.configs.shapes``).

``decode_*`` / ``long_*`` run one token against a seq_len KV cache / SSM
state; ``train_4k`` runs a train step; ``prefill_32k`` the prefill.
``long_500k`` requires sub-quadratic attention: it RUNS for ssm/hybrid
(mamba2-2.7b, zamba2-7b) and is a documented SKIP for the eight
pure-full-attention architectures.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

from repro_torch.config import ALL_SHAPES, ShapeConfig
from repro_torch.configs import ARCH_IDS, get_config


class Cell(NamedTuple):
    arch: str
    shape: ShapeConfig
    skip: Optional[str]        # None = runs; else the documented reason


def cell_matrix() -> List[Cell]:
    cells: List[Cell] = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in ALL_SHAPES:
            skip = None
            if shape.name == "long_500k" and not cfg.is_subquadratic:
                skip = ("pure full attention: 500k-token context is "
                        "quadratic in prefill and impractical to serve; "
                        "runs only for ssm/hybrid archs")
            cells.append(Cell(arch, shape, skip))
    return cells


def runnable_cells() -> List[Cell]:
    return [c for c in cell_matrix() if c.skip is None]
