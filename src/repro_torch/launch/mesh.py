"""Mesh construction (port of ``repro.launch.mesh``'s ``make_host_mesh``).

The reference's ``make_production_mesh`` lays out a TPU pod (16 × 16 or
2 × 16 × 16 chips); a mesh over several cards is not ported (ROADMAP.md
§1 item 8).
"""
from __future__ import annotations

from repro_torch.core.distributed import SearchMesh, make_search_mesh


def make_host_mesh(data: int = 1, model: int = 1,
                   device=None) -> SearchMesh:
    """A (data, model) mesh whose positions are lanes of ``device``
    (default CUDA)."""
    return make_search_mesh((data, model), ("data", "model"), device=device)
