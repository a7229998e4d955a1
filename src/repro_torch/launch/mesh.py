"""Mesh construction (port of ``repro.launch.mesh``).

Every position of a port mesh sits on one device
(``core.distributed.SearchMesh``).  ``make_production_mesh`` gives the
reference's pod layouts as lanes of one device, which is what the dry run
(``launch.dryrun``) divides a cell's bytes by on the meta device; placing
them over several cards is ROADMAP.md §1 item 8.
"""
from __future__ import annotations

from repro_torch.core.distributed import SearchMesh, make_search_mesh


def make_production_mesh(multi_pod: bool = False,
                         device=None) -> SearchMesh:
    """The reference's production mesh: (16, 16) ``("data", "model")``,
    or (2, 16, 16) ``("pod", "data", "model")`` with ``multi_pod``, as
    lanes of ``device`` (default CUDA; ``"meta"`` for the dry run).  A
    mesh of 256 or 512 cards is ROADMAP.md §1 item 8."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_search_mesh(shape, axes, device=device)


def make_host_mesh(data: int = 1, model: int = 1,
                   device=None) -> SearchMesh:
    """A (data, model) mesh whose positions are lanes of ``device``
    (default CUDA)."""
    return make_search_mesh((data, model), ("data", "model"), device=device)
