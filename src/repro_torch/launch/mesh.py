"""Mesh construction (port of ``repro.launch.mesh``).

A port mesh (``core.distributed.SearchMesh``) puts its positions on one
device as lanes, or lays them over the ranks of a process group.
``make_production_mesh`` gives the reference's pod layouts: over the 256
or 512 ranks of a group when one is up (one rank a position: the dry
run's counting group, ``ranks.init_counting_ranks``), else as lanes of
one device.  ``make_host_mesh`` lays its mesh over the group's ranks when
one is up (``ranks.init_ranks``).
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch import ranks as rank_mod
from repro_torch.core.distributed import SearchMesh, make_search_mesh


def make_production_mesh(multi_pod: bool = False, device=None,
                         ranks: Optional[bool] = None) -> SearchMesh:
    """The reference's production mesh: (16, 16) ``("data", "model")``,
    or (2, 16, 16) ``("pod", "data", "model")`` with ``multi_pod``.

    ``ranks`` None lays it over the process group's ranks when one is up,
    one rank a position (the group must hold exactly 256 or 512 ranks:
    any other world size raises), and as lanes of ``device`` (default
    CUDA; ``"meta"`` for the dry run) when none is; True needs the group,
    False keeps the lanes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if ranks is None:
        ranks = rank_mod.is_up()
    if not ranks:
        return make_search_mesh(shape, axes, device=device)
    if rank_mod.world() != math.prod(shape):
        raise ValueError(f"the {'x'.join(map(str, shape))} production mesh "
                         f"lays one rank a position: {math.prod(shape)} "
                         f"ranks, not {rank_mod.world()}")
    return make_search_mesh(shape, axes, device=device, ranks=shape)


def rank_grid(data: int, model: int, world: int):
    """Ranks along (data, model) for a (data, model) mesh over ``world``
    ranks: as many on ``data`` as divide it, the rest on ``model``; None
    when they do not divide ``model``."""
    r_data = math.gcd(data, world)
    return None if model % (world // r_data) else (r_data, world // r_data)


def make_host_mesh(data: int = 1, model: int = 1,
                   device=None) -> SearchMesh:
    """A (data, model) mesh: with a process group up, over its ranks
    (:func:`rank_grid`; each rank's device), else as lanes of ``device``
    (default CUDA)."""
    if not rank_mod.is_up():
        return make_search_mesh((data, model), ("data", "model"),
                                device=device)
    grid = rank_grid(data, model, rank_mod.world())
    if grid is None:
        raise ValueError(f"a ({data}, {model}) mesh does not split over "
                         f"{rank_mod.world()} ranks")
    return make_search_mesh((data, model), ("data", "model"), device=device,
                            ranks=grid)
