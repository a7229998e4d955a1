"""Elastic scaling: re-shard a training state onto another mesh (port of
``repro.runtime.elastic``).

The checkpoint format is mesh-agnostic (host arrays per leaf), so
elasticity is: load, then place against the new mesh's shardings
(``checkpoint.load_checkpoint(..., shardings=)``).  :func:`reshard_state`
is the in-memory path for a live resize: every leaf is gathered whole from
the ranks of its old mesh and placed on ``new_mesh`` as a DTensor by its
path-convention spec (``sharding.spec_for_path``; leaves no rule names,
such as scalars and steps, replicate), or as a plain tensor on the mesh's
device when ``new_mesh`` is lanes-only (one device).  Every rank calls it
with the same state.
"""
from __future__ import annotations

import torch

from repro_torch.sharding import place, sharding_for, whole
from repro_torch.treepath import keystr_simple, tree_map_with_path


def reshard_state(state, new_mesh, rules=None):
    """Re-shard every leaf of a TrainState/tree onto ``new_mesh``."""
    def put(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        full = whole(leaf)
        if not new_mesh.over_ranks:
            return full.to(new_mesh.device)
        return place(full, sharding_for(keystr_simple(path),
                                        tuple(full.shape), new_mesh, rules))
    return tree_map_with_path(put, state)
