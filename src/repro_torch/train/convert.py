"""A ``TrainState`` carried between the reference and the port.

Both packages hold the state as the reference's tree (params, optimizer
state, int8 residuals), leaf for leaf, so the converters map each leaf:
``state_from_jax(jax.tree.map(np.asarray, state))`` seeds the port from a
``repro`` state, and ``repro.train.train_step.TrainState(
*state_to_jax(state))`` the reference from a port one.
"""
from __future__ import annotations

from repro_torch.models.convert import tree_from_jax, tree_to_jax
from repro_torch.train.train_step import TrainState


def state_from_jax(state, device=None) -> TrainState:
    """A port ``TrainState`` on ``device`` (default CUDA) of the
    reference's one as numpy."""
    return TrainState(*(tree_from_jax(t, device) for t in
                        (state.params, state.opt, state.err)))


def state_to_jax(state) -> TrainState:
    """A port ``TrainState`` whose leaves are numpy arrays."""
    return TrainState(*(tree_to_jax(t) for t in state))
