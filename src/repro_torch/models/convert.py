"""The reference's parameters in the port, and back.

``repro``'s models' ``init`` returns a nested dict whose per-layer leaves
carry leading stacked axes (for ``lax.scan``: ``layers``, or zamba2's
``grouped`` and ``tail``); a port model holds its weights in the same
layout (``models.params``).  Given that tree as numpy arrays
(``jax.tree.map(np.asarray, params)``), :func:`params_from_jax` builds a
port model that holds the same weights, so both packages compute with
them; :func:`params_to_jax` gives a port model's (or tree's) weights back
as that tree.  Weights keep their (in, out) orientation: both packages
multiply ``x @ W``, so nothing is transposed.  bfloat16 leaves come back
as ``ml_dtypes`` arrays, which JAX reads (the JAX side has ``ml_dtypes``).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.models.params import params_tree
from repro_torch.npio import from_numpy
from repro_torch.treepath import tree_map


def tree_to_jax(tree):
    """A tree of tensors as numpy arrays (bfloat16 as ``ml_dtypes``)."""
    def one(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes  # the JAX side's dependency, not the port's
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return tree_map(one, tree)


def tree_from_jax(tree, device=None):
    """A tree of numpy arrays as tensors on ``device`` (default CUDA) that
    share no memory with the arrays."""
    dev = resolve_device(device)
    return tree_map(lambda a: from_numpy(np.array(a, copy=True)).to(dev),
                    tree)


def params_from_jax(tree: Mapping, cfg: ModelConfig, device=None):
    """A port model of ``cfg`` on ``device`` (default CUDA) holding the
    weights of the reference's parameter tree ``tree`` (numpy leaves).
    Returns the model, which is the ``params`` its methods take."""
    return build_model(cfg, device=device).set_params(
        tree_from_jax(tree, device))


def params_to_jax(params) -> dict:
    """The reference's numpy parameter tree of a port model (or of a tree
    in its layout)."""
    return tree_to_jax(params_tree(params))
