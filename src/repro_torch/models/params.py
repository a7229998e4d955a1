"""A model's weights as the reference's parameter tree, and back.

Every port model is an ``nn.Module`` that holds its weights in the
reference's layout: nested dicts whose per-layer leaves are stacked on
leading axes (``layers/attn/wq`` is (L, d, H·hd); zamba2's ``grouped``
leaves are (G, E, ...)).  :func:`params_tree` reads that tree off a
module (a parameter or submodule a key), :func:`set_tree` writes one onto
it, :func:`unstack` unbinds stacked leaves into per-layer views once a
call, and :func:`draw_stacked` draws per-layer weights into stacked
leaves.  A model's ``stacked_axes`` maps each top-level key of its tree
to the number of stacked leading axes its leaves carry.
:class:`TreeModel` is what the models share: the config, the device and
``init``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.treepath import flatten_with_path, tree_map


class NoDraw:
    """The generator of a model on the meta device, where
    ``torch.Generator`` cannot be made: ``models.common.normal_init``
    returns ``torch.empty`` for it, and the leaves made on
    ``generator.device`` land on the meta device with the rest."""
    device = torch.device("meta")


NO_DRAW = NoDraw()


def frozen(t: torch.Tensor) -> nn.Parameter:
    # a module's weights serve and take no gradients: training
    # differentiates per-layer views of the tree (train/train_step.py)
    return nn.Parameter(t, requires_grad=False)


def params_tree(params) -> dict:
    """The reference's parameter tree of ``params``: a module's own
    tensors in nested dicts (each parameter and submodule under its name),
    or a tree as it is."""
    if not isinstance(params, nn.Module):
        return params
    tree = {k: v for k, v in params.named_parameters(recurse=False)}
    tree.update({k: params_tree(m) for k, m in params.named_children()})
    return tree


def set_tree(module: nn.Module, tree: dict, device) -> nn.Module:
    """Register ``tree`` on ``module``, moved to ``device``: each tensor a
    frozen parameter, each dict a submodule under its key.  Returns
    ``module``."""
    for k, v in tree.items():
        if isinstance(v, dict):
            setattr(module, k, set_tree(nn.Module(), v, device))
        else:
            setattr(module, k, frozen(v.to(device)))
    return module


def unstack(tree, depth: int = 1):
    """A tree whose leaves are stacked on ``depth`` leading axes as nested
    lists (``depth`` deep) of per-index trees of views; each leaf is
    unbound once a level."""
    if depth == 0:
        return tree
    split = {k: unstack(v, 1) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    n = len(next(iter(split.values())))
    return [unstack({k: s[i] for k, s in split.items()}, depth - 1)
            for i in range(n)]


def draw_stacked(n: int, draw: Callable[[], dict]) -> dict:
    """``n`` trees from ``draw()``, stacked on a new leading axis: tree
    ``i`` is drawn whole before tree ``i + 1`` and written into its row."""
    out = None
    for i in range(n):
        one = draw()
        if out is None:
            out = tree_map(lambda t: t.new_empty((n, *t.shape)), one)
        for (_, dst), (_, src) in zip(flatten_with_path(out),
                                      flatten_with_path(one)):
            dst[i] = src
        del one, dst, src            # free row i's draw before row i + 1's
    return out


def check_stacked(tree: dict, axes: dict, shape: dict) -> None:
    """Raise unless every leaf under top-level key ``k`` of ``tree`` leads
    with ``shape[k]`` (its ``axes[k]`` stacked axes)."""
    for k, depth in axes.items():
        for path, t in flatten_with_path(tree[k]):
            if tuple(t.shape[:depth]) != tuple(shape[k]):
                name = "/".join(map(str, (k,) + path))
                raise ValueError(f"{name}: leading axes "
                                 f"{tuple(t.shape[:depth])}, the config's "
                                 f"layout has {tuple(shape[k])}")


def layer_list(tree: dict, key: str, depth: int = 1) -> list:
    """``tree[key]`` as per-layer trees: a list as it is (training's
    gradient views), else its stacked leaves unbound once."""
    part = tree[key]
    return part if isinstance(part, list) else unstack(part, depth)


class TreeModel(nn.Module):
    """A model of ``cfg`` on ``device`` (default CUDA) that holds the
    reference's tree.  Construction allocates no weights: :meth:`init`
    draws them (a subclass's ``init_tree``), or
    ``models.convert.params_from_jax`` loads the reference's (its
    ``set_params``)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self._device = resolve_device(device)

    @property
    def device(self) -> torch.device:
        """Where the weights are (after ``init``, ``set_params`` or
        ``.to``), else where the constructor put the model."""
        if "embedding" in self._parameters:
            return self.embedding.device
        return self._device

    def init(self, generator: Optional[torch.Generator] = None):
        """Draw every weight from ``generator`` (on the model's device) and
        return the module: the ``params`` of the other methods.  A model on
        the meta device takes no generator and draws nothing."""
        return self.set_params(self.init_tree(generator))

    def check_generator(self, generator: Optional[torch.Generator]):
        """The generator ``init_tree`` draws from: ``generator``, on the
        model's device type; for a model on the meta device,
        :data:`NO_DRAW` (every leaf ``torch.empty``, as
        ``jax.eval_shape`` of the reference's init gives shapes only)."""
        if self.device.type == "meta" and generator is None:
            return NO_DRAW
        if generator is None or generator.device.type != self.device.type:
            raise ValueError(f"generator on "
                             f"{getattr(generator, 'device', None)}, model "
                             f"on {self.device}")
        return generator
