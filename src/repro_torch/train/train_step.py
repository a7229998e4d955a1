"""The training step: loss -> grads -> clip -> optimizer update.  Port of
``repro.train.train_step``.

The state is the reference's: ``params`` is the reference's parameter tree
(per-layer weights stacked on leading axes, the layout a model holds;
``models.params.params_tree``), so optimizer state, gradients and
checkpoints carry the reference's names and shapes.  Gradients are taken
by one ``backward`` through per-layer views of the stacked leaves (the
model's ``stacked_axes`` say which); each view's gradient is added into
the step's stacked gradient buffer as soon as autograd finishes it, so a
step holds one gradient tree.  With ``microbatches`` > 1 each microbatch's gradient is
added into that buffer (float32) and the sum divided by their count, the
reference's order.

A step updates the state it is given in place: the update is added into
``params`` and the moments are written over (at 3B parameters a second
copy of them does not fit one card), and the state it returns shares
those tensors.  A caller that branches several steps from one state
clones it first.  The values are the reference's functional step's.

``make_compressed_dp_train_step`` is the reference's explicit-DP step with
the ``data`` axis's positions as lanes of one device: each lane takes its
rows of the batch, its gradient goes through ``compressed_psum``, and
``err`` keeps each lane's residual, (data, ...) per leaf (the reference
keeps one per device).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.config import TrainConfig
from repro_torch.core.distributed import SearchMesh, check_mesh_device
from repro_torch.models.params import unstack
from repro_torch.optim import clip_by_global_norm, make_optimizer
from repro_torch.optim.grad import compressed_psum
from repro_torch.treepath import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: dict
    opt: dict
    # int8 error-feedback residuals (only allocated when compression is on)
    err: Optional[dict]


# which axis of each batch entry is the batch dimension (default 0);
# M-RoPE position ids are (3, B, S)
BATCH_AXIS = {"positions": 1}


def _mb_split(x: torch.Tensor, m: int, axis: int) -> torch.Tensor:
    """Split ``axis`` into (m, axis//m) and move the microbatch dim front:
    microbatch i is the i-th contiguous chunk of rows (a view)."""
    return torch.movedim(x.unflatten(axis, (m, x.shape[axis] // m)), axis, 0)


def init_train_state(model, generator: torch.Generator,
                     tcfg: TrainConfig) -> TrainState:
    """The weights ``model.init`` would draw from ``generator`` (as the
    reference's tree, held by no module), with fresh optimizer state (and
    zero residuals under int8 compression)."""
    params = model.init_tree(generator)
    opt_init, _ = make_optimizer(tcfg)
    err = None
    if tcfg.grad_compression == "int8":
        err = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
    return TrainState(params=params, opt=opt_init(params, tcfg), err=err)


def _grad_leaf(t: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """A leaf on ``t``'s storage whose gradient is added into ``acc``."""
    x = t.detach().requires_grad_(True)

    def drain(x):
        acc.add_(x.grad)
        x.grad = None
    x.register_post_accumulate_grad_hook(drain)
    return x


def _grad_views(t, a, depth: int):
    """``t`` (a tree of leaves stacked on ``depth`` leading axes) as the
    per-layer trees ``unstack`` gives, each leaf a :func:`_grad_leaf` of
    its slot in ``a``."""
    if depth == 0:
        return tree_map(_grad_leaf, t, a)
    return [_grad_views(ti, ai, depth - 1)
            for ti, ai in zip(unstack(t), unstack(a))]


def loss_and_grad(model, params, batch, remat: bool, acc) -> torch.Tensor:
    """``model.loss(params, batch)``, its gradient added into ``acc`` (a
    tree like ``params``).  Returns the loss (no graph)."""
    view = {k: _grad_views(params[k], acc[k], model.stacked_axes.get(k, 0))
            for k in params}
    with torch.enable_grad():
        loss = model.loss(view, batch, remat=remat)
        loss.backward()
    return loss.detach()


def _zeros(params, dtype=None, lanes: int = 0):
    return tree_map(lambda p: torch.zeros(
        ((lanes,) if lanes else ()) + tuple(p.shape),
        dtype=dtype or p.dtype, device=p.device), params)


def make_train_step(model, tcfg: TrainConfig):
    """``train_step(state, batch) -> (state, metrics)``, updating
    ``state`` in place; ``batch`` holds tensors on the parameters'
    device."""
    _, opt_update = make_optimizer(tcfg)
    remat = tcfg.remat != "none"
    m = tcfg.microbatches

    def train_step(state: TrainState, batch):
        if m > 1:
            grads = _zeros(state.params, torch.float32)
            mbs = {k: _mb_split(v, m, BATCH_AXIS.get(k, 0))
                   for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(m):
                loss = loss + loss_and_grad(
                    model, state.params, {k: v[i] for k, v in mbs.items()},
                    remat, grads)
            loss = loss / m
            for g in tree_leaves(grads):
                g.div_(m)
        else:
            grads = _zeros(state.params)
            loss = loss_and_grad(model, state.params, batch, remat, grads)

        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip,
                                           inplace=True)
        _, opt = opt_update(grads, state.opt, state.params, tcfg,
                            inplace=True)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "step": opt["step"].float()}
        return TrainState(state.params, opt, state.err), metrics

    return train_step


def make_compressed_dp_train_step(model, tcfg: TrainConfig, mesh: SearchMesh,
                                  data_axis: str = "data"):
    """Explicit-DP train step with int8 gradient all-reduce + error
    feedback, the ``data_axis`` positions of ``mesh`` as lanes of the
    parameters' device, updating ``state`` in place.  The state needs
    residuals (``grad_compression="int8"``); the batch must split evenly
    over the lanes."""
    _, opt_update = make_optimizer(tcfg)
    remat = tcfg.remat != "none"
    n = mesh.axis_size(data_axis)

    def train_step(state: TrainState, batch):
        check_mesh_device(mesh, tree_leaves(state.params)[0].device)
        if state.err is None:
            raise ValueError("the compressed step keeps int8 residuals: "
                             "init the state with grad_compression='int8'")
        lanes = {k: _mb_split(v, n, BATCH_AXIS.get(k, 0))
                 for k, v in batch.items()}
        grads = _zeros(state.params, lanes=n)
        losses = [loss_and_grad(model, state.params,
                                {k: v[i] for k, v in lanes.items()}, remat,
                                tree_map(lambda g, i=i: g[i], grads))
                  for i in range(n)]
        mean_grads, new_err = compressed_psum(grads, state.err)
        del grads
        mean_grads, gnorm = clip_by_global_norm(mean_grads, tcfg.grad_clip,
                                                inplace=True)
        _, opt = opt_update(mean_grads, state.opt, state.params, tcfg,
                            inplace=True)
        loss = torch.stack(losses).sum() / n
        return (TrainState(state.params, opt, new_err),
                {"loss": loss, "grad_norm": gnorm})

    return train_step
