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
the ``data`` axis's positions as lanes: each lane takes its rows of the
batch, its gradient goes through ``compressed_psum``, and ``err`` keeps
each lane's residual, (n, ...) per leaf for the axis's n positions (the
reference keeps one per device).  On a mesh over ranks every rank is given
the whole batch, takes its block of rows and keeps its own lanes' residual
rows, as a DTensor of the whole (n, ...) array split over the ``data``
ranks, so a checkpoint gathers every rank's rows in lane order; the
parameters stay replicated and come out of the step bit-identical on every
rank, and bit for bit the lanes-only step's.  Inside the step an active
mesh over ranks is read as lanes of the rank's device, so that a moe
layer under ``set_moe_impl("a2a")`` splits each lane's own rows as the
lanes-only step does.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from repro_torch.config import TrainConfig
from repro_torch.core.distributed import SearchMesh, check_mesh_device
from repro_torch.models.params import unstack
from repro_torch.optim import clip_by_global_norm, make_optimizer
from repro_torch.optim.grad import compressed_psum
from repro_torch.sharding import (current_mesh, is_dtensor, like, use_mesh,
                                  whole)
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


def microbatch_rows(batch: int, data: int, m: int) -> list:
    """The global rows of the ``m`` microbatches of a batch of ``batch``
    rows split over ``data`` ranks (:func:`_microbatches`), in order:
    microbatch i holds, of rank r's rows [r·B/n, (r+1)·B/n), the i-th
    contiguous chunk of B/(n·m), so rows r·B/n + i·B/(n·m) + j for every
    r.  A one-device step over the rows in this order has the same
    microbatches."""
    per = batch // data
    return [r * per + i * (per // m) + j for i in range(m)
            for r in range(data) for j in range(per // m)]


def _microbatches(x: torch.Tensor, m: int, axis: int):
    """The ``m`` microbatches of ``x`` along ``axis``: :func:`_mb_split`'s
    contiguous chunks.  A DTensor whose ``axis`` is sharded over ranks
    splits each rank's own rows instead (nothing is sent): the global rows
    of :func:`microbatch_rows`."""
    if not is_dtensor(x):
        return _mb_split(x, m, axis)
    local = x.to_local()
    if local.shape[axis] % m:
        raise ValueError(f"a rank's {local.shape[axis]} rows do not split "
                         f"into {m} microbatches")
    return [like(part, x) for part in _mb_split(local, m, axis)]


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
    """Zeros like each leaf (with ``lanes`` leading rows); a DTensor
    leaf's are placed as it is."""
    def one(p):
        if lanes:
            return torch.zeros((lanes,) + tuple(p.shape),
                               dtype=dtype or p.dtype, device=p.device)
        return torch.zeros_like(p, dtype=dtype or p.dtype)
    return tree_map(one, params)


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
            mbs = {k: _microbatches(v, m, BATCH_AXIS.get(k, 0))
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


@contextlib.contextmanager
def _own_rows():
    """The active mesh, when it is laid over ranks, as lanes of this rank's
    device inside the block.  A layer that splits over the active mesh
    (``moe_a2a.moe_ffn_whole`` under ``set_moe_impl("a2a")``) over ranks
    takes the same whole activations on every rank, while the compressed
    step gives each rank its own rows: as lanes, each lane's rows split
    over the mesh's positions on this rank alone, as they do in the
    lanes-only step, so the two steps stay equal bit for bit."""
    mesh = current_mesh()
    if mesh is not None and mesh.over_ranks:
        mesh = SearchMesh(mesh.axis_names, mesh.axis_sizes, mesh.device)
    with use_mesh(mesh):
        yield


def make_compressed_dp_train_step(model, tcfg: TrainConfig, mesh: SearchMesh,
                                  data_axis: str = "data"):
    """Explicit-DP train step with int8 gradient all-reduce + error
    feedback over the ``data_axis`` positions of ``mesh`` (lanes of the
    parameters' device, laid over ranks when the mesh is), updating
    ``state`` in place.  The state needs residuals
    (``grad_compression="int8"``); the batch must split evenly over the
    positions.  The loss is the lanes' losses gathered in lane order and
    summed, over their count.

    ``state.err`` holds, per leaf, one residual for every lane (a fresh
    state), the whole (n, ...) array (a checkpoint: each rank takes its
    block of rows), or, over ranks, the DTensor the step returned; any
    other shape raises."""
    _, opt_update = make_optimizer(tcfg)
    remat = tcfg.remat != "none"
    n, lanes = mesh.axis_size(data_axis), mesh.lanes(data_axis)
    axis = mesh.axis(data_axis)
    lo = mesh.coord(data_axis) * lanes
    placements = None
    if axis is not None:
        from torch.distributed.tensor import Replicate, Shard
        placements = tuple(Shard(0) if a == data_axis else Replicate()
                           for a in mesh.axis_names)

    def rows(e, p):
        """This rank's lanes' residual rows of ``e`` (or ``e`` itself, one
        residual broadcast to every lane)."""
        if placements is not None and getattr(e, "placements", None) == \
                placements and e.device_mesh == mesh.device_mesh:
            e = e.to_local()
            ok = e.shape == (lanes,) + p.shape
        else:
            e = whole(e)
            ok = e.shape in (p.shape, (n,) + p.shape)
            if e.shape == (n,) + p.shape:
                e = e[lo:lo + lanes]
        if not ok:
            raise ValueError(
                f"a residual of shape {tuple(e.shape)} fits neither its "
                f"parameter {tuple(p.shape)} nor the {n} positions of the "
                f"{data_axis!r} axis")
        return e

    def spread(e):
        """This rank's rows as the whole array split over the data ranks."""
        if placements is None:
            return e
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(e, mesh.device_mesh, placements,
                                  run_check=False)

    def block(k, v):
        ax = BATCH_AXIS.get(k, 0)
        if axis is not None:        # this rank's rows
            v = _mb_split(v, axis.size, ax)[axis.coord]
        return _mb_split(v, lanes, ax)

    def train_step(state: TrainState, batch):
        check_mesh_device(mesh, tree_leaves(state.params)[0].device)
        if state.err is None:
            raise ValueError("the compressed step keeps int8 residuals: "
                             "init the state with grad_compression='int8'")
        split = {k: block(k, v) for k, v in batch.items()}
        grads = _zeros(state.params, lanes=lanes)
        with _own_rows():
            losses = torch.stack([
                loss_and_grad(model, state.params,
                              {k: v[i] for k, v in split.items()}, remat,
                              tree_map(lambda g, i=i: g[i], grads))
                for i in range(lanes)])
        mean_grads, new_err = compressed_psum(
            grads, tree_map(rows, state.err, state.params), axis)
        del grads
        mean_grads, gnorm = clip_by_global_norm(mean_grads, tcfg.grad_clip,
                                                inplace=True)
        _, opt = opt_update(mean_grads, state.opt, state.params, tcfg,
                            inplace=True)
        if axis is not None:
            losses = axis.gather(losses, 0)
        return (TrainState(state.params, opt, tree_map(spread, new_err)),
                {"loss": losses.sum() / n, "grad_norm": gnorm})

    return train_step
