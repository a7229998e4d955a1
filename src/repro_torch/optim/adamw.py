"""Optimizers: AdamW (dtype-configurable moments) and Adafactor (factored
second moments).  Port of ``repro.optim.adamw``.

Functional and tree-based, on the reference's parameter tree: per-layer
weights are leaves stacked on a leading ``layers`` axis, and the rules
read those stacked shapes.  A leaf of two or more dimensions is decayed
(so the stacked (L, d) norm scales and QKV biases are, and the (d,)
``final_norm`` is not); Adafactor factors such a leaf over its last two
axes, and its update clipping takes the RMS over the whole stacked leaf.

Each update takes ``inplace``: the reference's result is written into
``state``'s moments and added to ``params`` leaf by leaf, for a train
step that owns them (at 3B parameters a second copy of the parameters
and moments does not fit one card).  AdamW's arithmetic is elementwise,
so it runs over row slices of each leaf there, to bound the temporaries;
every element is computed as the functional update computes it.  On
DTensor leaves (placed alike: gradients, moments and parameters) it runs
on each rank's local blocks, which is exact and sends nothing.
"""
from __future__ import annotations

import torch

from repro_torch.config import TrainConfig
from repro_torch.models.common import _torch_dtype
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.sharding import is_dtensor
from repro_torch.treepath import tree_leaves, tree_map, tree_unzip

_SLICE_ELEMS = 1 << 25       # elements an in-place AdamW slice holds


def _apply_inplace(upd, grads, moments, params, row_slices: bool) -> None:
    """Run ``upd(g, *moments, p) -> (update, *new moments)`` leaf by leaf
    (over row slices of about _SLICE_ELEMS elements when ``row_slices``),
    writing each new moment into its old tensor and adding the update to
    the parameter."""
    for g, *ms, p in zip(tree_leaves(grads),
                         *(tree_leaves(m) for m in moments),
                         tree_leaves(params)):
        if is_dtensor(p):       # elementwise: each rank its own blocks
            if not row_slices or any(t.placements != p.placements
                                     for t in (g, *ms)):
                raise ValueError(
                    "over ranks the update runs on each rank's blocks: "
                    "AdamW (Adafactor's clipping reads whole leaves), its "
                    "gradients and moments placed as their parameters")
            g, ms, p = g.to_local(), [m.to_local() for m in ms], p.to_local()
        slices = [slice(None)]
        if row_slices and p.dim():
            rows = max(1, _SLICE_ELEMS // max(1, p[0].numel()))
            slices = [slice(lo, lo + rows)
                      for lo in range(0, p.shape[0], rows)]
        for sl in slices:
            u, *new = upd(g[sl], *(m[sl] for m in ms), p[sl])
            for m, v in zip(ms, new):
                m[sl].copy_(v)
            p[sl].add_(u)


def adamw_init(params, tcfg: TrainConfig) -> dict:
    mdt = _torch_dtype(tcfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    return {"step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def adamw_update(grads, state: dict, params, tcfg: TrainConfig,
                 inplace: bool = False):
    """(updates, new state); with ``inplace``, (None, state) after adding
    the updates to ``params`` and writing the moments into ``state``'s."""
    step = state["step"] + 1
    lr = warmup_cosine(step, tcfg.learning_rate, tcfg.warmup_steps,
                       tcfg.total_steps)
    b1, b2, eps = tcfg.beta1, tcfg.beta2, tcfg.eps
    mdt = _torch_dtype(tcfg.moment_dtype)
    c1 = 1 - b1 ** step.float()
    c2 = 1 - b2 ** step.float()
    if inplace and is_dtensor(lr):     # the update runs on local blocks
        lr, c1, c2 = lr.to_local(), c1.to_local(), c2.to_local()

    def upd(g, m, v, p):
        gf = g.float()
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * gf * gf
        delta = (mf / c1) / (torch.sqrt(vf / c2) + eps)
        if p.dim() >= 2:   # decoupled weight decay on matrices only
            delta = delta + tcfg.weight_decay * p.float()
        return (-lr * delta).to(p.dtype), mf.to(mdt), vf.to(mdt)

    if inplace:
        _apply_inplace(upd, grads, (state["m"], state["v"]), params, True)
        return None, {"step": step, "m": state["m"], "v": state["v"]}
    updates, m, v = tree_unzip(upd, 3, grads, state["m"], state["v"],
                               params)
    return updates, {"step": step, "m": m, "v": v}


# ---------------------------------------------------------------------------
# Adafactor (factored second moments)
# ---------------------------------------------------------------------------

def adafactor_init(params, tcfg: TrainConfig) -> dict:
    f32 = dict(dtype=torch.float32)

    def rows(p):
        return torch.zeros(p.shape[:-1] if p.dim() >= 2 else p.shape, **f32,
                           device=p.device)

    def cols(p):
        return torch.zeros(p.shape[:-2] + p.shape[-1:] if p.dim() >= 2
                           else (1,), **f32, device=p.device)

    return {"step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device),
            "vr": tree_map(rows, params), "vc": tree_map(cols, params)}


def adafactor_update(grads, state: dict, params, tcfg: TrainConfig,
                     inplace: bool = False):
    """(updates, new state); ``inplace`` as for :func:`adamw_update` (whole
    leaves: the update clipping reduces over each)."""
    step = state["step"] + 1
    lr = warmup_cosine(step, tcfg.learning_rate, tcfg.warmup_steps,
                       tcfg.total_steps)
    b2 = 1.0 - step.float() ** -0.8
    eps = 1e-30

    def upd(g, vr, vc, p):
        gf = g.float()
        g2 = gf * gf + eps
        if p.dim() >= 2:
            nvr = b2 * vr + (1 - b2) * torch.mean(g2, dim=-1)
            nvc = b2 * vc + (1 - b2) * torch.mean(g2, dim=-2)
            r = nvr / torch.clamp(torch.mean(nvr, dim=-1, keepdim=True),
                                  min=eps)
            denom = torch.sqrt(r[..., None] * nvc[..., None, :])
        else:
            nvr = b2 * vr + (1 - b2) * g2
            nvc = vc
            denom = torch.sqrt(nvr)
        delta = gf / torch.clamp(denom, min=1e-12)
        # update clipping (Shazeer & Stern): RMS(delta) <= 1
        rms = torch.sqrt(torch.mean(delta * delta) + 1e-12)
        delta = delta / torch.clamp(rms, min=1.0)
        if p.dim() >= 2:
            delta = delta + tcfg.weight_decay * p.float()
        return (-lr * delta).to(p.dtype), nvr, nvc

    if inplace:
        _apply_inplace(upd, grads, (state["vr"], state["vc"]), params, False)
        return None, {"step": step, "vr": state["vr"], "vc": state["vc"]}
    updates, vr, vc = tree_unzip(upd, 3, grads, state["vr"], state["vc"],
                                 params)
    return updates, {"step": step, "vr": vr, "vc": vc}


def make_optimizer(tcfg: TrainConfig):
    if tcfg.optimizer == "adamw":
        return adamw_init, adamw_update
    if tcfg.optimizer == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(tcfg.optimizer)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
