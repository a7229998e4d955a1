"""Expert-parallel MoE over a mesh's positions.  Port of
``repro.models.moe_a2a``.

The reference runs two ``shard_map`` bodies, chosen by whether the
``model`` axis size divides the number of experts:

* **a2a path**: tokens are split over every mesh position; each position
  buckets its tokens by destination (the position holding the expert),
  exchanges them with ``all_to_all`` over ``model``, regroups them per
  local expert, runs the FFN, exchanges the results back and combines
  them locally.
* **tp path**: tokens are split over the data axes and replicated over
  ``model``; each ``model`` position holds an f-slice of every expert
  and the down-projection's partial sums are ``psum``-ed over ``model``.

The port's mesh (:class:`~repro_torch.core.distributed.SearchMesh`) holds
its positions as *lanes* of this rank's device: all of them on a
lanes-only mesh, S / r of an axis of size S laid over r ranks otherwise.
A body runs over this rank's lanes one lane at a time for everything that
computes (routing, bucketing, each lane's expert products, the combine:
the reference's body as it is), and each collective of the reference is
an operation over the lanes, followed on a mesh over ranks by a
collective over the ranks of its axis (``ranks.RankAxis``):

* ``all_to_all`` over ``model``: a transpose of the (source, destination)
  lanes of this rank, and an ``all_to_all`` over the ``model`` ranks of
  the blocks bound for other ranks' lanes, in slot order;
* ``pmean`` over the token axes: each lane's ``me`` and ``ce`` gathered
  in lane order, then the mean over all lanes;
* ``psum`` over ``model``: the ``model`` lanes' partial sums gathered in
  lane order and added in that order;
* ``_gather_fsdp``: a leaf that is a DTensor placed by
  ``sharding.param_shardings`` is all-gathered over its data ranks; a
  whole tensor is read as it is (each rank takes its experts or
  f-slices).

A value that several lanes use (the router; each weight block, used by
every data lane; the tp path's dispatch buffers, used by every ``model``
lane) reaches each lane through a fan-out whose backward gathers the
lanes' gradients over the ranks and adds them in lane order.  So every
sum across lanes runs in one order, whatever the split over ranks, and
each lane's products have the same shapes: over ranks the outputs, the
aux loss and the gradients are the lanes path's bit for bit.  The
backward of the ``all_to_all`` is the reverse ``all_to_all``, that of a
gather this rank's own slice (what follows a gather is the same on every
rank of its axis), that of the FSDP gather the gradient's own block
(summed over the data lanes by the fan-out): no float ``all_reduce``.

Over ranks, :func:`moe_ffn_sharded` takes this rank's block of the tokens
and returns that block; :func:`moe_ffn_whole` (the transformer's MoE layer
under ``set_moe_impl("a2a")``) takes the whole ``x`` that every rank
holds, runs its block and gathers the blocks back.  Capacities come from
the tokens of one position, the same on every rank.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.distributed import check_mesh_device
from repro_torch.models import moe as moe_mod
from repro_torch.models.moe import (combine, dispatch, one_hot, rank_within,
                                    route, swiglu_experts)
from repro_torch.ranks import RankAxis
from repro_torch.sharding import (_active_mesh, is_dtensor, like,
                                  replicated, shard)

# set by set_moe_impl to route the transformer's MoE layers through
# moe_ffn_whole
_IMPL = {"mode": "gspmd"}   # "gspmd" | "a2a"

# (this axis's ranks or None on a lanes-only mesh, its lanes on this rank)
Lanes = Tuple[Optional[RankAxis], int]


def set_moe_impl(mode: str):
    _IMPL["mode"] = mode


def moe_impl() -> str:
    return _IMPL["mode"]


# ---------------------------------------------------------------------------
# Collectives over lanes and ranks
# ---------------------------------------------------------------------------

def _gather_lanes(t: torch.Tensor, axes: Tuple[Lanes, ...]) -> torch.Tensor:
    """(l_1 ⋯ l_n, ...) -> (S_1 ⋯ S_n, ...): this rank's lanes of each
    axis (row-major along dim 0) joined with every rank's, in global lane
    order."""
    if all(a is None for a, _ in axes):
        return t
    x = t.reshape(*(n for _, n in axes), *t.shape[1:])
    for i, (a, _) in enumerate(axes):
        if a is not None:
            x = a.gather(x, i)
    return x.reshape(-1, *t.shape[1:])


def _own_lanes(t: torch.Tensor, axes: Tuple[Lanes, ...]) -> torch.Tensor:
    """(S_1 ⋯ S_n, ...) -> (l_1 ⋯ l_n, ...): this rank's lanes."""
    if all(a is None for a, _ in axes):
        return t
    x = t.reshape(*(n * (a.size if a is not None else 1) for a, n in axes),
                  *t.shape[1:])
    for i, (a, n) in enumerate(axes):
        if a is not None:
            x = x.narrow(i, a.coord * n, n)
    return x.reshape(-1, *t.shape[1:])


class _Gather(torch.autograd.Function):
    """Forward :func:`_gather_lanes`; backward this rank's own lanes."""

    @staticmethod
    def forward(ctx, t, axes):
        ctx.axes = axes
        return _gather_lanes(t, axes)

    @staticmethod
    def backward(ctx, g):
        return _own_lanes(g, ctx.axes).contiguous(), None


class _Scatter(torch.autograd.Function):
    """Forward :func:`_own_lanes`; backward :func:`_gather_lanes`."""

    @staticmethod
    def forward(ctx, t, axes):
        ctx.axes = axes
        return _own_lanes(t, axes).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_lanes(g, ctx.axes), None


def _ranked(axes: Tuple[Lanes, ...]) -> bool:
    return any(a is not None for a, _ in axes)


def gather(t: torch.Tensor, axes: Tuple[Lanes, ...]) -> torch.Tensor:
    return _Gather.apply(t, axes) if _ranked(axes) else t


def lane_sum(t) -> torch.Tensor:
    """The sum over dim 0 of a tensor (or of a sequence of tensors),
    added in order, one at a time."""
    acc = t[0]
    for i in range(1, len(t)):
        acc = acc + t[i]
    return acc


def _exchange(t: torch.Tensor, axis: Optional[RankAxis]) -> torch.Tensor:
    """(G, w source lanes, M destinations, ...) -> (G, w destination
    lanes, M sources, ...): the reference's ``all_to_all`` over ``model``
    for every lane of this rank (M = w × the axis's ranks)."""
    g, w = t.shape[:2]
    r = 1 if axis is None else axis.size
    rest = t.shape[3:]
    # (destination rank, G, source lane, destination lane, ...)
    x = t.reshape(g, w, r, w, *rest).movedim(2, 0)
    if axis is not None:
        x = axis.all_to_all(x)          # dim 0 now the source rank
    x = x.permute(1, 3, 0, 2, *range(4, x.dim()))
    return x.reshape(g, w, r * w, *rest)


class _Exchange(torch.autograd.Function):
    """:func:`_exchange`; its backward is the reverse exchange, which is
    the same operation."""

    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return _exchange(t, axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.axis), None


class _Spread(torch.autograd.Function):
    """``n`` uses of a tensor, one per lane of ``lanes`` on this rank
    (row-major over those axes): the local part, gathered over each (axis,
    dim) of ``gathers`` and cut by the ``model`` coordinate along
    ``cut[1]`` when ``cut`` is given.  The backward adds the lanes'
    gradients in lane order and takes the sum back to the local part: over
    a lane axis that a gather also runs over, each rank receives only its
    own chunk of every lane's gradient (an ``all_to_all``: the reference's
    reduce-scatter), over the other lane axes every lane's gradient; a cut
    is gathered back over ``model``; a gathered dim gives back this rank's
    chunk."""

    @staticmethod
    def forward(ctx, local, lanes, gathers, cut):
        ctx.lanes, ctx.gathers, ctx.cut = lanes, gathers, cut
        x = local
        for axis, dim in gathers:
            x = axis.gather(x, dim)
        if cut is not None:
            axis, dim = cut
            m = x.shape[dim] // axis.size
            x = x.narrow(dim, axis.coord * m, m).contiguous()
        return tuple(x.view_as(x) for _ in range(
            math.prod(n for _, n in lanes)))

    @staticmethod
    def backward(ctx, *grads):
        k = len(ctx.lanes)
        scattered = set()
        if all(a is None or a.size == 1 for a, _ in ctx.lanes):
            # every lane on this rank: added one at a time, no stacked copy
            g = lane_sum(grads)
        else:
            g = torch.stack(grads)
            g = g.reshape(*(n for _, n in ctx.lanes), *g.shape[1:])
            for i, (axis, _) in enumerate(ctx.lanes):
                if axis is None or axis.size == 1:
                    continue
                dims = [d for a, d in ctx.gathers if a == axis]
                if not dims:
                    g = axis.gather(g, i)
                    continue
                # this rank's chunk of each lane's gradient, from every rank
                d = k + dims[0]
                g = axis.all_to_all(g.unflatten(d, (axis.size, -1))
                                    .movedim(d, 0))
                g = g.movedim(0, i).flatten(i, i + 1)
                scattered.add((axis, dims[0]))
            g = lane_sum(g.reshape(-1, *g.shape[k:]))
        if ctx.cut is not None:
            axis, dim = ctx.cut
            g = axis.gather(g, dim)
        for axis, dim in reversed(ctx.gathers):
            if (axis, dim) not in scattered:
                m = g.shape[dim] // axis.size
                g = g.narrow(dim, axis.coord * m, m)
        return g.contiguous(), None, None, None


def fan_out(t: torch.Tensor, lanes: Tuple[Lanes, ...]):
    """One use of ``t`` a lane of ``lanes`` (see :class:`_Spread`)."""
    return _Spread.apply(t, lanes, (), None)


def _gather_fsdp(w, mesh, block_dim: Optional[int],
                 lanes: Tuple[Lanes, ...]):
    """The reference's ``_gather_fsdp``, with the weight's fan-out to
    ``lanes``: one use a lane of ``w``'s block for this rank's ``model``
    lanes along ``block_dim`` (all of ``w`` for None), whole along its
    other dims.  A DTensor placed by ``sharding.param_shardings`` is
    all-gathered over the ranks of each mesh axis that shards another dim
    (FSDP over ``data``), and its gradient reduce-scattered back; a whole
    tensor is read as it is, its block cut, and it gets the whole
    gradient.  On a lanes-only mesh the rank holds every lane."""
    if not mesh.over_ranks:
        return fan_out(w, lanes)
    from torch.distributed.tensor import DTensor
    model = mesh.axis("model") if "model" in mesh.axis_names else None
    cut = block_dim is not None and model is not None and model.size > 1
    gathers = ()
    if isinstance(w, DTensor):
        if w.device_mesh != mesh.device_mesh:
            raise ValueError("a DTensor weight must be placed on the active "
                             "mesh's ranks (sharding.param_shardings)")
        for name, pl in zip(mesh.axis_names, w.placements):
            if not pl.is_shard():
                continue
            if name == "model" and pl.dim == block_dim:
                cut = False          # already this rank's block
            else:
                gathers += ((mesh.axis(name), pl.dim),)
        w = w.to_local()
    return _Spread.apply(w, lanes, gathers,
                         (model, block_dim) if cut else None)


# ---------------------------------------------------------------------------
# The bodies, over this rank's lanes
# ---------------------------------------------------------------------------

class Layout(NamedTuple):
    """This rank's lanes of the mesh's token axes: one entry per data axis
    ("pod", "data", those the mesh has) and the ``model`` axis."""
    data: Tuple[Lanes, ...]
    model: Lanes

    @classmethod
    def of(cls, mesh) -> "Layout":
        def lanes(name):
            if name not in mesh.axis_names:
                return (None, 1)
            return (mesh.axis(name), mesh.lanes(name))
        return cls(tuple(lanes(a) for a in ("pod", "data")
                         if a in mesh.axis_names), lanes("model"))

    def tokens(self, a2a: bool) -> Tuple[Lanes, ...]:
        return self.data + ((self.model,) if a2a else ())


def _aux(cfg: ModelConfig, me, ce, n, axes: Tuple[Lanes, ...]
         ) -> torch.Tensor:
    """The aux loss over the global batch from this rank's lanes' ``me``
    and ``ce`` (l, E), their sums over their tokens, and ``n`` (l,), their
    counts of tokens: each gathered in lane order and summed, over the
    gathered count (the reference's ``pmean`` of the lanes' means, whose
    counts are equal there; a padded lane holds fewer), then their
    product."""
    m = cfg.moe
    total = gather(n, axes).sum()
    me = gather(me, axes).sum(0) / total
    ce = gather(ce, axes).sum(0) / total
    return m.aux_loss_weight * m.num_experts * torch.sum(me * ce)


def _route_sums(probs, top_e, e: int, w) -> Tuple[torch.Tensor, ...]:
    """The aux loss's sums over a lane's tokens, each weighted by ``w``
    (t,) (0 for padding): the router probabilities, and each expert's
    share of a token's k slots."""
    w = w.to(torch.float32)[:, None]
    return ((probs * w).sum(0),
            (one_hot(top_e, e, torch.float32).sum(-2) * w).sum(0))


def _a2a_send(x, router, cfg: ModelConfig, n_dev: int, cap_s: int, real):
    """One lane of the a2a body up to the exchange: x (t, d) routed,
    bucketed by destination position.  ``real`` (t,) bool marks the rows
    that are tokens; a padding row goes to no position, takes no slot and
    adds nothing to ``me`` or ``ce``.  Returns (send_x (n_dev, cap_s, d),
    send_eid (n_dev, cap_s), the slots for the combine, me, ce: sums over
    the tokens)."""
    m = cfg.moe
    t, d = x.shape
    k, e_local = m.top_k, m.num_experts // n_dev
    probs, top_p, top_e = route(x, router, k)
    flat_e = top_e.reshape(t * k)
    slot_real = real[:, None].expand(t, k).reshape(t * k)
    # (T*k,) in [0, M); padding fills a bucket past the last position
    dst = torch.where(slot_real, flat_e // e_local, n_dev)
    send_pos = rank_within(dst, n_dev + 1)
    keep = slot_real & (send_pos < cap_s)
    send_pos_c = torch.where(keep, send_pos, 0)
    dst_c = torch.where(keep, dst, 0)
    rows = x[:, None].expand(t, k, d).reshape(t * k, d)
    send_x = dispatch(rows, (dst_c, send_pos_c), keep, (n_dev, cap_s, d))
    # a max-scatter whose empty slots hold -1
    eid = torch.where(keep, flat_e % e_local, -1).to(torch.int32)
    send_eid = torch.full((n_dev * cap_s,), -1, dtype=torch.int32,
                          device=x.device).scatter_reduce(
        0, dst_c * cap_s + send_pos_c, eid, "amax")
    slots = (dst_c, send_pos_c, keep, top_p.reshape(t * k))
    return (send_x, send_eid.reshape(n_dev, cap_s), slots,
            *_route_sums(probs, top_e, m.num_experts, real))


def _a2a_experts(rx, re, wg, wu, wd, cap_e: int) -> torch.Tensor:
    """One lane's received rows rx (P, d) for its experts (ids re (P,),
    -1 for an empty slot) regrouped per expert, through the FFN and back
    to their slots -> (P, d_out)."""
    e_local = wg.shape[0]
    valid = re >= 0
    re_c = torch.where(valid, re, 0)
    pos_e = rank_within(torch.where(valid, re_c, e_local), e_local + 1)
    keep_e = valid & (pos_e < cap_e)
    pos_e_c = torch.where(keep_e, pos_e, 0)
    e_c = torch.where(keep_e, re_c, 0)
    ebuf = dispatch(rx, (e_c, pos_e_c), keep_e,
                    (e_local, cap_e, rx.shape[-1]))
    y_e = swiglu_experts(ebuf, wg, wu, wd)
    return torch.where(keep_e[:, None], y_e[e_c, pos_e_c],
                       torch.zeros((), dtype=y_e.dtype, device=rx.device))


def moe_ffn_a2a_local(x: torch.Tensor, p, cfg: ModelConfig, mesh,
                      real=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The a2a body over this rank's lanes of ``mesh``.

    x: (G, w, T_local, d), the tokens of lane (g, j): G lanes of the data
    axes (row-major), w of the ``n_dev`` positions of ``model``; ``p``
    the router (d, E) and the expert stacks (E, d, f), (E, f, d), whole or
    placed (:func:`_gather_fsdp`): lane j runs the e_local experts of its
    position.  ``real`` (G, w, T_local) bool marks the rows that are
    tokens (None: all; see :func:`_a2a_send`).  Returns (y (G, w, T_local,
    d), aux ()): aux over every lane of the mesh."""
    m = cfg.moe
    G, w, t, d = x.shape
    layout = Layout.of(mesh)
    n_dev = mesh.shape["model"]
    k, e_local = m.top_k, m.num_experts // n_dev
    cap_s = max(8, int(m.capacity_factor * t * k / n_dev + 3) // 4 * 4)
    cap_e = max(8, int(m.capacity_factor * t * k * n_dev
                       / m.num_experts + 3) // 4 * 4)
    tokens = layout.tokens(True)
    model = layout.model[0]

    real = (torch.ones((G * w, t), dtype=torch.bool, device=x.device)
            if real is None else real.reshape(G * w, t))
    lanes = [_a2a_send(xi, ri, cfg, n_dev, cap_s, re) for xi, ri, re in
             zip(x.reshape(G * w, t, d),
                 _gather_fsdp(p["router"], mesh, None, tokens), real)]
    send_x, send_eid, slots, me, ce = zip(*lanes)
    aux = _aux(cfg, torch.stack(me), torch.stack(ce),
               real.sum(-1).to(torch.float32), tokens)

    # ---- exchange: tokens travel to their experts' position ----
    recv_x = _Exchange.apply(torch.stack(send_x).reshape(
        G, w, n_dev, cap_s, d), model)
    recv_eid = _exchange(torch.stack(send_eid).reshape(G, w, n_dev, cap_s),
                         model)

    # ---- each lane's experts: data lane g's copy of the weights ----
    wgs, wus, wds = (_gather_fsdp(p[n], mesh, 0, layout.data)
                     for n in ("moe_gate", "moe_up", "moe_down"))
    back = []
    for g in range(G):
        for j in range(w):
            ex = slice(j * e_local, (j + 1) * e_local)
            back.append(_a2a_experts(
                recv_x[g, j].reshape(n_dev * cap_s, d),
                recv_eid[g, j].reshape(-1).long(), wgs[g][ex], wus[g][ex],
                wds[g][ex], cap_e).to(x.dtype))

    # ---- route results back through the same slots ----
    recv_back = _Exchange.apply(torch.stack(back).reshape(
        G, w, n_dev, cap_s, -1), model).reshape(G * w, n_dev, cap_s, -1)

    # ---- combine locally: weighted sum per source token ----
    ys = [combine(rb[dst_c, pos], gates, keep, k)
          for rb, (dst_c, pos, keep, gates) in zip(recv_back, slots)]
    return torch.stack(ys).to(x.dtype).reshape(G, w, t, -1), aux


def moe_ffn_tp_local(x: torch.Tensor, p, cfg: ModelConfig, mesh
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tp body over this rank's lanes of ``mesh``.

    x: (G, T_local, d), the tokens of this rank's G data lanes (the same
    on each of its w ``model`` lanes, which route alike, so routing runs
    once a data lane); ``p`` as for :func:`moe_ffn_a2a_local`: ``model``
    lane j holds the f-slice j·f_loc onwards of every expert (``n_dev``
    lanes in all).  Each ``model`` lane's partial output goes through its
    slice, and the partials are gathered and added in lane order (the
    reference's ``psum``).  Returns (y (G, T_local, d), aux ())."""
    m = cfg.moe
    G, t, d = x.shape
    layout = Layout.of(mesh)
    k, e = m.top_k, m.num_experts
    w = layout.model[1]
    cap = max(8, int(m.capacity_factor * t * k / e + 3) // 4 * 4)
    wgs, wus, wds = (_gather_fsdp(p[n], mesh, dim, layout.data) for n, dim
                     in (("moe_gate", 2), ("moe_up", 2), ("moe_down", 1)))
    f_loc = wgs[0].shape[-1] // w

    me, ce, slots, parts = [], [], [], []
    for g, router in enumerate(_gather_fsdp(p["router"], mesh, None,
                                            layout.data)):
        probs, top_p, top_e = route(x[g], router, k)
        sums = _route_sums(probs, top_e, e, probs.new_ones(t))
        me.append(sums[0])
        ce.append(sums[1])
        flat_e = top_e.reshape(t * k)
        pos = rank_within(flat_e, e)
        keep = pos < cap
        pos_c = torch.where(keep, pos, 0)
        e_c = torch.where(keep, flat_e, 0)
        rows = x[g][:, None].expand(t, k, d).reshape(t * k, d)
        disp = dispatch(rows, (e_c, pos_c), keep, (e, cap, d))
        slots.append((e_c, pos_c, keep, top_p.reshape(t * k)))
        for j, dj in enumerate(fan_out(disp, (layout.model,))):
            # each lane's slice laid out alike, whatever the rank holds
            f = slice(j * f_loc, (j + 1) * f_loc)
            parts.append(swiglu_experts(
                dj, wgs[g][..., f].contiguous(), wus[g][..., f].contiguous(),
                wds[g][:, f].contiguous()))
    aux = _aux(cfg, torch.stack(me), torch.stack(ce),
               torch.full((G,), float(t), device=x.device), layout.data)

    # psum over model: (w, G, ...) gathered to (n_dev, G, ...), added in
    # lane order
    y_e = lane_sum(gather(torch.stack(parts).reshape(
        G, w, *parts[0].shape).transpose(0, 1), (layout.model,)))
    ys = [combine(y_e[g][e_c, pos_c], gates, keep, k)
          for g, (e_c, pos_c, keep, gates) in enumerate(slots)]
    return torch.stack(ys).to(x.dtype), aux


# ---------------------------------------------------------------------------
# Entry points (called from the transformer layer)
# ---------------------------------------------------------------------------

def _is_a2a(mesh, cfg: ModelConfig) -> bool:
    msize = mesh.shape.get("model", 1)
    return msize > 1 and cfg.moe.num_experts % msize == 0


def moe_ffn_sharded(p, x: torch.Tensor, cfg: ModelConfig, real=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in replacement for ``moe.moe_ffn`` over the active mesh's
    positions (``sharding.use_rules(rules, mesh)``); ``moe.moe_ffn`` when
    no mesh is active.

    ``x`` (..., d) holds this rank's block of the tokens: its positions
    along the token axes, row-major as the reference's in_spec
    ``P(token_axes, None)`` (every token on a lanes-only mesh; over ranks
    the positions of this rank's coordinates, the same block on each
    ``model`` rank of the tp path).  ``real`` (x's rows,) bool, on the a2a
    path only, marks the rows that are tokens; the others are padding,
    which routes nowhere.  Returns (y, the block's output, in ``x``'s
    shape; aux, over the whole mesh)."""
    mesh = _active_mesh.get()
    if mesh is None:
        return moe_mod.moe_ffn(p, x, cfg)
    check_mesh_device(mesh, x.device)

    d = x.shape[-1]
    msize = mesh.shape.get("model", 1)
    a2a = _is_a2a(mesh, cfg)
    layout = Layout.of(mesh)
    g = math.prod(n for _, n in layout.data)
    w = layout.model[1]
    lanes = g * (w if a2a else 1)
    t = x.numel() // d
    # every rank checks before the first collective
    if t % lanes:
        raise ValueError(f"{t} tokens do not split evenly over the mesh's "
                         f"{lanes} token positions on this rank")
    if not a2a and cfg.d_ff % msize:
        raise ValueError(f"d_ff {cfg.d_ff} does not split over the "
                         f"mesh's {msize} model positions")
    if a2a:
        y, aux = moe_ffn_a2a_local(
            x.reshape(g, w, t // lanes, d), p, cfg, mesh,
            None if real is None else real.reshape(g, w, t // lanes))
    else:
        y, aux = moe_ffn_tp_local(x.reshape(g, t // lanes, d), p, cfg, mesh)
    return y.reshape(x.shape), aux


def token_axes(mesh, cfg: ModelConfig) -> Tuple[Lanes, ...]:
    """This rank's lanes of the axes the tokens split over."""
    return Layout.of(mesh).tokens(_is_a2a(mesh, cfg))


def _positions(axes: Tuple[Lanes, ...]) -> int:
    return math.prod(n * (a.size if a is not None else 1) for a, n in axes)


def token_block(x: torch.Tensor, cfg: ModelConfig, mesh=None
                ) -> torch.Tensor:
    """This rank's block (T_rank, d) of the whole tokens x (..., d), as
    :func:`moe_ffn_sharded` takes it on ``mesh`` (default: the active
    one); its backward gathers the blocks' gradients over the ranks."""
    mesh = mesh if mesh is not None else _active_mesh.get()
    axes = token_axes(mesh, cfg)
    n, d = _positions(axes), x.shape[-1]
    t = x.numel() // d
    if t % n:
        raise ValueError(f"{t} tokens do not split evenly over the mesh's "
                         f"{n} token positions")
    x = x.reshape(n, t // n, d)
    out = _Scatter.apply(x, axes) if _ranked(axes) else x
    return out.reshape(-1, d)


def _moe_ffn_dtensor(p, x, cfg: ModelConfig, mesh):
    """:func:`moe_ffn_whole` on the DTensor activations of the partitioned
    model (x (B, S, d), its batch split over the data ranks): this rank's
    rows are already its data positions' tokens, so its block is its
    ``model`` coordinate's share of them (a2a; all of them for tp), with
    no gather; the output is gathered over ``model`` alone and split over
    the data ranks as x is.  Rows that do not split over the model ranks
    (a decode step's few tokens a rank) are padded with zero rows (the
    reference's shard_map refuses them), which route nowhere: they take
    no capacity slot, add nothing to the aux loss, whose means are over
    the tokens alone, and are dropped from the output."""
    x = shard(x, "batch", "seq", "embed")
    split = [n for n, pl in zip(mesh.axis_names, x.placements)
             if pl.is_shard(0)]
    if split != [a for a in ("pod", "data") if a in mesh.axis_names]:
        raise ValueError(f"the partitioned moe layer needs the batch "
                         f"({x.shape[0]}) split over every data axis of "
                         f"the mesh {mesh.shape}")
    local = x.to_local()
    d = local.shape[-1]
    rows = local.reshape(-1, d)
    model, n, real = (), rows.shape[0], None
    if _is_a2a(mesh, cfg):
        axis = mesh.axis("model")
        if mesh.lanes("model") != 1:
            raise ValueError("the partitioned moe layer needs one rank a "
                             "position of the mesh's model axis")
        model = ((axis, 1),)
        if n % axis.size:
            rows = torch.cat([rows, rows.new_zeros(
                (-n % axis.size, d))])
            q = rows.shape[0] // axis.size
            real = torch.arange(axis.coord * q, (axis.coord + 1) * q,
                                device=rows.device) < n
        # this rank's block; its backward gathers every block's gradient
        rows = _Scatter.apply(rows.reshape(axis.size, -1, d),
                              model).reshape(-1, d)
    y, aux = moe_ffn_sharded(p, rows, cfg, real)
    y = gather(y.reshape(1, -1, d), model).reshape(-1, d)[:n] if model \
        else y
    return like(y.reshape(local.shape), x), replicated(aux, x)


def moe_ffn_whole(p, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_ffn_sharded` on the whole ``x`` (..., d) that every rank
    of a mesh over ranks holds: this rank's block in
    (:func:`token_block`), every block's output gathered back, so that
    each rank returns the whole y.  On a lanes-only mesh, or none, it is
    :func:`moe_ffn_sharded`."""
    mesh = _active_mesh.get()
    if mesh is None or not mesh.over_ranks:
        return moe_ffn_sharded(p, x, cfg)
    if is_dtensor(x):
        return _moe_ffn_dtensor(p, x, cfg, mesh)
    y, aux = moe_ffn_sharded(p, token_block(x, cfg, mesh), cfg)
    axes = token_axes(mesh, cfg)
    lanes = math.prod(n for _, n in axes)
    y = gather(y.reshape(lanes, -1, y.shape[-1]), axes)
    return y.reshape(x.shape), aux
