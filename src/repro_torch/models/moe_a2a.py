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

The port's mesh (:class:`~repro_torch.core.distributed.SearchMesh`) puts
every position on one device, so the bodies run with the positions as a
leading *lane* axis of one batch, and each collective is an operation over
that axis:

* ``all_to_all(split_axis=0, concat_axis=0, tiled=False)`` over ``model``
  is a transpose of the (source, destination) axes of the stacked send
  buffers;
* ``pmean`` over the token axes is a mean over their lanes;
* ``psum`` over ``model`` adds the ``model`` lanes' partial sums in lane
  order.

The one copy of each weight serves every lane: a lane's expert shard (a2a)
or f-slice (tp) is a slice of it, and the FSDP all-gather of the reference
(:func:`_gather_fsdp`) is the identity.  Lanes that run the same expert
are laid side by side in its buffer, so one batched product per weight
serves them all.  Dispatch and combine keep ``models.moe``'s
order-independent forms.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.distributed import check_mesh_device
from repro_torch.models import moe as moe_mod
from repro_torch.models.moe import (combine, dispatch, expert_counts,
                                    rank_within, route, swiglu_experts)
from repro_torch.sharding import _active_mesh

# set by set_moe_impl to route the transformer's MoE layers through
# moe_ffn_sharded
_IMPL = {"mode": "gspmd"}   # "gspmd" | "a2a"


def set_moe_impl(mode: str):
    _IMPL["mode"] = mode


def moe_impl() -> str:
    return _IMPL["mode"]


# the exclusive rank of each element within its bucket, along the last
# axis (each lane's own tokens)
_rank_within = rank_within


def _gather_fsdp(w: torch.Tensor, axis: int, data_axes) -> torch.Tensor:
    """The reference's FSDP all-gather of a weight shard: every lane reads
    the one whole copy, so there is nothing to gather."""
    return w


# (E_loc, C, d) × per-expert SwiGLU -> (E_loc, C, d_out)
_local_ffn = swiglu_experts


def _lane_index(lanes: int, per_lane: int, device) -> torch.Tensor:
    return torch.arange(lanes, device=device)[:, None].expand(lanes,
                                                              per_lane)


def _aux(cfg: ModelConfig, probs, top_e) -> torch.Tensor:
    """The aux loss over the global batch: ``me`` and ``ce`` each averaged
    over the token lanes (the reference's ``pmean``), then their product."""
    m = cfg.moe
    me = probs.mean(-2).mean(0)
    ce = expert_counts(top_e, m.num_experts).mean(0)
    return m.aux_loss_weight * m.num_experts * torch.sum(me * ce)


def _lanes_ffn(buf: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """(G, E, C, d) buffers of G lanes that share each expert's weights
    -> (G, E, C, d_out): one (E, G·C, d) product per weight."""
    g, e, c, d = buf.shape
    flat = buf.transpose(0, 1).reshape(e, g * c, d)
    y = _local_ffn(flat, wg, wu, wd)
    return y.reshape(e, g, c, -1).transpose(0, 1)


def moe_ffn_a2a_local(x: torch.Tensor, router_w: torch.Tensor, wg, wu, wd,
                      cfg: ModelConfig, n_dev: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The a2a body for every lane at once.

    x: (G, M, T_local, d), the tokens of lane (g, m) (``M = n_dev``
    positions of ``model``, ``G`` positions of the other token axes);
    router_w (d, E); wg/wu (E, d, f), wd (E, f, d), whole (position m
    holds experts m·E/M onwards).  Returns (y (G, M, T_local, d),
    aux ())."""
    m = cfg.moe
    G, M, t, d = x.shape
    k = m.top_k
    e_local = m.num_experts // n_dev
    L = G * M
    xl = x.reshape(L, t, d)
    dev = x.device

    probs, top_p, top_e = route(xl, router_w, k)
    aux = _aux(cfg, probs, top_e)

    # ---- bucket assignments by destination position (per lane) ----
    flat_e = top_e.reshape(L, t * k)
    gates = top_p.reshape(L, t * k)
    dst = flat_e // e_local                          # (L, T*k) in [0, M)
    cap_s = max(8, int(m.capacity_factor * t * k / n_dev + 3) // 4 * 4)
    send_pos = _rank_within(dst, n_dev)
    keep = send_pos < cap_s
    send_pos_c = torch.where(keep, send_pos, 0)
    dst_c = torch.where(keep, dst, 0)

    lane = _lane_index(L, t * k, dev)
    rows = xl[:, :, None].expand(L, t, k, d).reshape(L, t * k, d)
    send_x = dispatch(rows, (lane, dst_c, send_pos_c), keep,
                      (L, n_dev, cap_s, d))
    # a max-scatter whose empty slots hold -1
    slot = (lane * n_dev + dst_c) * cap_s + send_pos_c
    eid = torch.where(keep, flat_e % e_local, -1).to(torch.int32)
    send_eid = torch.full((L * n_dev * cap_s,), -1, dtype=torch.int32,
                          device=dev).scatter_reduce(
        0, slot.reshape(-1), eid.reshape(-1), "amax")

    # ---- exchange: all_to_all over model = swap (source, destination) ----
    recv_x = send_x.reshape(G, M, n_dev, cap_s, d).transpose(1, 2)
    recv_eid = send_eid.reshape(G, M, n_dev, cap_s).transpose(1, 2)
    rx = recv_x.reshape(L, n_dev * cap_s, d)
    re = recv_eid.reshape(L, n_dev * cap_s).long()
    valid = re >= 0
    re_c = torch.where(valid, re, 0)

    wg = _gather_fsdp(wg, 1, ())
    wu = _gather_fsdp(wu, 1, ())
    wd = _gather_fsdp(wd, 2, ())

    # ---- regroup by local expert ----
    cap_e = max(8, int(m.capacity_factor * t * k * n_dev
                       / m.num_experts + 3) // 4 * 4)
    pos_e = _rank_within(torch.where(valid, re_c, e_local), e_local + 1)
    keep_e = valid & (pos_e < cap_e)
    pos_e_c = torch.where(keep_e, pos_e, 0)
    e_c = torch.where(keep_e, re_c, 0)
    lane_r = _lane_index(L, n_dev * cap_s, dev)
    ebuf = dispatch(rx, (lane_r, e_c, pos_e_c), keep_e,
                    (L, e_local, cap_e, d))

    # lane (g, m) runs experts m·e_local .. (m+1)·e_local - 1: the G lanes
    # of one expert share its weights
    y_e = _lanes_ffn(ebuf.reshape(G, M * e_local, cap_e, d), wg, wu, wd)
    y_e = y_e.reshape(L, e_local, cap_e, -1)

    # ---- route results back through the same slots ----
    back = torch.where(keep_e[..., None], y_e[lane_r, e_c, pos_e_c],
                       torch.zeros((), dtype=y_e.dtype, device=dev))
    back = back.to(x.dtype).reshape(G, M, n_dev, cap_s, d)
    recv_back = back.transpose(1, 2).reshape(L, n_dev, cap_s, d)

    # ---- combine locally: weighted sum per source token ----
    got = recv_back[lane, dst_c, send_pos_c]         # (L, T*k, d)
    yt = combine(got, gates, keep, k)
    return yt.to(x.dtype).reshape(G, M, t, d), aux


def moe_ffn_tp_local(x: torch.Tensor, router_w: torch.Tensor, wg, wu, wd,
                     cfg: ModelConfig, n_dev: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tp body for every lane at once.

    x: (G, T_local, d), the tokens of the G data lanes (replicated over
    the ``n_dev`` model lanes, which compute the same routing, so it is
    computed once); wg/wu (E, d, f), wd (E, f, d), whole: model lane j
    holds the f-slice j·f/M onwards.  Each model lane's partial output
    goes through its slice, and the partials are added in lane order (the
    reference's ``psum``).  Returns (y (G, T_local, d), aux ())."""
    m = cfg.moe
    G, t, d = x.shape
    k = m.top_k
    e = m.num_experts
    probs, top_p, top_e = route(x, router_w, k)
    aux = _aux(cfg, probs, top_e)

    wg = _gather_fsdp(wg, 1, ())
    wu = _gather_fsdp(wu, 1, ())
    wd = _gather_fsdp(wd, 2, ())

    flat_e = top_e.reshape(G, t * k)
    gates = top_p.reshape(G, t * k)
    cap = max(8, int(m.capacity_factor * t * k / e + 3) // 4 * 4)
    pos = _rank_within(flat_e, e)
    keep = pos < cap
    pos_c = torch.where(keep, pos, 0)
    e_c = torch.where(keep, flat_e, 0)
    lane = _lane_index(G, t * k, x.device)
    rows = x[:, :, None].expand(G, t, k, d).reshape(G, t * k, d)
    disp = dispatch(rows, (lane, e_c, pos_c), keep, (G, e, cap, d))

    f_loc = wg.shape[-1] // n_dev
    y_e = None
    for j in range(n_dev):                           # psum over model
        sl = slice(j * f_loc, (j + 1) * f_loc)
        part = _lanes_ffn(disp, wg[..., sl], wu[..., sl], wd[:, sl])
        y_e = part if y_e is None else y_e + part

    got = y_e[lane, e_c, pos_c]
    yt = combine(got, gates, keep, k)
    return yt.to(x.dtype), aux


def moe_ffn_sharded(p, x: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in replacement for ``moe.moe_ffn`` over the active mesh's
    positions (``sharding.use_rules(rules, mesh)``); ``moe.moe_ffn`` when
    no mesh is active.

    Tokens split over ``token_axes`` in row-major order of their positions
    (the reference's in_spec ``P(token_axes, None)``) and are joined back
    in that order."""
    mesh = _active_mesh.get()
    if mesh is None:
        return moe_mod.moe_ffn(p, x, cfg)
    check_mesh_device(mesh, x.device)

    b, s, d = x.shape
    names = mesh.axis_names
    shape = mesh.shape
    msize = shape.get("model", 1)
    e = cfg.moe.num_experts
    a2a = msize > 1 and e % msize == 0
    data_only = tuple(a for a in ("pod", "data") if a in names)
    g = 1
    for a in data_only:
        g *= shape[a]
    lanes = g * (msize if a2a else 1)
    t = b * s
    if t % lanes:
        raise ValueError(f"{t} tokens do not split evenly over the mesh's "
                         f"{lanes} token positions")
    xt = x.reshape(t, d)
    if a2a:
        y, aux = moe_ffn_a2a_local(
            xt.reshape(g, msize, t // lanes, d), p["router"], p["moe_gate"],
            p["moe_up"], p["moe_down"], cfg, msize)
    else:
        if cfg.d_ff % msize:
            raise ValueError(f"d_ff {cfg.d_ff} does not split over the "
                             f"mesh's {msize} model positions")
        y, aux = moe_ffn_tp_local(
            xt.reshape(g, t // lanes, d), p["router"], p["moe_gate"],
            p["moe_up"], p["moe_down"], cfg, msize)
    return y.reshape(b, s, d), aux
