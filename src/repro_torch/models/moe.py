"""Mixture-of-experts SwiGLU FFN with top-k routing and capacity buffers.
Port of ``repro.models.moe``.

Routing: softmax over expert logits (f32, whatever the parameter dtype),
top-k per token, probabilities renormalized over the selected k
(qwen3/grok convention); tokens beyond an expert's capacity are dropped
(they add zero; the residual passes them through).  Dispatch and combine
go through (E, capacity, d) buffers, as in the reference.

Three choices keep the port's values the reference's, and its bits fixed
from run to run on the card:

* ``jax.lax.top_k`` puts the lowest expert first among equal
  probabilities; :func:`top_k` orders by (−p, e) through a stable sort.
* Kept (token, slot) pairs occupy distinct buffer slots, and dropped ones
  add exact zeros at slot 0 of their expert, so the dispatch's
  ``index_put_`` gives the same bits in any order of its updates.
* The combine adds each token's k weighted expert outputs in f32 in slot
  order, as a (T, k, d) view summed one slot at a time: no float atomics
  (``index_add_``), whose order changes from run to run.  The token rows
  it dispatches are an ``expand`` of the tokens, whose backward is a
  reduction, not an atomic scatter.

The reference's ``shard(...)`` constraints stand where it has them
(``sharding.shard``: the identity but on DTensors over ranks).  Over
ranks the buffers and index tensors are DTensors, and two ops read
otherwise there, with the same values: the tokens are gathered whole
before the routing (the capacity slots rank each expert's tokens over
the whole batch), the combine's gather is an ``index_select`` of the
flattened buffers, and the one-hot's ``arange`` is a replicated DTensor
(DTensor has no rule for ``aten.index``, nor for a plain tensor beside a
DTensor).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.common import normal_init
from repro_torch.sharding import (block, is_dtensor, replicated, shard, span,
                                  spec_placements, sum_parts, unshard)


def moe_init(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    e = cfg.moe.num_experts
    return {
        "router": normal_init(generator, (d, e), d ** -0.5, torch.float32),
        "moe_gate": normal_init(generator, (e, d, f), d ** -0.5, dtype),
        "moe_up": normal_init(generator, (e, d, f), d ** -0.5, dtype),
        "moe_down": normal_init(generator, (e, f, d), f ** -0.5, dtype),
    }


def _capacity(cfg: ModelConfig, tokens: int) -> int:
    m = cfg.moe
    c = int(m.capacity_factor * tokens * m.top_k / m.num_experts)
    return max(8, min(tokens, (c + 3) // 4 * 4))


def top_k(probs: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row of ``probs`` in descending order, ties to
    the lowest index (``jax.lax.top_k``'s order).  Returns (values,
    int64 indices)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def one_hot(ids: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``F.one_hot(ids, n).to(dtype)`` as one comparison, the same ops on
    every device (``F.one_hot`` checks the ids' range on the CPU alone,
    so an op record made there would differ from the card's)."""
    return (ids[..., None] == replicated(torch.arange(n, device=ids.device),
                                         ids)).to(dtype)


def rank_within(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Exclusive rank of each element of ``ids`` (in [0, num_buckets))
    within its bucket, along the last axis: the reference's cumsum of the
    int32 one-hot, laid out (buckets, P) so that the scan runs along
    contiguous memory (on one H100 the cumsum of a 32,768 × 128 one-hot
    along the P axis takes 8.8 ms, this way 0.18 ms:
    ``scripts/torch_moe_rank_bench.py``)."""
    onehot = one_hot(ids, num_buckets, torch.int32)
    csum = torch.cumsum(onehot.transpose(-1, -2).contiguous(), dim=-1,
                        dtype=torch.int32)
    return torch.gather(csum, -2, ids[..., None, :])[..., 0, :] - 1


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """x (..., T, d), router (d, E) -> (probs (..., T, E) f32, top_p
    renormalized, top_e).  The logits are f32: ``x`` cast to f32 times the
    f32 router."""
    # over ranks every rank routes every token (moe_ffn): the router, a
    # few MB, whole on each
    logits = x.float() @ unshard(router, "pod", "data", "model").float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def expert_counts(top_e: torch.Tensor, e: int) -> torch.Tensor:
    """The aux loss's ``ce``: the mean over tokens of each expert's share
    of a token's k slots (a one-hot: no gradient)."""
    return one_hot(top_e, e, torch.float32).sum(-2).mean(-2)


def swiglu_experts(disp: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """(E, C, d) buffers through each expert's SwiGLU -> (E, C, d_out).
    Weights are cast to the buffers' dtype at use; silu runs in f32 and is
    rounded before the product with ``u``."""
    dt = disp.dtype
    if is_dtensor(disp) and disp.shape[1] >= wg.shape[-1]:
        # over ranks, with more slots an expert than its hidden width: the
        # weights gathered over their FSDP split, in the compute dtype
        # (DTensor would split the products over it and reduce the larger
        # activations)
        wg, wu, wd = (unshard(w.to(dt), "pod", "data") for w in (wg, wu, wd))
    g = torch.bmm(disp, wg.to(dt))
    u = torch.bmm(disp, wu.to(dt))
    h = shard(F.silu(g.float()).to(dt) * u, "expert", "capacity", "mlp")
    return shard(torch.bmm(h, wd.to(dt)), "expert", "capacity", "embed")


def dispatch(rows: torch.Tensor, index: Tuple[torch.Tensor, ...],
             keep: torch.Tensor, shape) -> torch.Tensor:
    """Buffers of ``shape`` holding ``rows`` (P, d) at ``index`` (one
    index tensor per leading axis of ``shape``) where ``keep``; a dropped
    row adds zeros where its index points."""
    rows = torch.where(keep[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    buf = replicated(torch.zeros(shape, dtype=rows.dtype,
                                 device=rows.device), rows)
    return buf.index_put(index, rows, accumulate=True)


def combine(got: torch.Tensor, gates: torch.Tensor, keep: torch.Tensor,
            k: int) -> torch.Tensor:
    """(..., T·k, d) expert outputs weighted by ``gates`` where ``keep``,
    added per token in f32 in slot order -> (..., T, d) f32."""
    w = (gates * keep).float()
    v = got.float() * w[..., None]
    v = v.unflatten(-2, (v.shape[-2] // k, k))
    y = v[..., 0, :]
    for j in range(1, k):
        y = y + v[..., j, :]
    return y


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux_loss ())."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.num_experts, m.top_k
    cap = _capacity(cfg, t)
    # over ranks every rank routes every token: the capacity slots are
    # ranks within the whole batch (a cumsum over the tokens), which
    # DTensor gets wrong on tokens split over ranks
    xt = unshard(x.reshape(t, d), "pod", "data")

    probs, top_p, top_e = route(xt, p["router"], k)

    # load-balancing aux loss (Switch-style): E * sum_e f_e * P_e
    me = probs.mean(0)
    ce = expert_counts(top_e, e)
    aux = m.aux_loss_weight * e * torch.sum(me * ce)

    # position of each (token, slot) within its expert's capacity buffer
    flat_e = top_e.reshape(-1)                                   # (T*k,)
    pos = rank_within(flat_e, e)
    keep = pos < cap
    pos = torch.where(keep, pos, 0)

    # dispatch: (E, cap, d) buffers
    rows = xt[:, None].expand(t, k, d).reshape(t * k, d)
    if is_dtensor(rows):
        disp = _dispatch_own(rows, flat_e, pos, keep, (e, cap, d))
    else:
        disp = dispatch(rows, (flat_e, pos), keep, (e, cap, d))
    disp = shard(disp, "expert", "capacity", "embed")

    y_e = swiglu_experts(disp, p["moe_gate"], p["moe_up"], p["moe_down"])

    # combine: weighted gather back to tokens
    if is_dtensor(y_e):
        yt = _combine_own(y_e, flat_e, pos, keep, top_p.reshape(-1), k,
                          spec_placements((t, d), "batch", "embed"))
    else:
        yt = combine(y_e[flat_e, pos], top_p.reshape(-1), keep, k)
    return shard(yt.reshape(b, s, d).to(x.dtype), "batch", "seq",
                 "embed"), aux


def _own_slots(flat_e, pos, keep, offset: int, size: int):
    """The (token, slot) pairs that land in experts [offset, offset +
    size), as local tensors: (kept here, the local expert, the slot)."""
    fe, ps = flat_e.to_local(), pos.to_local()
    mine = keep.to_local() & (fe >= offset) & (fe < offset + size)
    return (mine, torch.where(mine, fe - offset, 0),
            torch.where(mine, ps, 0))


def _dispatch_own(rows, flat_e, pos, keep, shape):
    """:func:`dispatch` over ranks, every token's rows and slots whole on
    each rank (DTensors): where the experts split over ranks, each rank
    fills its own experts' buffers and no more (a whole (E, C, d) buffer
    on every rank would be the largest tensor of the layer); the rows'
    gradient is then a partial sum over those ranks."""
    from torch.distributed.tensor import DTensor, Partial
    placements = spec_placements(shape, "expert", "capacity", "embed")
    split = tuple(p.is_shard(0) for p in placements)
    if not any(split):
        return dispatch(rows, (flat_e, pos), keep, shape)
    offset, size = span(shape[0], rows.device_mesh, placements, 0)
    mine, ex, slot = _own_slots(flat_e, pos, keep, offset, size)
    local = rows.to_local(grad_placements=tuple(
        Partial() if s else p for s, p in zip(split, rows.placements)))
    return DTensor.from_local(
        dispatch(local, (ex, slot), mine, (size,) + tuple(shape[1:])),
        rows.device_mesh, placements, run_check=False)


def _combine_own(y_e, flat_e, pos, keep, gates, k: int, placements):
    """:func:`combine` over ranks, every token's slots whole on each rank
    (DTensors), into (T, d) tokens placed by ``placements`` (split over
    the batch's ranks): each rank weighs and adds, for its own tokens, the
    slots its experts hold (zero elsewhere), and one all-reduce over the
    experts' ranks adds the parts (a whole gather of the (E, C, d) outputs
    would move k·cf times more).  The gradients of the outputs and the
    gates are partial sums over the ranks that split the tokens or the
    experts."""
    from torch.distributed.tensor import Partial
    mesh = y_e.device_mesh
    split = tuple(p.is_shard(0) for p in y_e.placements)
    tokens = tuple(p.is_shard(0) for p in placements)
    t0, tn = span(gates.shape[0] // k, mesh, placements, 0)
    offset, size = block(y_e, 0)
    cap, d = y_e.shape[1], y_e.shape[2]
    mine, ex, slot = (a[t0 * k:(t0 + tn) * k] for a in _own_slots(
        flat_e, pos, keep, offset, size))
    got = y_e.to_local(grad_placements=tuple(
        Partial() if s else p for s, p in zip(tokens, y_e.placements))
    ).reshape(size * cap, d).index_select(0, ex * cap + slot)
    w = gates.to_local(grad_placements=tuple(
        Partial() if s or ts else p
        for s, ts, p in zip(split, tokens, gates.placements)))
    return sum_parts(combine(got, w[t0 * k:(t0 + tn) * k], mine, k), mesh,
                     split, placements)
