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
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.common import normal_init


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


def rank_within(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Exclusive rank of each element of ``ids`` (in [0, num_buckets))
    within its bucket, along the last axis: the reference's cumsum of the
    int32 one-hot, laid out (buckets, P) so that the scan runs along
    contiguous memory (on one H100 the cumsum of a 32,768 × 128 one-hot
    along the P axis takes 8.8 ms, this way 0.18 ms:
    ``scripts/torch_moe_rank_bench.py``)."""
    onehot = F.one_hot(ids, num_buckets).to(torch.int32)
    csum = torch.cumsum(onehot.transpose(-1, -2).contiguous(), dim=-1,
                        dtype=torch.int32)
    return torch.gather(csum, -2, ids[..., None, :])[..., 0, :] - 1


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """x (..., T, d), router (d, E) -> (probs (..., T, E) f32, top_p
    renormalized, top_e).  The logits are f32: ``x`` cast to f32 times the
    f32 router."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def expert_counts(top_e: torch.Tensor, e: int) -> torch.Tensor:
    """The aux loss's ``ce``: the mean over tokens of each expert's share
    of a token's k slots (a one-hot: no gradient)."""
    return F.one_hot(top_e, e).float().sum(-2).mean(-2)


def swiglu_experts(disp: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """(E, C, d) buffers through each expert's SwiGLU -> (E, C, d_out).
    Weights are cast to the buffers' dtype at use; silu runs in f32 and is
    rounded before the product with ``u``."""
    dt = disp.dtype
    g = torch.bmm(disp, wg.to(dt))
    u = torch.bmm(disp, wu.to(dt))
    h = F.silu(g.float()).to(dt) * u
    return torch.bmm(h, wd.to(dt))


def dispatch(rows: torch.Tensor, index: Tuple[torch.Tensor, ...],
             keep: torch.Tensor, shape) -> torch.Tensor:
    """Buffers of ``shape`` holding ``rows`` (P, d) at ``index`` (one
    index tensor per leading axis of ``shape``) where ``keep``; a dropped
    row adds zeros where its index points."""
    rows = torch.where(keep[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    buf = torch.zeros(shape, dtype=rows.dtype, device=rows.device)
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
    xt = x.reshape(t, d)

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
    disp = dispatch(rows, (flat_e, pos), keep, (e, cap, d))

    y_e = swiglu_experts(disp, p["moe_gate"], p["moe_up"], p["moe_down"])

    # combine: weighted gather back to tokens
    yt = combine(y_e[flat_e, pos], top_p.reshape(-1), keep, k)
    return yt.reshape(b, s, d).to(x.dtype), aux
