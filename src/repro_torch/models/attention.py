"""Grouped-query attention with KV cache, RoPE/M-RoPE, sliding window.

Port of ``repro.models.attention`` (plain torch: the reference has no
kernel here).  Three entry points share one core:
  * ``attend(..., mode="train")``   — full causal self-attention
  * ``attend(..., mode="prefill")`` — causal, writes the cache
  * ``attend(..., mode="decode")``  — one query step against the cache
and ``kv_x=`` gives cross-attention.  The KV cache layout is
(B, S_max, kv_heads, head_dim), its sequence dim named ``kv_seq``.  The
reference's ``shard(...)`` constraints stand where it has them: on one
device, or a lanes-only mesh, they return their input; on DTensors over
the ranks of the active mesh (the dry run's partitioner) they
redistribute, and the decode step writes each rank's own block of the
cache (:func:`_write_slot`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import apply_rope, normal_init
from repro_torch.sharding import (block, is_dtensor, like, repeat_heads,
                                  replicated, shard, shard_merge, shard_split,
                                  sharded_dim)


class KVCache(NamedTuple):
    k: torch.Tensor      # (B, S_max, kv_heads, head_dim)
    v: torch.Tensor      # (B, S_max, kv_heads, head_dim)


def attn_init(generator: torch.Generator, cfg: ModelConfig,
              d_in: Optional[int] = None, dtype=None) -> dict:
    d = d_in or cfg.d_model
    h = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    dtype = dtype or torch.float32
    scale = 1.0 / (d ** 0.5)
    p = {
        "wq": normal_init(generator, (d, nq * h), scale, dtype),
        "wk": normal_init(generator, (d, nkv * h), scale, dtype),
        "wv": normal_init(generator, (d, nkv * h), scale, dtype),
        "wo": normal_init(generator, (nq * h, cfg.d_model),
                          1.0 / ((nq * h) ** 0.5), dtype),
    }
    if cfg.qkv_bias:
        dev = generator.device
        p["wq_b"] = torch.zeros((nq * h,), dtype=dtype, device=dev)
        p["wk_b"] = torch.zeros((nkv * h,), dtype=dtype, device=dev)
        p["wv_b"] = torch.zeros((nkv * h,), dtype=dtype, device=dev)
    return p


def _proj_qkv(p, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    h = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if "wq_b" in p:
        q = q + p["wq_b"].to(dt)
        k = k + p["wk_b"].to(dt)
        v = v + p["wv_b"].to(dt)
    return (shard_split(q, (b, s, nq, h), "batch", "seq", "heads", None),
            shard_split(k, (b, s, nkv, h), "batch", "seq", "kv_heads", None),
            shard_split(v, (b, s, nkv, h), "batch", "seq", "kv_heads", None))


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """Scaled dot-product attention with GQA head-group expansion.

    q (B,Sq,Hq,D); k/v (B,Sk,Hkv,D); mask broadcastable (B,1,Sq,Sk) bool.

    The reference's casts, one for one: q is scaled in f32 and cast back;
    scores are the f32 sums of the storage-dtype products (its
    ``preferred_element_type=f32``: bf16 products are exact in f32, so the
    operands are widened and multiplied in f32); masked scores are −1e30;
    the softmax runs in f32; probs are cast to v's dtype; the output sums
    in f32 and is cast to q's dtype."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    groups = hq // hkv
    if groups > 1 and sharded_dim(q, 2) and not any(
            sharded_dim(t, i) for t in (k, v) for i in (1, 2)):
        # over ranks: q's heads split, k/v's heads and sequence whole
        k, v = repeat_heads(k, q, groups), repeat_heads(v, q, groups)
        hkv, groups = hq, 1
    if is_dtensor(q) and not sharded_dim(k, 1) \
            and q.placements == k.placements == v.placements \
            and not any(p.is_partial() for p in q.placements):
        # over ranks, q, k and v split alike over the batch and the heads
        # and whole along the sequence: each rank attends its own rows and
        # heads and nothing is sent (DTensor's strategy search for these
        # products on a 3-D mesh takes minutes a distinct shape)
        return like(_sdpa(q.to_local(), k.to_local(), v.to_local(),
                          mask.to_local() if is_dtensor(mask) else mask,
                          cfg), q)
    qs = (q.float() / (d ** 0.5)).to(q.dtype)
    # a decode step over a cache whose sequence is split over ranks: q
    # whole on those ranks (its kv heads not split where the sequence is;
    # one token of q moves, no slot of the cache)
    qg = shard_split(qs, (b, sq, hkv, groups, d), "batch", "seq",
                     "kv_heads", None, None,
                     whole_on=_seq_split(k))
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    # mask (B?, 1, Sq, Sk) -> (B?, 1, 1, Sq, Sk) for the group axis
    scores = torch.where(replicated(mask, scores)[:, :, None, :, :], scores,
                         scores.new_full((), -1e30))
    probs = (_split_softmax(scores) if sharded_dim(scores, -1)
             else torch.softmax(scores, dim=-1))
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return shard_merge(out, (b, sq, hq, d), "batch", "seq", "kv_heads", None,
                       None).to(q.dtype)


def _seq_split(k):
    """Per mesh dim, whether it splits the DTensor ``k``'s sequence (dim
    1); None when none does (or ``k`` is a plain tensor)."""
    if not sharded_dim(k, 1):
        return None
    return tuple(p.is_shard(1) for p in k.placements)


def _split_softmax(scores):
    """Softmax over a last dim split over ranks (a decode step's scores
    over the sequence-split cache): the max and the sum are partial
    reductions (an all-reduce each of (..., 1)) and each rank takes the
    exponentials of its own block, as GSPMD partitions it; DTensor's own
    softmax would gather the scores whole."""
    top = scores.detach().amax(dim=-1, keepdim=True)
    e = torch.exp(scores - top)
    return e / e.sum(dim=-1, keepdim=True)


def causal_mask(sq: int, sk: int, offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """(1, 1, sq, sk) causal (+optional sliding window) mask."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    ki = torch.arange(sk, device=device)[None, :]
    m = ki <= qi
    if window > 0:
        m &= ki > qi - window
    return m[None, None]


def attend(
    p,
    x: torch.Tensor,
    cfg: ModelConfig,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    mode: str = "train",
    cache: Optional[KVCache] = None,
    pos: Optional[torch.Tensor] = None,    # decode: (B,) current positions
    kv_x: Optional[torch.Tensor] = None,   # cross-attention source
    causal: bool = True,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Attention block.  Decode writes this step's k/v into ``cache`` at
    ``pos`` IN PLACE (the reference rewrites the whole cache through a
    where-mask; the values are the same) and returns the same tensors.  A
    position at or past the cache's end writes nothing, as the reference's
    where-mask selects no slot there; it still attends over every slot."""
    b, s, _ = x.shape
    dev = x.device

    if kv_x is not None:                          # cross-attention
        q, _, _ = _proj_qkv(p, x, cfg)
        _, k, v = _proj_qkv(p, kv_x, cfg)
        if rope is not None:
            q = apply_rope(q, *rope)
        mask = torch.ones((1, 1, s, k.shape[1]), dtype=torch.bool,
                          device=dev)
        out = _sdpa(q, k, v, mask, cfg)
        return _wo(p, out, cfg), None

    q, k, v = _proj_qkv(p, x, cfg)
    if rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)

    if mode == "train":
        mask = (causal_mask(s, s, 0, cfg.sliding_window, device=dev)
                if causal else torch.ones((1, 1, s, s), dtype=torch.bool,
                                          device=dev))
        out = _sdpa(q, k, v, mask, cfg)
        return _wo(p, out, cfg), None

    if mode == "prefill":
        if cache is None:
            raise ValueError("prefill needs a cache")
        if is_dtensor(k):    # the prompt's k/v, then zeros to s_max
            k_pad, v_pad = (torch.cat([t.to(c.dtype), t.new_zeros(
                (b, c.shape[1] - s) + tuple(t.shape[2:]), dtype=c.dtype)], 1)
                for t, c in ((k, cache.k), (v, cache.v)))
        else:
            k_pad = torch.zeros_like(cache.k)
            v_pad = torch.zeros_like(cache.v)
            k_pad[:, :s] = k.to(cache.k.dtype)
            v_pad[:, :s] = v.to(cache.v.dtype)
        k_pad = shard(k_pad, "batch", "kv_seq", "kv_heads", None)
        v_pad = shard(v_pad, "batch", "kv_seq", "kv_heads", None)
        mask = causal_mask(s, s, 0, cfg.sliding_window, device=dev)
        out = _sdpa(q, k, v, mask, cfg)
        return _wo(p, out, cfg), KVCache(k=k_pad, v=v_pad)

    if mode == "decode":
        if cache is None or pos is None:
            raise ValueError("decode needs a cache and positions")
        p_long = pos.long()
        if is_dtensor(cache.k):
            for c, new in ((cache.k, k), (cache.v, v)):
                _write_own_block(c, new, p_long)
        else:
            rows = torch.arange(b, device=dev)
            # no host sync: a position past the end rewrites the last slot
            # with its own old value
            slot = p_long.clamp(max=cache.k.shape[1] - 1)
            inside = (p_long < cache.k.shape[1])[:, None, None]
            for c, new in ((cache.k, k), (cache.v, v)):
                c[rows, slot] = torch.where(inside, new[:, 0].to(c.dtype),
                                            c[rows, slot])
        cache = KVCache(shard(cache.k, "batch", "kv_seq", "kv_heads", None),
                        shard(cache.v, "batch", "kv_seq", "kv_heads", None))
        # attend over positions <= pos (and window if set)
        ki = replicated(torch.arange(cache.k.shape[1], device=dev),
                        p_long)[None, None, None, :]
        mask = ki <= p_long[:, None, None, None]
        if cfg.sliding_window > 0:
            mask &= ki > (p_long[:, None, None, None] - cfg.sliding_window)
        out = _sdpa(q, cache.k, cache.v, mask, cfg)
        return _wo(p, out, cfg), cache

    raise ValueError(mode)


def _write_own_block(c, new, pos) -> None:
    """The decode write over ranks: ``new[:, 0]`` (B, kv, hd) into the
    DTensor cache ``c`` (B, S, kv, hd) at slot ``pos`` (B,) of each row.
    Each rank writes its own block of the cache in place: the slot where
    its block holds it, nothing elsewhere, and nothing is sent (``new``
    and ``pos`` take the cache's row placements, whole along the
    sequence).  An advanced index into a sequence sharded over ranks has
    no local meaning, and DTensor would gather the whole cache for it;
    the reference's where-mask over the sequence shards the same way."""
    from torch.distributed.tensor import Replicate, Shard
    s_all = c.shape[1]
    seq0, _ = block(c, 1)
    rows_only = tuple(Replicate() if p == Shard(1) else p
                      for p in c.placements)
    new = new.redistribute(placements=rows_only).to_local()
    pos = pos.redistribute(placements=tuple(
        p if p == Shard(0) else Replicate() for p in c.placements)).to_local()
    c = c.to_local()
    rows = torch.arange(c.shape[0], device=c.device)
    slot = pos - seq0
    inside = (pos < s_all) & (slot >= 0) & (slot < c.shape[1])
    slot = slot.clamp(min=0, max=c.shape[1] - 1)
    c[rows, slot] = torch.where(inside[:, None, None], new[:, 0].to(c.dtype),
                                c[rows, slot])


def _wo(p, out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    b, s, nq, h = out.shape
    flat = shard_merge(out, (b, s, nq * h), "batch", "seq", "heads", None)
    return shard(flat @ p["wo"].to(out.dtype), "batch", "seq", "embed")


def init_cache(cfg: ModelConfig, batch: int, s_max: int, n_kv: int,
               dtype=torch.bfloat16, device=None) -> KVCache:
    """Zeroed (batch, s_max, n_kv, head_dim) caches on ``device`` (default
    CUDA)."""
    dev = resolve_device(device)
    h = cfg.resolved_head_dim
    return KVCache(
        k=torch.zeros((batch, s_max, n_kv, h), dtype=dtype, device=dev),
        v=torch.zeros((batch, s_max, n_kv, h), dtype=dtype, device=dev))
