"""Mamba2 block — SSD (state-space duality) chunked algorithm.

Port of ``repro.models.ssm`` (plain torch: the reference has no kernel
here).  The SSD form computes the selective-SSM recurrence

    h_t = exp(dt_t·A) h_{t-1} + dt_t · B_t ⊗ x_t        (per head, state N)
    y_t = C_t · h_t + D · x_t

as chunked products: within a chunk the lower-triangular decay kernel
L = exp(segsum(dt·A)) turns the recurrence into attention-like
contractions; across chunks a loop carries the (H, P, N) state.

The reference's 3- and 4-operand einsums are pairwise products here, in
one fixed order (``torch.einsum`` would pick an order by ``opt_einsum``,
where it is installed), with B and C widened to float32 where ``jnp``
promotes them.  The reference repeats B and C from groups to heads; here
the products read each group once and broadcast it over its heads, which
are the same numbers.  ``ssd_scan_ref`` is the naive sequential oracle;
``mamba2_step`` is the O(1) decode update sharing the same parameters.

Over ranks (DTensors placed by the dry run's partitioner) the block takes
the reference's constraint on its output and cuts in_proj's output into
z, xBC and dt, and the conv's output into x, B and C, by one all-to-all
each (``sharding.split_last``); the conv, the SSD scan and the decode
recurrence run on each rank's own rows, heads and channels and send
nothing; on plain tensors every step is the one-device path.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import gated_rmsnorm, normal_init
from repro_torch.sharding import (is_dtensor, like, local, shard,
                                  shard_merge, shard_split, split_last)


class SSMState(NamedTuple):
    conv: torch.Tensor     # (B, W-1, conv_channels) rolling conv window
    ssm: torch.Tensor      # (B, H, P, N) recurrent state


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.ngroups * s.state_dim
    return s, d_in, nheads, conv_ch


def linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` (float32) bit for bit, on the
    CPU.  XLA folds the reference's ``start·(1 − i/div) + stop·i/div`` to
    ``start·(1 − i·c) + i·(stop·c)`` with c = float32(1/div) and contracts
    the last product and sum into one fused multiply-add; the float64 sum
    of the exact product i·(stop·c) (31 bits) and the rounded
    ``start·(1 − i·c)`` rounds once, as the FMA does."""
    s = torch.tensor(start, dtype=torch.float32)
    e = torch.tensor(stop, dtype=torch.float32)
    if num == 1:
        return s[None]
    c = torch.tensor(1.0, dtype=torch.float32) / (num - 1)
    i = torch.arange(num - 1, dtype=torch.float32)
    out = (i.double() * (e * c).double() + (s * (1 - i * c)).double())
    return torch.cat([out.float(), e[None]])


def head_leaves(nheads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A_log, dt_bias), float32 on the CPU: the reference's deterministic
    leaves, log of ``linspace(1, 16)`` and the inverse softplus of
    ``linspace(1e-3, 1e-1)`` clipped at 1e-4.  The linspaces equal the
    reference's bit for bit; ``torch.log``/``torch.expm1`` are not XLA's
    approximations and differ from them by up to an ulp on some heads
    (ROADMAP.md §3)."""
    a_log = torch.log(linspace_f32(1.0, 16.0, nheads))
    dt_bias = torch.log(torch.expm1(torch.clamp(
        linspace_f32(1e-3, 1e-1, nheads), min=1e-4)))
    return a_log, dt_bias


def mamba2_init(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    s, d_in, nheads, conv_ch = _dims(cfg)
    d = cfg.d_model
    dev = generator.device
    # in_proj emits [z (d_in), xBC (conv_ch), dt (nheads)]
    out_dim = d_in + conv_ch + nheads
    a_log, dt_bias = head_leaves(nheads)
    return {
        "in_proj": normal_init(generator, (d, out_dim), d ** -0.5, dtype),
        "conv_w": normal_init(generator, (s.conv_width, conv_ch),
                              s.conv_width ** -0.5, dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": a_log.to(dev),
        "D": torch.ones((nheads,), dtype=torch.float32, device=dev),
        "dt_bias": dt_bias.to(dev),
        "ssm_norm": torch.ones((d_in,), dtype=dtype, device=dev),
        "out_proj": normal_init(generator, (d_in, d), d_in ** -0.5, dtype),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0): max(x, 0) + log1p(exp(-|x|))
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L) decay exponents.

    seg[i, j] = sum_{t=j+1..i} x_t for j < i (the decay an input at j suffers
    before being read at i), 0 on the diagonal, -inf above (causality)."""
    seqlen = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    ones = torch.ones((seqlen, seqlen), dtype=torch.bool, device=x.device)
    mask = torch.tril(ones, diagonal=-1)
    diag = torch.eye(seqlen, dtype=torch.bool, device=x.device)
    zero = torch.zeros((), dtype=seg.dtype, device=x.device)
    return torch.where(mask, seg, torch.where(diag, zero,
                                              zero - float("inf")))


def ssd_chunked(
    xdt: torch.Tensor,    # (B, T, H, P)  — x already scaled by dt
    a_dt: torch.Tensor,   # (B, T, H)     — dt * A  (negative)
    bmat: torch.Tensor,   # (B, T, G, N)
    cmat: torch.Tensor,   # (B, T, G, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,   # (B, H, P, N) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. Returns (y (B,T,H,P), final state (B,H,P,N)), both
    float32.  Over ranks (DTensors: the batch split over data ranks, heads
    over model ranks, B and C whole along the heads' ranks) each rank runs
    it on its own blocks and nothing is sent: the scan is independent per
    row and head."""
    if is_dtensor(xdt):
        ops = [(a_dt, 2), (bmat, None), (cmat, None)]
        if h0 is not None:
            ops.append((h0, 1))
        _check_local(xdt, 2, ops, bmat.shape[2])
        y, st = ssd_chunked(*(local(t, xdt) for t in (xdt, a_dt, bmat,
                                                       cmat)), chunk,
                            None if h0 is None else local(h0, xdt))
        return like(y, xdt), like(st, xdt, _moved(xdt.placements,
                                                  {2: 1}))
    b, t, h, p = xdt.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if t % chunk:
        raise ValueError(f"chunk {chunk} does not divide T = {t}")
    c = t // chunk
    rep = h // g
    x_ = xdt.float().reshape(b, c, chunk, g, rep, p)
    a_ = torch.movedim(a_dt.float().reshape(b, c, chunk, h), -1, 2)
    b_ = bmat.float().reshape(b, c, chunk, g, n)
    c_ = cmat.float().reshape(b, c, chunk, g, n)

    a_cs = torch.cumsum(a_, dim=-1)                       # (B, C, H, L)
    # 1. intra-chunk (diagonal) term: ((C·Bᵀ) ∘ L) · X
    lmat = torch.exp(_segsum(a_)).reshape(b, c, g, rep, chunk, chunk)
    cb = torch.einsum("bclgn,bcsgn->bcgls", c_, b_)       # (B, C, G, L, S)
    y_diag = torch.einsum("bcgrls,bcsgrp->bclgrp", cb[:, :, :, None] * lmat,
                          x_)
    # 2. per-chunk final states: (X ∘ decay) · B
    decay = torch.exp(a_cs[..., -1:] - a_cs)              # (B, C, H, L)
    xd = x_ * torch.movedim(decay, 2, 3).reshape(b, c, chunk, g, rep)[
        ..., None]
    states = torch.einsum("bclgrp,bclgn->bcgrpn", xd, b_).reshape(
        b, c, h, p, n)
    # 3. inter-chunk recurrence; like the reference's scan, it keeps each
    # chunk's incoming state
    chunk_decay = torch.exp(a_cs[..., -1])                # (B, C, H)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32,
                         device=xdt.device) if h0 is None else h0.float())
    prev = []
    for i in range(c):
        prev.append(state)
        state = state * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1).reshape(b, c, g, rep, p, n)
    # 4. state -> output within each chunk: (C · state) ∘ decay
    state_decay = torch.exp(a_cs)                         # (B, C, H, L)
    y_off = torch.einsum("bclgn,bcgrpn->bclgrp", c_, prev_states)
    y_off = y_off * torch.movedim(state_decay, 2, 3).reshape(
        b, c, chunk, g, rep)[..., None]
    y = (y_diag + y_off).reshape(b, t, h, p)
    return y, state


def ssd_scan_ref(xdt, a_dt, bmat, cmat, h0=None):
    """Naive sequential oracle for property tests."""
    b, t, h, p = xdt.shape
    g, n = bmat.shape[2], bmat.shape[3]
    rep = h // g
    bh = torch.repeat_interleave(bmat, rep, dim=2).float()
    ch = torch.repeat_interleave(cmat, rep, dim=2).float()
    state = (torch.zeros((b, h, p, n), dtype=torch.float32,
                         device=xdt.device) if h0 is None else h0.float())
    ys = []
    for i in range(t):
        state = (state * torch.exp(a_dt[:, i].float())[..., None, None]
                 + xdt[:, i].float()[..., None] * bh[:, i, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, i]))
    return torch.stack(ys, dim=1), state


def _split_proj(p, x: torch.Tensor, cfg: ModelConfig):
    """z (..., d_in), xBC (..., conv_ch) and dt (..., H) of ``in_proj``'s
    output.  Over ranks each is split over ``model`` on its own
    (``sharding.split_last``: the blocks of in_proj's output on the model
    ranks do not end where the three pieces do)."""
    s, d_in, nheads, conv_ch = _dims(cfg)
    z_xbc_dt = x @ p["in_proj"].to(x.dtype)
    lead = ("batch", "seq")[:x.ndim - 1]
    return split_last(z_xbc_dt, (d_in, conv_ch, nheads), lead,
                      ("mlp", "mlp", "heads"))


def _conv_full(p, xbc: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, T, C) with static width: the
    ``width`` shifted products summed from 0 in the order i = 0..W−1, as
    the reference's ``sum``.  Over ranks each rank convolves its own rows
    and channels (the conv weights split as the channels are); nothing is
    sent."""
    if is_dtensor(xbc):
        return like(_conv_full({k: local(p[k], xbc)
                                for k in ("conv_w", "conv_b")},
                               xbc.to_local()), xbc)
    w = p["conv_w"].float()                               # (W, C)
    width = w.shape[0]
    x = xbc.float()
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + x.shape[1]] * w[i] for i in range(width))
    return F.silu(out + p["conv_b"].float()).to(xbc.dtype)


def _heads(xbc: torch.Tensor, cfg: ModelConfig):
    """x (..., H, P), B and C (..., G, N) of the conv's output: over
    ranks x split over ``model`` by heads, B and C whole along it."""
    s, d_in, nheads, _ = _dims(cfg)
    gn = s.ngroups * s.state_dim
    lead = tuple(xbc.shape[:-1])
    names = ("batch", "seq")[:len(lead)]
    xs, bmat, cmat = split_last(xbc, (d_in, gn, gn), names,
                                ("heads", None, None))
    return (shard_split(xs, lead + (nheads, s.head_dim), *names, "heads",
                        None),
            shard_split(bmat, lead + (s.ngroups, s.state_dim), *names, None,
                        None),
            shard_split(cmat, lead + (s.ngroups, s.state_dim), *names, None,
                        None))


def _check_local(xh, head_dim: int, others, ngroups: int) -> None:
    """The SSM's operands over ranks, for a run on each rank's own blocks:
    ``xh`` split over each mesh dim by the batch (dim 0), by heads (dim
    ``head_dim``) or not at all, and each of ``others`` ((tensor, its
    heads dim or None) pairs; None for B and C, whose one group every
    rank reads whole) placed alike; no partial sums."""
    from torch.distributed.tensor import Replicate, Shard
    for m, p in enumerate(xh.placements):
        if not (p == Replicate() or p.is_shard(0) or p.is_shard(head_dim)):
            raise ValueError(f"the SSM's x is placed {xh.placements}")
        if p.is_shard(head_dim) and ngroups != 1:
            raise NotImplementedError("heads split over ranks with several "
                                      "B/C groups")
        for t, hd in others:
            want = (Shard(0) if p.is_shard(0) else
                    Shard(hd) if p.is_shard(head_dim) and hd is not None
                    else Replicate())
            if not is_dtensor(t) or t.device_mesh != xh.device_mesh \
                    or t.placements[m] != want:
                raise ValueError(f"the SSM's operands are not placed alike "
                                 f"on mesh dim {m} (x: {xh.placements})")


def _moved(placements, dims):
    """``placements`` with each ``Shard(i)`` of ``dims`` (i -> j) moved to
    ``Shard(j)``."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(dims[p.dim]) if p.is_shard() and p.dim in dims
                 else p for p in placements)


def mamba2_forward(
    p, x: torch.Tensor, cfg: ModelConfig,
    state: Optional[SSMState] = None, return_state: bool = False,
) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """Full-sequence Mamba2 block. x (B, T, d) -> (B, T, d).  The chunk is
    the largest divisor of T that divides the config's (the reference's
    ``gcd``): a T prime to it runs chunks of 1."""
    s, d_in, nheads, conv_ch = _dims(cfg)
    b, t, _ = x.shape
    z, xbc_raw, dt = _split_proj(p, x, cfg)
    xbc = _conv_full(p, xbc_raw)
    xh, bmat, cmat = _heads(xbc, cfg)
    dt = _softplus(dt.float() + p["dt_bias"].float())     # (B,T,H)
    a = -torch.exp(p["A_log"].float())                    # (H,)
    xdt = xh.float() * dt[..., None]
    a_dt = dt * a[None, None, :]
    chunk = math.gcd(t, s.chunk)
    h0 = state.ssm if state is not None else None
    y, hfinal = ssd_chunked(xdt, a_dt, bmat, cmat, chunk, h0=h0)
    y = y + p["D"].float()[None, None, :, None] * xh.float()
    y = shard_merge(y, (b, t, d_in), "batch", "seq", "heads",
                    None).to(x.dtype)
    y = gated_rmsnorm(p["ssm_norm"], y, z, cfg.norm_eps)
    out = shard(y @ p["out_proj"].to(x.dtype), "batch", "seq", "embed")
    if not return_state:
        return out, None
    # keep the last W-1 raw (pre-conv) xbc inputs for decode continuation
    # (xbc_raw is in x's dtype; over ranks each rank its own channels)
    take = min(s.conv_width - 1, t)
    conv_tail = torch.cat([xbc_raw.new_zeros(
        (b, s.conv_width - 1 - take, conv_ch)), xbc_raw[:, t - take:]],
        dim=1)
    return out, SSMState(conv=conv_tail, ssm=hfinal)


def mamba2_step(
    p, x: torch.Tensor, cfg: ModelConfig, state: SSMState,
) -> Tuple[torch.Tensor, SSMState]:
    """O(1) decode step. x (B, 1, d) -> (B, 1, d).  Returns new state
    tensors and leaves ``state`` as it was.  As in the reference, the
    conv's output stays float32 here (the full forward casts it to the
    compute dtype)."""
    s, d_in, nheads, conv_ch = _dims(cfg)
    b = x.shape[0]
    z, xbc, dt = _split_proj(p, x, cfg)                   # (B,1,·)
    window = torch.cat([state.conv, xbc.to(state.conv.dtype)], dim=1)
    # the window contracted with the conv weights in one product (over
    # ranks on each rank's own rows and channels)
    conv_out = like(torch.einsum("bwc,wc->bc", local(window, window).float(),
                                 local(p["conv_w"], window).float()),
                    window, _moved(getattr(window, "placements", ()),
                                   {2: 1}))
    xbc1 = F.silu(conv_out + p["conv_b"].float())
    xh, bvec, cvec = _heads(xbc1, cfg)
    dt1 = _softplus(dt[:, 0].float() + p["dt_bias"].float())   # (B,H)
    a = -torch.exp(p["A_log"].float())
    if is_dtensor(xh):  # over ranks: each rank its own rows and heads
        _check_local(xh, 1, [(dt1, 1), (state.ssm, 1), (bvec, None),
                             (cvec, None)], s.ngroups)
    y, h_new = _step_update(*(local(t, xh) for t in (
        xh, dt1, a, p["D"], state.ssm, bvec, cvec)))
    y, h_new = like(y, xh), like(h_new, state.ssm)
    y = shard_merge(y, (b, d_in), "batch", "heads", None)[:, None]
    y = gated_rmsnorm(p["ssm_norm"], y.to(x.dtype), z, cfg.norm_eps)
    out = shard(y @ p["out_proj"].to(x.dtype), "batch", "seq", "embed")
    return out, SSMState(conv=window[:, 1:], ssm=h_new)


def _step_update(xh, dt1, a, d, ssm, bvec, cvec):
    """The recurrence of one decode step: (y (B, H, P), h' (B, H, P, N))
    from x (B, H, P), dt (B, H), A and D (H,), h (B, H, P, N) and B, C
    (B, G, N) repeated from groups to heads."""
    rep = xh.shape[1] // bvec.shape[1]
    bh = torch.repeat_interleave(bvec, rep, dim=1)        # (B, H, N)
    ch = torch.repeat_interleave(cvec, rep, dim=1)
    xh = xh.float()
    da = torch.exp(dt1 * a[None, :])                      # (B,H)
    h_new = (ssm * da[..., None, None]
             + (xh * dt1[..., None])[..., None] * bh[:, :, None, :])
    y = (h_new @ ch[..., None])[..., 0]                   # (B, H, P)
    return y + d.float()[None, :, None] * xh, h_new


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                   device=None) -> SSMState:
    """A zero state on ``device`` (default CUDA)."""
    s, d_in, nheads, conv_ch = _dims(cfg)
    dev = resolve_device(device)
    return SSMState(
        conv=torch.zeros((batch, s.conv_width - 1, conv_ch), dtype=dtype,
                         device=dev),
        ssm=torch.zeros((batch, nheads, s.head_dim, s.state_dim),
                        dtype=torch.float32, device=dev))
