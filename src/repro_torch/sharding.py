"""Logical-axis sharding rules.  Port of ``repro.sharding``.

Models name the axes of their tensors *logically*; a rule set maps those
names to mesh axes per parallelism style:

    batch   -> ("pod", "data")     DP across pods, DP/FSDP within
    embed   -> "data"              FSDP parameter sharding (ZeRO-3 style)
    heads/mlp/vocab -> "model"     tensor parallelism (Megatron style)
    expert  -> "model"             expert parallelism for MoE
    kv_seq  -> "model"             context parallelism for long KV caches

A logical axis is dropped (replicated) when the tensor dimension is not
divisible by the mesh axis size, as in the reference.

The mesh is the port's :class:`~repro_torch.core.distributed.SearchMesh`,
and a spec is a plain tuple with the entries of the reference's
``PartitionSpec`` (a mesh axis name, a tuple of names, or None).
:func:`shard` is the reference's constraint: on a DTensor of the active
mesh over ranks (the dry run's partitioner: parameters placed by
:func:`param_shardings`) it redistributes, value and gradient, to the
spec's placements; on a plain tensor, or a lanes-only mesh, it returns
its input.  :func:`shard_split` and :func:`shard_merge` are the
constraints around a reshape that splits or merges a sharded dim, and
the helpers below them (:func:`unshard`, :func:`repeat_heads`,
:func:`vocab_lookup`, :func:`arange_like`, :func:`replicated`,
:func:`like`, :func:`local`, :func:`split_last`) take the places where
DTensor has no rule of its own, or one that would gather more than XLA
does.  ``use_rules``'s mesh is what
``models.moe_a2a.moe_ffn_sharded`` splits its positions by (lanes of one
device, or ranks).  :func:`param_shardings` is
the reference's ``NamedSharding`` tree on a mesh laid over ranks: each
leaf's spec as DTensor placements on the mesh's ``DeviceMesh``
(``Shard(i)`` on the mesh dims that split tensor dim i, ``Replicate()`` on
the others), which :func:`place` applies and which the MoE's FSDP gather
reads.  On a lanes-only mesh, whose positions all sit on one device, it
raises, naming that entry of ROADMAP.md §1 item 8.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import re
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.treepath import keystr_simple, tree_map_with_path

try:
    from torch.distributed.tensor import DTensor as _DTensor
except ImportError:         # a torch without distributed support
    _DTensor = None

__all__ = ["ACT_RULES", "DEFAULT_RULES", "PARAM_RULES", "RankSharding",
           "current_mesh", "keystr_simple", "param_shardings", "param_specs",
           "place", "resolve_spec", "shard", "sharding_for", "spec_for_path",
           "use_rules", "whole"]

# logical axis -> mesh axis (or tuple of mesh axes)
Rules = Dict[str, object]
Spec = Tuple[object, ...]

# Parameter / persistent-state rules ("data", "model") or ("pod", "data",
# "model") mesh: FSDP shards the embed dim of WEIGHTS over "data".
DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "embed": "data",          # FSDP (weights + optimizer state + caches)
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "kv_seq": "model",        # context-parallel KV cache (decode)
    "seq": None,
    "capacity": None,
    "state": None,
    "conv": None,
    "head_dim": None,
    "frames": None,
    "layers": None,           # scan-stacked leading axis, never sharded
}

# Activation rules: the embed dim of ACTIVATIONS stays replicated (batch owns
# "data"); tensor-parallel dims (heads/mlp/vocab/expert) shard over "model".
ACT_RULES: Rules = dict(DEFAULT_RULES, embed=None)

_active_rules: contextvars.ContextVar[Rules] = contextvars.ContextVar(
    "rules", default=DEFAULT_RULES)
_active_act_rules: contextvars.ContextVar[Rules] = contextvars.ContextVar(
    "act_rules", default=ACT_RULES)
_active_mesh: contextvars.ContextVar = contextvars.ContextVar(
    "mesh", default=None)


@contextlib.contextmanager
def use_rules(rules: Rules, mesh=None, act_rules: Optional[Rules] = None):
    """Make ``rules`` (and ``mesh``, a ``SearchMesh`` or None) the active
    ones inside the block."""
    t1 = _active_rules.set(rules)
    t2 = _active_mesh.set(mesh)
    t3 = _active_act_rules.set(
        act_rules if act_rules is not None else dict(rules, embed=None))
    try:
        yield
    finally:
        _active_rules.reset(t1)
        _active_mesh.reset(t2)
        _active_act_rules.reset(t3)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh inside the block; the rules stay."""
    token = _active_mesh.set(mesh)
    try:
        yield
    finally:
        _active_mesh.reset(token)


def remat_context():
    """``context_fn`` for ``torch.utils.checkpoint``: the forward runs as it
    is, the recompute under the rules and mesh active at the forward (the
    autograd engine may run the recompute on a thread of its own, where
    the context variables are unset)."""
    return contextlib.nullcontext(), use_rules(
        _active_rules.get(), _active_mesh.get(), _active_act_rules.get())


def current_mesh():
    """The mesh of the enclosing ``use_rules``, else None."""
    return _active_mesh.get()


def _mesh_axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= _mesh_axis_size(mesh, a)
        return n
    return dict(mesh.shape).get(axis, 1)


def resolve_spec(shape: Sequence[int], logical: Sequence[Optional[str]],
                 mesh=None, rules: Optional[Rules] = None) -> Spec:
    """Map logical axes to a spec tuple, dropping non-divisible axes."""
    rules = rules or _active_rules.get()
    mesh = mesh or _active_mesh.get()
    out = []
    used: set = set()   # a mesh axis may shard at most one dim per spec
    for dim, name in zip(shape, logical):
        axis = rules.get(name) if name else None
        if axis is None or mesh is None:
            # no rule, or no mesh to validate divisibility against
            out.append(axis)
            continue
        # drop mesh axes that are absent, already used, or don't divide
        if isinstance(axis, (tuple, list)):
            kept = []
            rem = dim
            for a in axis:
                s = _mesh_axis_size(mesh, a)
                if s > 1 and rem % s == 0 and a not in used:
                    kept.append(a)
                    used.add(a)
                    rem //= s
            out.append(tuple(kept) if len(kept) > 1 else
                       (kept[0] if kept else None))
        else:
            s = _mesh_axis_size(mesh, axis)
            ok = s > 1 and dim % s == 0 and axis not in used
            if ok:
                used.add(axis)
            out.append(axis if ok else None)
    return tuple(out)


def rank_mesh():
    """The active mesh when it is laid over ranks, else None."""
    mesh = _active_mesh.get()
    return mesh if getattr(mesh, "over_ranks", False) else None


def is_dtensor(x) -> bool:
    return _DTensor is not None and isinstance(x, _DTensor)


def shard(x, *logical: Optional[str]):
    """The reference's sharding constraint on an intermediate (its
    ``with_sharding_constraint`` under the activation rules).  On a
    DTensor of the active mesh over ranks, ``x`` is redistributed to the
    placements of ``resolve_spec(x.shape, logical)`` (axes that do not
    divide are dropped, as the reference drops them): a ``Partial`` sum
    is reduced there, as GSPMD reduces it at the constraint.  In every
    other case (a plain tensor, a lanes-only mesh, no mesh) ``x`` comes
    back as it is."""
    mesh = rank_mesh()
    if mesh is None or not is_dtensor(x) \
            or x.device_mesh != mesh.device_mesh:
        return x
    spec = resolve_spec(tuple(x.shape), logical, mesh,
                        _active_act_rules.get())
    return _constrain(x, _placements(spec, mesh.axis_names))


class _Constrain(torch.autograd.Function):
    """A sharding constraint as GSPMD reads one: the value takes the
    placements, and so does its gradient (the cotangent of
    ``with_sharding_constraint`` is constrained alike), or, for a gather
    (``back`` the input's placements), the gradient goes back split as
    the input was (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, placements, back):
        ctx.back = back
        return x.redistribute(placements=placements)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.back:
            g = g.redistribute(placements=ctx.back)
        return g, None, None


def _constrain(x, placements, back=None):
    if tuple(x.placements) == placements and not x.requires_grad:
        return x
    return _Constrain.apply(x, placements,
                            placements if back is None else back)


def shard_split(x, shape, *logical: Optional[str], whole_on=None):
    """``shard(x.reshape(shape), *logical)``, where the reshape splits one
    dim i of ``x`` into several and ``logical`` (the result's axes) shards
    no dim past i, so each sharded dim keeps its index.  On a DTensor of
    the active mesh over ranks, ``x`` takes the result's placements
    before the reshape and the gradient after it, so neither view splits
    a dim unevenly (which DTensor refuses); elsewhere it is
    ``x.reshape``.  ``whole_on`` (a flag a mesh dim) keeps the result
    whole on the flagged mesh dims."""
    return _reshaped(x, shape, shape, logical, whole_on)


def shard_merge(x, shape, *logical: Optional[str]):
    """``x.reshape(shape)`` merging dims i.. of ``x`` into one, with ``x``
    constrained to ``logical`` (its own axes, none sharded past i): the
    merged dim is split where dim i is.  On a DTensor of the active mesh
    over ranks the result and its gradient take those placements, so the
    gradient's view back to ``x``'s shape splits no dim unevenly;
    elsewhere it is ``x.reshape``."""
    return _reshaped(x, shape, tuple(x.shape), logical)


def _reshaped(x, shape, spec_shape, logical, whole_on=None):
    mesh = rank_mesh()
    if mesh is None or not is_dtensor(x) \
            or x.device_mesh != mesh.device_mesh:
        return x.reshape(shape)
    spec = resolve_spec(tuple(spec_shape), logical, mesh,
                        _active_act_rules.get())
    placements = _placements(spec, mesh.axis_names)
    if whole_on is not None:
        from torch.distributed.tensor import Replicate
        placements = tuple(Replicate() if w else p
                           for p, w in zip(placements, whole_on))
    return _canonical(_constrain(_constrain(x, placements).reshape(shape),
                                 placements))


def _canonical(x):
    """``x`` with the row-major strides of its shape.  A DTensor's strides
    follow its local tensor's, whose size-1 dims may carry any stride
    (another on the meta device than on a card), and a product folds a
    3-D operand into one 2-D matmul only on row-major strides (the plain
    path's reshape gives them); the same ops on every device."""
    want, step = [], 1
    for size in reversed(x.shape):
        want.append(step)
        step *= size
    want = tuple(reversed(want))
    from torch.distributed.tensor import DTensor
    local = x.to_local()
    return DTensor.from_local(local.contiguous(), x.device_mesh,
                              x.placements, run_check=False,
                              shape=x.shape, stride=want)


def unshard(x, *axes: str):
    """The DTensor ``x`` whole along the mesh axes ``axes`` (an all-gather
    over each that splits it: FSDP's gather of a weight), as it is along
    the others; anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    names = x.device_mesh.mesh_dim_names
    placements = tuple(Replicate() if n in axes else p
                       for n, p in zip(names, x.placements))
    return _constrain(x, placements, tuple(x.placements))


def repeat_heads(kv, q, groups: int):
    """GQA's expansion on DTensors: ``kv`` (B, S, H_kv, D), whole along
    its heads, with each head repeated ``groups`` times, split over ranks
    as ``q``'s heads are (each rank repeats its rows' kv heads and keeps
    the block of q's heads it holds: nothing is sent).  The gradient of
    ``kv`` is a partial sum over those ranks, reduced where it is next
    read whole.  Without it a q whose heads split over ranks, beside kv
    heads that do not, would be gathered and every rank would compute
    every head."""
    from torch.distributed.tensor import DTensor, Partial
    split = tuple(p.is_shard(2) for p in q.placements)
    local = kv.to_local(grad_placements=tuple(
        Partial() if s else p for s, p in zip(split, kv.placements)))
    offset, size = block(q, 2)
    rows = local.repeat_interleave(groups, dim=2)[:, :, offset:offset + size]
    return DTensor.from_local(rows, q.device_mesh, tuple(
        qp if s else p for s, qp, p in zip(split, q.placements,
                                           kv.placements)),
        run_check=False)


def block(x, dim: int) -> Tuple[int, int]:
    """(offset, size) of this rank's block of the DTensor ``x`` along dim
    ``dim`` (:func:`span`)."""
    dim %= x.ndim
    return span(x.shape[dim], x.device_mesh, x.placements, dim)


def span(n: int, mesh, placements, dim: int) -> Tuple[int, int]:
    """(offset, size) of this rank's block of a dim of ``n`` elements
    (tensor dim ``dim``) placed by ``placements`` on ``mesh``: the mesh
    dims that split it, in mesh order, each split the previous one's
    block evenly (``resolve_spec`` keeps only axes that divide).  Plain
    arithmetic: DTensor's own helper runs tensor ops."""
    coord = mesh.get_coordinate()
    size, offset = n, 0
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            size //= mesh.size(i)
            offset += coord[i] * size
    return offset, size


def spec_placements(shape, *logical: Optional[str]):
    """The placements ``shard(x, *logical)`` gives a tensor of ``shape``
    on the active mesh over ranks (None without one)."""
    mesh = rank_mesh()
    if mesh is None:
        return None
    return _placements(resolve_spec(tuple(shape), logical, mesh,
                                    _active_act_rules.get()),
                       mesh.axis_names)


def sum_parts(part, mesh, split, placements):
    """``part``, this rank's share of a sum over the mesh dims flagged in
    ``split``, as a DTensor placed by ``placements`` on the others and
    whole over those (one all-reduce); the gradient of each part is the
    whole gradient."""
    from torch.distributed.tensor import Partial, Replicate
    return _SumParts.apply(
        part, mesh,
        tuple(Partial() if s else p for s, p in zip(split, placements)),
        tuple(Replicate() if s else p for s, p in zip(split, placements)))


def vocab_lookup(table, ids):
    """The rows ``table[ids]`` of a DTensor table (V, d), whole along d,
    for DTensor ids (B, S), on each rank's own rows of ids.  A table whole
    along V is indexed as the plain path indexes it.  One whose vocab dim
    is split over ranks: each rank looks up the ids its block holds, zeros
    elsewhere, and one all-reduce over the vocab's ranks adds the parts
    (the rows come back whole over those ranks, and each rank's part
    takes the whole gradient).  DTensor has no rule for ``aten.index``,
    and its ``embedding`` rule's mask makes device-dependent ops."""
    from torch.distributed.tensor import Partial, Replicate
    split = tuple(p.is_shard(0) for p in table.placements)
    ids = ids.long().redistribute(placements=tuple(
        Replicate() if s else p for s, p in zip(split, ids.placements)))
    # the table's gradient from this rank's rows alone: a partial sum over
    # the ranks that split the rows
    local_table = table.to_local(grad_placements=tuple(
        Partial() if i.is_shard() else t
        for i, t in zip(ids.placements, table.placements)))
    if not any(split):      # the plain path's own gather
        return like(local_table[ids.to_local()], ids)
    offset, size = block(table, 0)
    local = ids.to_local() - offset
    inside = (local >= 0) & (local < size)
    rows = torch.nn.functional.embedding(
        local.clamp(min=0, max=size - 1), local_table)
    rows = rows * inside[..., None].to(rows.dtype)
    return sum_parts(rows, table.device_mesh, split, ids.placements)


class _SumParts(torch.autograd.Function):
    """This rank's part of a sum over ranks (``partial`` placements) as a
    DTensor reduced to ``whole``; the gradient of each part is the whole
    gradient (DTensor's own ``from_local`` would split it over the
    parts)."""

    @staticmethod
    def forward(ctx, part, mesh, partial, whole):
        from torch.distributed.tensor import DTensor
        ctx.whole = whole
        return DTensor.from_local(part, mesh, partial,
                                  run_check=False).redistribute(
            placements=whole)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != tuple(ctx.whole):
            g = g.redistribute(placements=ctx.whole)
        return g.to_local(), None, None, None


def sharded_dim(x, dim: int) -> bool:
    """Whether ``x`` is a DTensor whose dim ``dim`` is split over ranks."""
    if not is_dtensor(x):
        return False
    dim %= x.ndim
    return any(p.is_shard(dim) for p in x.placements)


def arange_like(x, dim: int):
    """``torch.arange(x.shape[dim])`` on ``x``'s device; on a DTensor laid
    out as ``x``'s dim ``dim`` (each rank the ids of its own block of it,
    whole on the mesh dims that do not split it)."""
    n = x.shape[dim]
    if not is_dtensor(x):
        return torch.arange(n, device=x.device)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dim %= x.ndim
    placements = tuple(Shard(0) if p.is_shard(dim) else Replicate()
                       for p in x.placements)
    offset, size = block(x, dim)
    local = torch.arange(offset, offset + size, device=x.to_local().device)
    return DTensor.from_local(local, x.device_mesh, placements,
                              run_check=False)


def replicas(x) -> int:
    """How many ranks hold each element of the DTensor ``x`` (the product
    of the mesh dims it is replicated over)."""
    from torch.distributed.tensor import Replicate
    return math.prod(x.device_mesh.size(i)
                     for i, p in enumerate(x.placements)
                     if isinstance(p, Replicate))


def replicated(t, ref):
    """``t``, a plain tensor that every rank computes whole, as a
    replicated DTensor on ``ref``'s mesh when ``ref`` is a DTensor, else
    ``t`` as it is (an index, a mask or a table that a DTensor op takes
    beside ``ref``)."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def like(local, ref, placements=None):
    """``local``, this rank's block of a tensor laid out as ``ref`` (the
    same placements, or ``placements`` on ``ref``'s mesh, and the sharded
    dims sized as its local part), as a DTensor when ``ref`` is one, else
    ``local`` itself."""
    if not is_dtensor(ref):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, ref.device_mesh,
                              ref.placements if placements is None
                              else placements, run_check=False)


def local(t, ref):
    """This rank's block of the DTensor ``t``, read beside the activation
    ``ref`` by a computation on each rank's own blocks: its gradient is a
    partial sum over the mesh dims that split ``ref`` and not ``t`` (each
    rank adds the part of its own rows or heads).  Anything else comes
    back as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Partial
    return t.to_local(grad_placements=tuple(
        Partial() if r.is_shard() and not p.is_shard() else p
        for p, r in zip(t.placements, ref.placements)))


def split_last(x, sizes: Sequence[int], lead: Sequence[Optional[str]],
               names: Sequence[Optional[str]]):
    """``x`` (..., N) cut along its last dim into consecutive pieces of
    ``sizes``, piece i laid out as ``shard(piece, *lead, names[i])``, after
    ``x`` itself takes ``shard(x, *lead, "mlp")`` (a partial sum
    reduced).

    A plain tensor's pieces are its slices.  A DTensor whose last dim is
    split over a mesh dim, in blocks whose bounds are not the pieces'
    (mamba2's in_proj output: z | xBC | dt), is cut by one all-to-all over
    that dim: each rank sends every other rank the columns of its block
    that the other's pieces take (a piece split over the dim: that rank's
    block of it; a piece whole along it: all of it), and nothing else.
    DTensor's own slice would gather the whole of ``x`` on every rank.
    The gradient goes back the same way (a whole piece's gradient, whole
    on every rank, is taken from the rank's own copy)."""
    bounds = [0]
    for s in sizes:
        bounds.append(bounds[-1] + s)
    if bounds[-1] != x.shape[-1]:
        raise ValueError(f"pieces of {tuple(sizes)} do not cut a last dim "
                         f"of {x.shape[-1]}")
    if not is_dtensor(x):
        return [x[..., a:b] for a, b in zip(bounds, bounds[1:])]
    last = x.ndim - 1
    want = [spec_placements(tuple(x.shape[:-1]) + (s,), *lead, n)
            for s, n in zip(sizes, names)]
    if None in want or rank_mesh().device_mesh != x.device_mesh:
        raise ValueError("split_last: a DTensor is cut on the active mesh "
                         "over ranks (use_rules)")
    x = shard(x, *lead, "mlp")
    split = [k for k, p in enumerate(x.placements) if p.is_shard(last)]
    if not split:           # every rank holds every column: cut locally
        return [_constrain(x[..., a:b], w)
                for a, b, w in zip(bounds, bounds[1:], want)]
    if len(split) > 1 or any(p.is_partial() for p in x.placements):
        raise NotImplementedError(
            f"split_last: a last dim split over several mesh dims, or a "
            f"partial sum ({x.placements})")
    k = split[0]
    mesh = x.device_mesh
    whole = [not w[k].is_shard() for w in want]
    plan = _cut_plan(bounds, whole, mesh.size(k), mesh.get_local_rank(k))
    outs = _Cut.apply(x.to_local(), plan, mesh.get_group(k))
    from torch.distributed.tensor import Replicate, Shard
    return [_constrain(like(o, x, tuple(
        (Replicate() if w_ else Shard(last)) if m == k else p
        for m, p in enumerate(x.placements))), w)
            for o, w_, w in zip(outs, whole, want)]


class _CutPlan(NamedTuple):
    send: list          # per destination: the local columns sent, in order
    recv: list          # per source: how many columns come from it
    order: list         # the received columns' positions, piece by piece
    sizes: list         # each piece's local width
    back: list          # per destination: the local columns of split pieces
    back_recv: list     # per source: the split pieces' columns from it
    back_order: list    # where each such column lands in this rank's block
    own: list           # (piece, piece column, block column) of whole pieces


def _cut_plan(bounds, whole, r: int, j: int) -> _CutPlan:
    """:func:`split_last`'s all-to-all over ``r`` ranks, for rank ``j``:
    plain column arithmetic (the same on every rank)."""
    c = bounds[-1] // r

    def needs(t):               # (piece, first, end) columns rank t takes
        out = []
        for i, (a, b) in enumerate(zip(bounds, bounds[1:])):
            w = (b - a) // r
            out.append((i, a, b) if whole[i] else
                       (i, a + t * w, a + (t + 1) * w))
        return out

    def cols(t, src, split_only=False):   # columns t takes from src's block
        return [col for i, lo, hi in needs(t)
                if not (split_only and whole[i])
                for col in range(max(lo, src * c), min(hi, (src + 1) * c))]
    send = [[col - j * c for col in cols(t, j)] for t in range(r)]
    got = [col for src in range(r) for col in cols(j, src)]
    at = {col: n for n, col in enumerate(got)}
    mine = needs(j)
    order = [at[col] for _, lo, hi in mine for col in range(lo, hi)]
    sizes = [hi - lo for _, lo, hi in mine]
    # backward: split pieces' gradients return to the columns' owners; a
    # whole piece's gradient is whole on every rank
    back = [[sum(sizes[:i]) + col - lo for i, lo, hi in mine
             if not whole[i] for col in range(max(lo, t * c),
                                              min(hi, (t + 1) * c))]
            for t in range(r)]
    back_got = [col - j * c for src in range(r)
                for col in cols(src, j, split_only=True)]
    own = [(i, col - lo, col - j * c) for i, lo, hi in needs(j) if whole[i]
           for col in range(max(lo, j * c), min(hi, (j + 1) * c))]
    return _CutPlan(send, [len(cols(j, s)) for s in range(r)], order, sizes,
                    back, [len(cols(s, j, True)) for s in range(r)],
                    back_got, own)


def _all_to_all_rows(t, out_rows, in_rows, group):
    """``t``'s rows (dim 0) in blocks of ``in_rows`` sent to the group's
    ranks in order, the blocks of ``out_rows`` received from them."""
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_to_all_single(
        t.contiguous(), list(out_rows), list(in_rows), group))


class _Cut(torch.autograd.Function):
    """:func:`split_last`'s move on this rank's block (..., c)."""

    @staticmethod
    def forward(ctx, x, plan: _CutPlan, group):
        ctx.plan, ctx.group, ctx.shape = plan, group, x.shape
        rows = x.movedim(-1, 0)
        idx = torch.tensor([col for s in plan.send for col in s],
                           dtype=torch.long, device=x.device)
        got = _all_to_all_rows(rows.index_select(0, idx), plan.recv,
                               [len(s) for s in plan.send], group)
        got = got.index_select(0, torch.tensor(plan.order, dtype=torch.long,
                                               device=x.device))
        return tuple(p.movedim(0, -1).contiguous()
                     for p in got.split(plan.sizes))

    @staticmethod
    def backward(ctx, *grads):
        plan, dev = ctx.plan, grads[0].device
        rows = torch.cat([g.movedim(-1, 0) for g in grads])
        offsets = [sum(plan.sizes[:i]) for i in range(len(plan.sizes))]
        idx = torch.tensor([col for s in plan.back for col in s],
                           dtype=torch.long, device=dev)
        got = _all_to_all_rows(rows.index_select(0, idx), plan.back_recv,
                               [len(s) for s in plan.back], ctx.group)
        g = rows.new_zeros((ctx.shape[-1],) + tuple(rows.shape[1:]))
        g.index_copy_(0, torch.tensor(plan.back_order, dtype=torch.long,
                                      device=dev), got)
        if plan.own:
            g.index_copy_(0, torch.tensor([b for _, _, b in plan.own],
                                          dtype=torch.long, device=dev),
                          rows.index_select(0, torch.tensor(
                              [offsets[i] + col for i, col, _ in plan.own],
                              dtype=torch.long, device=dev)))
        return g.movedim(0, -1), None, None


# ---------------------------------------------------------------------------
# Parameter specs by path convention
# ---------------------------------------------------------------------------

# Regexes over "/"-joined tree paths -> logical axes (excluding any leading
# scan-stacked "layers" dim, which is detected by rank mismatch).
PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"embedding$", ("vocab", "embed")),
    (r"pos_embedding$", ("seq", "embed")),
    (r"lm_head$", ("embed", "vocab")),
    (r"(wq|wk|wv)$", ("embed", "heads")),       # fused heads*head_dim dim
    (r"(wq_b|wk_b|wv_b)$", ("heads",)),
    (r"wo$", ("heads", "embed")),
    (r"(w_gate|w_up|fc1)$", ("embed", "mlp")),
    (r"(w_down|fc2)$", ("mlp", "embed")),
    (r"(fc1_b)$", ("mlp",)),
    (r"(fc2_b)$", ("embed",)),
    (r"router$", ("embed", "expert")),
    (r"moe_(gate|up)$", ("expert", "embed", "mlp")),
    (r"moe_down$", ("expert", "mlp", "embed")),
    (r"in_proj$", ("embed", "mlp")),            # mamba2 d_inner ~ mlp axis
    (r"out_proj$", ("mlp", "embed")),
    (r"conv_w$", ("conv", "mlp")),
    (r"(conv_b|dt_bias|A_log|D|ssm_norm)$", ("mlp",)),
    # serving-state leaves (KV caches, SSM states)
    (r"caches/k$|caches/v$", ("layers", "batch", "kv_seq", "kv_heads", None)),
    (r"(cross_k|cross_v)$", ("layers", "batch", "frames", "kv_heads", None)),
    (r"conv$", ("layers", "batch", None, "mlp")),
    (r"/ssm$", ("layers", "batch", "heads", None, None)),
    (r"(^|/)pos$", ("batch",)),
    (r"(scale|bias|norm.*)$", ("embed",)),
)


def spec_for_path(path: str, shape: Tuple[int, ...], mesh=None,
                  rules: Optional[Rules] = None,
                  scanned: bool = False) -> Spec:
    """The spec of a parameter leaf, by naming convention.

    Rank adaptation: a rule one short of the leaf rank gains a leading
    ``layers`` axis (scan-stacked params/caches); any remaining rank gap is
    leading-padded with None so the trailing dims stay aligned."""
    for pat, logical in PARAM_RULES:
        if re.search(pat, path):
            logical = tuple(logical)
            if scanned or len(logical) == len(shape) - 1:
                logical = ("layers",) + logical
            if len(logical) < len(shape):
                logical = (None,) * (len(shape) - len(logical)) + logical
            elif len(logical) > len(shape):
                logical = logical[len(logical) - len(shape):]
            return resolve_spec(shape, logical, mesh, rules)
    return resolve_spec(shape, (None,) * len(shape), mesh, rules)


def param_specs(params, mesh=None, rules: Optional[Rules] = None):
    """A tree of specs for a parameter tree, by path convention."""
    def one(path, leaf):
        return spec_for_path(keystr_simple(path), tuple(leaf.shape), mesh,
                             rules)
    return tree_map_with_path(one, params)


@dataclasses.dataclass(frozen=True)
class RankSharding:
    """The port's ``NamedSharding``: a leaf's spec, and its DTensor
    placements (one per mesh dim) on ``device_mesh``, this rank's part
    held on ``device``."""
    device_mesh: object
    placements: tuple
    spec: Spec
    device: object


def _placements(spec: Spec, axis_names: Sequence[str]) -> tuple:
    """DTensor placements of a spec: per mesh axis, ``Shard(i)`` where
    tensor dim i names the axis (alone or in a tuple, major axis first),
    else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_names:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def sharding_for(path: str, shape: Tuple[int, ...], mesh,
                 rules: Optional[Rules] = None) -> RankSharding:
    """The :class:`RankSharding` of the leaf at ``path`` on ``mesh``."""
    spec = spec_for_path(path, shape, mesh, rules)
    return RankSharding(mesh.device_mesh, _placements(
        spec, mesh.axis_names), spec, mesh.device)


def param_shardings(params, mesh, rules: Optional[Rules] = None):
    """A tree of :class:`RankSharding` for a parameter tree on ``mesh``, a
    mesh over ranks (the reference's ``NamedSharding(mesh, spec)`` tree).
    Every rank calls it with the same tree."""
    if not getattr(mesh, "over_ranks", False):
        raise NotImplementedError(
            "param_shardings on a lanes-only mesh is not ported (ROADMAP.md "
            "§1 item 8): place parameters on a mesh over ranks "
            "(make_search_mesh(..., ranks=...)); every position of a "
            "lanes-only mesh sits on one device, where param_specs names "
            "each leaf's axes")

    def one(path, leaf):
        return sharding_for(keystr_simple(path), tuple(leaf.shape), mesh,
                            rules)
    return tree_map_with_path(one, params)


def place(x, sharding: RankSharding):
    """``x`` (the whole value, the same on every rank) as a DTensor placed
    by ``sharding``: each rank keeps its own part, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x.to(sharding.device), sharding.device_mesh,
                             sharding.placements, src_data_rank=None)


def whole(x):
    """A leaf's whole value: a DTensor gathered from its ranks (every rank
    of its mesh calls this), anything else as it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x
