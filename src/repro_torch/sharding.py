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
whose positions all sit on one device, and a spec is a plain tuple with
the entries of the reference's ``PartitionSpec`` (a mesh axis name, a
tuple of names, or None).  On such a mesh there is nothing to constrain:
:func:`shard` returns its input, and the specs only name where each
dimension would go.  ``use_rules``'s mesh is what
``models.moe_a2a.moe_ffn_sharded`` splits its lanes by.  Placing
parameters on a mesh over several devices (:func:`param_shardings`)
raises, naming ROADMAP.md §1 item 8.
"""
from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.treepath import keystr_simple, tree_map_with_path

__all__ = ["ACT_RULES", "DEFAULT_RULES", "PARAM_RULES", "current_mesh",
           "keystr_simple", "param_shardings", "param_specs",
           "resolve_spec", "shard", "spec_for_path", "use_rules"]

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


def shard(x, *logical: Optional[str]):
    """The reference's sharding constraint on an intermediate.  Every
    position of the port's mesh sits on one device, so ``x`` comes back as
    it is."""
    return x


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


def param_shardings(params, mesh, rules: Optional[Rules] = None):
    """The reference places each parameter on a mesh of several devices;
    the port's mesh is lanes of one device, so this is not ported."""
    raise NotImplementedError(
        "placing parameters on a mesh over several cards is not ported "
        "(ROADMAP.md §1 item 8): every position of the port's mesh sits on "
        "one device, where param_specs names each leaf's axes")
