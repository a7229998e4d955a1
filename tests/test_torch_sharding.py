"""The port's ``sharding`` rules against ``repro.sharding``, on the CPU.

``resolve_spec``, ``spec_for_path`` and ``param_specs`` give the
reference's specs (its ``PartitionSpec``s compared as tuples) on a (2, 4)
("data", "model") mesh: the reference's ``AbstractMesh``, the port's
``SearchMesh`` of lanes on the CPU.  The moe leaves are among them.
``use_rules`` sets the active rules and mesh for a block, ``shard``
returns its input, and ``param_shardings`` (a mesh over several cards)
raises naming ROADMAP.md §1 item 8.
"""
import jax
import pytest
import torch

import repro.sharding as jsh
from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro_torch import sharding as tsh
from repro_torch.configs import get_smoke_config
from repro_torch.core.distributed import make_search_mesh
from repro_torch.models import build_model


@pytest.fixture(scope="module")
def meshes():
    try:
        ref = jax.sharding.AbstractMesh((2, 4), ("data", "model"))
    except TypeError:     # jax <= 0.4.x: a tuple of (name, size) pairs
        ref = jax.sharding.AbstractMesh((("data", 2), ("model", 4)))
    return ref, make_search_mesh((2, 4), device="cpu")


def _tuple(spec):
    return tuple(spec)


RESOLVE_CASES = [
    ((8, 20), ("batch", "heads")),
    ((8, 7), ("batch", "heads")),
    ((4, 32, 8, 16), ("layers", "kv_seq", "kv_heads", None)),
    ((6, 64, 128), ("expert", "embed", "mlp")),      # 6 experts: replicated
    ((8, 64, 128), ("expert", "embed", "mlp")),
    ((2, 3, 5), (None, "capacity", "seq")),
    ((16, 16), ("embed", "embed")),                   # an axis used once
]


@pytest.mark.parametrize("shape,logical", RESOLVE_CASES)
@pytest.mark.parametrize("rules", ["default", "act"])
def test_resolve_spec_equals_reference(meshes, shape, logical, rules):
    ref_mesh, mesh = meshes
    r_rules, t_rules = ((jsh.DEFAULT_RULES, tsh.DEFAULT_RULES)
                        if rules == "default"
                        else (jsh.ACT_RULES, tsh.ACT_RULES))
    assert r_rules == t_rules
    want = _tuple(jsh.resolve_spec(shape, logical, ref_mesh, r_rules))
    assert tsh.resolve_spec(shape, logical, mesh, t_rules) == want
    # without a mesh the rules map names as they are
    assert tsh.resolve_spec(shape, logical, None, t_rules) == _tuple(
        jsh.resolve_spec(shape, logical, None, r_rules))


PATHS = [
    ("layers/attn/wq", (4, 64, 64)),
    ("grouped/mamba/in_proj", (2, 3, 64, 64)),
    ("caches/k", (4, 8, 64, 4, 16)),
    ("layers/moe/router", (2, 64, 8)),
    ("layers/moe/moe_gate", (2, 8, 64, 32)),
    ("layers/moe/moe_up", (2, 6, 64, 32)),
    ("layers/moe/moe_down", (2, 8, 32, 64)),
    ("embedding", (128, 64)),
    ("final_norm/scale", (64,)),
    ("pos", (8,)),
    ("unknown/leaf", (3, 4)),
]


@pytest.mark.parametrize("path,shape", PATHS)
def test_spec_for_path_equals_reference(meshes, path, shape):
    ref_mesh, mesh = meshes
    assert tsh.spec_for_path(path, shape, mesh) == _tuple(
        jsh.spec_for_path(path, shape, ref_mesh))
    assert tsh.spec_for_path(path, shape, mesh, scanned=True) == _tuple(
        jsh.spec_for_path(path, shape, ref_mesh, scanned=True))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "grok-1-314b",
                                  "qwen2.5-3b"])
def test_param_specs_equal_reference(meshes, arch):
    """Every leaf of a smoke model's tree, the moe leaves included."""
    ref_mesh, mesh = meshes
    tree = jax.eval_shape(j_build(j_smoke(arch)).init,
                          jax.random.PRNGKey(0))      # shapes only
    want = {jsh.keystr_simple(p): _tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jsh.param_specs(tree, ref_mesh),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
            )[0]}
    port = build_model(get_smoke_config(arch), device="cpu").init_tree(
        torch.Generator().manual_seed(0))
    got = _flat_specs(tsh.param_specs(port, mesh))
    assert got == want
    if "moe" in arch:
        assert got["layers/moe/moe_gate"] == (None, "model", "data", None)


def _flat_specs(tree, path=()) -> dict:
    """{path: spec} of a tree of dicts whose leaves are spec tuples."""
    if not isinstance(tree, dict):
        return {"/".join(path): tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat_specs(v, path + (k,)))
    return out


def test_use_rules_sets_rules_and_mesh_for_a_block(meshes):
    _, mesh = meshes
    assert tsh.current_mesh() is None
    rules = dict(tsh.DEFAULT_RULES, heads=None)
    with tsh.use_rules(rules, mesh):
        assert tsh.current_mesh() is mesh
        assert tsh.resolve_spec((8, 20), ("batch", "heads")) == ("data",
                                                                   None)
        x = torch.ones(3)
        assert tsh.shard(x, "batch") is x
    assert tsh.current_mesh() is None
    assert tsh.resolve_spec((8, 20), ("batch", "heads")) == (("pod", "data"),
                                                             "model")


def test_keystr_and_param_shardings(meshes):
    assert tsh.keystr_simple(("layers", "moe", "router")) == \
        "layers/moe/router"
    _, mesh = meshes
    with pytest.raises(NotImplementedError, match=r"§1 item 8"):
        tsh.param_shardings({"w": torch.zeros(2)}, mesh)
    assert tsh.PARAM_RULES == jsh.PARAM_RULES
