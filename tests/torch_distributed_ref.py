"""Reference outputs of ``repro.core.distributed`` on meshes of several
devices, for ``tests/test_torch_distributed_mesh.py`` and
``tests/test_torch_ranks.py``.

    python tests/torch_distributed_ref.py OUT.npz [--specs]

XLA must be told to make 8 host devices before JAX is imported, hence a
process of its own.  Writes the inputs (an integer graph and queries, a
4-shard partitioned corpus) and, per case, ids, dists and the 8
``SearchStats`` counters of the walker-sharded search on (1, 4) and
(2, 4) meshes in the bitmap, hash and loose visited modes and on a
(2, 2, 2) mesh, and of the corpus-sharded search with 4 shards on (1, 4)
and (2, 4).  Every search is jitted, as the reference's own facade runs it.
With ``--specs`` it also writes ``repro.sharding.param_specs`` of the
llama3.2-3b smoke config's int8 ``TrainState`` on each of SPEC_MESHES
(shapes only, by ``jax.eval_shape``), as ``specs/<mesh>/<leaf path>``.
"""
import os
import sys

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 "
    + os.environ.get("XLA_FLAGS", ""))

import jax                                              # noqa: E402
import jax.numpy as jnp                                 # noqa: E402
import numpy as np                                      # noqa: E402

from repro.core.build import knn_graph                  # noqa: E402
from repro.core.config import SearchConfig              # noqa: E402
from repro.core.distributed import (build_partitioned,  # noqa: E402
                                    corpus_sharded_search, make_search_mesh,
                                    walker_sharded_search)
from repro.core.graph import make_padded_csr            # noqa: E402

from torch_distributed_cases import (B, CORPUS_CASES,  # noqa: E402
                                     CORPUS_CFG, D, N, PARTITION,
                                     SPEC_ARCH, SPEC_MESHES, WALKER_CASES,
                                     WALKER_CFG)


def inputs():
    """Integer vectors and queries, and a kNN-8 + 4 random edges graph."""
    rng = np.random.RandomState(7)
    x = rng.randint(-8, 9, size=(N, D)).astype(np.float32)
    # half the queries near shard 0's points, half near shard 3's
    pick = np.concatenate([rng.randint(0, N // 4, B // 2),
                           rng.randint(3 * N // 4, N, B // 2)])
    q = (x[pick] + rng.randint(-1, 2, size=(B, D))).astype(np.float32)
    nbrs = np.concatenate([np.asarray(knn_graph(x, 8)),
                           rng.randint(0, N, size=(N, 4))], axis=1)
    return x, q, nbrs.astype(np.int32)


def state_specs(out: dict) -> None:
    """``param_specs`` of the smoke TrainState on SPEC_MESHES, each spec
    as a JSON list (a tuple of axes as a list)."""
    import json
    from repro.config import TrainConfig
    from repro.configs import get_smoke_config
    from repro.models import build_model
    from repro.sharding import keystr_simple, param_specs
    from repro.train.train_step import init_train_state
    model = build_model(get_smoke_config(SPEC_ARCH))
    tcfg = TrainConfig(grad_compression="int8")
    state = jax.eval_shape(
        lambda: init_train_state(model, jax.random.PRNGKey(0), tcfg))
    for shape in SPEC_MESHES:
        mesh = make_search_mesh(shape, ("data", "model"))
        specs = param_specs(state, mesh)
        flat, _ = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        for path, spec in flat:
            out[f"specs/{shape[0]}x{shape[1]}/{keystr_simple(path)}"] = (
                np.asarray(json.dumps([list(e) if isinstance(e, tuple)
                                       else e for e in spec])))


def main(out_path: str, specs: bool = False) -> None:
    assert len(jax.devices()) == 8, jax.devices()
    x, q, nbrs = inputs()
    graph = make_padded_csr(nbrs, x)
    qj = jnp.asarray(q)
    out = dict(x=x, q=q, nbrs=nbrs)
    for name, shape, names, mode in WALKER_CASES:
        mesh = make_search_mesh(shape, names)
        cfg = SearchConfig(visited_mode=mode, **WALKER_CFG)
        ids, dists, stats = jax.jit(
            lambda qq: walker_sharded_search(graph, qq, cfg, mesh))(qj)
        out[f"{name}/ids"] = np.asarray(ids)
        out[f"{name}/dists"] = np.asarray(dists)
        for field, v in stats._asdict().items():
            out[f"{name}/{field}"] = np.asarray(v)
    index = build_partitioned(x, **PARTITION)
    for field in index._fields:
        out[f"partition/{field}"] = np.asarray(getattr(index, field))
    cfg = SearchConfig(**CORPUS_CFG)
    for name, shape in CORPUS_CASES:
        mesh = make_search_mesh(shape, ("data", "model"))
        ids, dists = jax.jit(
            lambda qq: corpus_sharded_search(index, qq, cfg, mesh))(qj)
        out[f"{name}/ids"] = np.asarray(ids)
        out[f"{name}/dists"] = np.asarray(dists)
    if specs:
        state_specs(out)
    np.savez(out_path, **out)
    print("REFERENCE_OK")


if __name__ == "__main__":
    main(sys.argv[1], "--specs" in sys.argv[2:])
