"""The port's sharded searches on meshes of several positions, against the
reference on as many devices.

``tests/torch_distributed_ref.py`` runs ``repro.core.distributed`` in a
process of its own with 8 forced XLA host devices (as
``tests/distributed_check.py`` does) and writes its inputs and outputs to
npz.  The port runs the same meshes with every position on the CPU and must
return the same ids, dists and all 8 ``SearchStats`` counters, bit for bit
(integer data): the walker path on (1, 4) and (2, 4) in the bitmap, hash
and loose modes and on (2, 2, 2), and the corpus path over 4 shards on
(1, 4) and (2, 4).  This is the only test of the walker merge over more
than one walker.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_distributed_cases as ref_case
from repro_torch.core.config import SearchConfig
from repro_torch.core.distributed import (ShardedIndex, build_partitioned,
                                          corpus_sharded_search,
                                          make_search_mesh,
                                          walker_sharded_search)
from repro_torch.core.graph import make_padded_csr

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_distributed_ref.py"),
         str(out)], capture_output=True, text=True, timeout=120, env=env)
    assert run.returncode == 0, run.stdout + "\n" + run.stderr
    assert "REFERENCE_OK" in run.stdout
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _same(ref, name, ids, dists, stats=None):
    np.testing.assert_array_equal(ids.numpy(), ref[f"{name}/ids"],
                                  err_msg=name)
    np.testing.assert_array_equal(dists.numpy(), ref[f"{name}/dists"],
                                  err_msg=name)
    if stats is not None:
        for field, v in stats._asdict().items():
            np.testing.assert_array_equal(v.numpy(), ref[f"{name}/{field}"],
                                          err_msg=f"{name}: {field}")


@pytest.mark.parametrize("case", ref_case.WALKER_CASES,
                         ids=[c[0] for c in ref_case.WALKER_CASES])
def test_walker_meshes_match_reference(ref, case):
    name, shape, names, mode = case
    graph = make_padded_csr(ref["nbrs"], ref["x"], device="cpu")
    cfg = SearchConfig(visited_mode=mode, **ref_case.WALKER_CFG)
    mesh = make_search_mesh(shape, names, device="cpu")
    _same(ref, name, *walker_sharded_search(
        graph, torch.from_numpy(ref["q"]), cfg, mesh))


def test_partitioned_build_matches_reference(ref):
    got = build_partitioned(ref["x"], device="cpu", **ref_case.PARTITION)
    for field in ShardedIndex._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      ref[f"partition/{field}"],
                                      err_msg=field)


@pytest.mark.parametrize("case", ref_case.CORPUS_CASES,
                         ids=[c[0] for c in ref_case.CORPUS_CASES])
def test_corpus_meshes_match_reference(ref, case):
    name, shape = case
    index = ShardedIndex(*(torch.from_numpy(ref[f"partition/{f}"])
                           for f in ShardedIndex._fields))
    mesh = make_search_mesh(shape, device="cpu")
    ids, dists = corpus_sharded_search(
        index, torch.from_numpy(ref["q"]),
        SearchConfig(**ref_case.CORPUS_CFG), mesh)
    _same(ref, name, ids, dists)
    # the merge took answers from more than one shard
    shards = np.unique(ids.numpy() // (ref["x"].shape[0] // 4))
    assert len(shards) > 1
