"""The port's mesh over the ranks of a process group (gloo, on the CPU),
against the reference on as many devices and against the lanes paths.

``tests/torch_distributed_ref.py --specs`` runs ``repro`` in a process of
its own (8 forced XLA host devices) and writes its sharded searches'
outputs and ``param_specs``.  ``tests/torch_ranks_worker.py`` spawns 4
ranks once for the module (each join limited to 170 s, every group with a
timeout, file rendezvous under the test's tmp dir) and runs every case:

* the walker path (ids, dists and all 8 counters, bit for bit, on every
  rank): (1, 4) over ranks (1, 4) in the bitmap, hash and loose modes;
  (1, 4) bitmap over ranks (1, 2), two walker lanes a rank; (2, 4) over
  ranks (2, 2); (2, 2, 2) over ranks (2, 1, 2); ``index.search`` on the
  default mesh, which is (1, world) over the ranks;
* the corpus path: the build split over the ranks gives the serial
  build's graph bytes, and the search equals the reference on (1, 4) over
  ranks (1, 4) and (1, 2) and on (2, 4) over ranks (2, 2);
* the compressed DP step over 4 ranks and over 2 ranks × 2 lanes equals
  the 4-lane step bit for bit (params, optimizer state, every residual
  row, loss and grad norm, two steps); resumed over 2 ranks × 2 lanes
  from a checkpoint they wrote, it equals the unbroken 4-lane run;
* ``reshard_state`` (2, 2) -> (4, 1) -> (1, 4) -> one device keeps every
  leaf's bits, with the reference's specs; a checkpoint restored against
  ``param_shardings``; ``launch.train`` over 2 ranks repeats the 2-lane
  run's losses;
* ``init_ranks`` refuses to run without a card unless asked for the CPU.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_distributed_cases as ref_case
import torch_ranks_worker as worker
from repro_torch import ranks
from repro_torch.core.distributed import build_partitioned, make_search_mesh
from repro_torch.core.metrics import SearchStats

ROOT = pathlib.Path(__file__).resolve().parent.parent
STATS = SearchStats._fields


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    out = tmp / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_distributed_ref.py"),
         str(out), "--specs"], capture_output=True, text=True, timeout=120,
        env=env)
    assert run.returncode == 0, run.stdout + "\n" + run.stderr
    with np.load(out) as z:
        ref = {k: z[k] for k in z.files}
    return ref, worker.spawn(str(tmp), str(out))


def _same(ref, name, got, stats=True):
    for f in ("ids", "dists") + (STATS if stats else ()):
        np.testing.assert_array_equal(got[f], ref[f"{name}/{f}"],
                                      err_msg=f"{name}: {f}")


@pytest.mark.parametrize("case", worker.WALKER_RANKS,
                         ids=[f"{c[0]}@{c[4]}" for c in worker.WALKER_RANKS])
def test_walker_over_ranks_matches_reference(runs, case):
    ref, res = runs
    for r in res:
        _same(ref, case[0], r["walker"][case[0]])
        assert r["transport"] == "gloo: host memory"


def test_walker_two_lanes_a_rank_matches_reference(runs):
    ref, res = runs
    for r in res[:2]:
        _same(ref, "walker_1x4_bitmap", r["walker_b"])


def test_default_search_mesh_is_over_the_ranks(runs):
    """With a group up, a search without a mesh runs (1, world) over the
    ranks: every rank returns the explicit (1, 4)-over-(1, 4) answer; the
    engine refuses to serve over ranks (explicit or default mesh)."""
    _, res = runs
    first = res[0]["default_mesh"]["explicit"]
    for r in res:
        got = r["default_mesh"]
        for f in first:
            np.testing.assert_array_equal(got["default"][f], first[f])
            np.testing.assert_array_equal(got["explicit"][f], first[f])
        assert len(got["serve_refused"]) == 2
        assert all("§1 item 8" in m for m in got["serve_refused"])


CORPUS = worker.CORPUS_RANKS + worker.CORPUS_RANKS_B


@pytest.mark.parametrize("case", CORPUS, ids=[f"{c[0]}@{c[2]}"
                                              for c in CORPUS])
def test_partitioned_build_over_ranks_equals_serial(runs, case):
    ref, res = runs
    serial = build_partitioned(ref["x"], device="cpu", **ref_case.PARTITION)
    key = f"{case[0]}@{case[2]}"
    per = ref_case.PARTITION["num_shards"] // case[2][1]
    seen = set()
    for r in (res if case[2] != (1, 2) else res[:2]):
        got = r["corpus"][key]
        lo = got["first_shard"]
        seen.add(lo)
        for f in ("nbrs", "vectors", "medoids", "offsets"):
            want = getattr(serial, f).numpy()[lo:lo + per]
            np.testing.assert_array_equal(got["block"][f], want, err_msg=f)
            np.testing.assert_array_equal(
                got["block"][f], ref[f"partition/{f}"][lo:lo + per])
    assert seen == set(range(0, ref_case.PARTITION["num_shards"], per))


@pytest.mark.parametrize("case", CORPUS, ids=[f"{c[0]}@{c[2]}"
                                              for c in CORPUS])
def test_corpus_over_ranks_matches_reference(runs, case):
    ref, res = runs
    for r in (res if case[2] != (1, 2) else res[:2]):
        _same(ref, case[0], r["corpus"][f"{case[0]}@{case[2]}"],
              stats=False)


@pytest.mark.parametrize("which,n_ranks", [("compressed_4", 4),
                                           ("compressed_2x2", 2)])
def test_compressed_step_over_ranks_equals_lanes(runs, which, n_ranks):
    _, res = runs
    lanes = 4 // n_ranks
    for i, r in enumerate(res[:n_ranks]):
        got, want = r[which]["ranks"], r[which]["lanes"]
        assert got["metrics"] == want["metrics"]
        for part in ("params", "opt"):
            for k, v in want[part].items():
                np.testing.assert_array_equal(got[part][k], v,
                                              err_msg=f"{part}/{k}")
                np.testing.assert_array_equal(
                    got[part][k], res[0][which]["ranks"][part][k])
        for k, v in want["err"].items():
            np.testing.assert_array_equal(got["err"][k], v, err_msg=k)
            assert got["err_here"][k].shape[0] == lanes
            np.testing.assert_array_equal(
                got["err_here"][k], v[i * lanes:(i + 1) * lanes], err_msg=k)


def test_compressed_resume_over_ranks_equals_lanes(runs):
    """Two steps over 2 ranks × 2 lanes, a checkpoint (every rank's
    residual rows, in lane order), a new Trainer resumed from it for two
    more: the unbroken 4-lane run's state and metrics, bit for bit."""
    _, res = runs
    for r in res[:2]:
        got, want = r["resume_2x2"]["ranks"], r["resume_2x2"]["lanes"]
        assert len(got["metrics"]) == 4
        assert got["metrics"] == want["metrics"]
        for part in ("params", "opt", "err"):
            assert got[part].keys() == want[part].keys()
            for k, v in want[part].items():
                np.testing.assert_array_equal(got[part][k], v,
                                              err_msg=f"{part}/{k}")
        assert all(v.shape[0] == 4 for v in got["err"].values())


def _chunk(x, spec, shape, coord):
    """The block of ``x`` a rank at grid ``coord`` of a mesh of ``shape``
    (("data", "model") ranks, one a position) holds under ``spec``."""
    names = ("data", "model")
    for dim, entry in enumerate(spec):
        axes = [entry] if isinstance(entry, str) else list(entry or [])
        for a in axes:
            j = names.index(a)
            x = np.split(x, shape[j], axis=dim)[coord[j]]
    return x


def _coord(rank, shape):
    return (rank // shape[1], rank % shape[1])


def test_reshard_state_round_trips(runs):
    _, res = runs
    host = res[0]["reshard"]["host"]
    for r in res:
        out = r["reshard"]
        for k, v in host.items():
            np.testing.assert_array_equal(out["host"][k], v)
        for name, m in out["meshes"].items():
            shape = tuple(int(s) for s in name.split("x"))
            for k, v in host.items():
                np.testing.assert_array_equal(m["whole"][k], v,
                                              err_msg=f"{name}: {k}")
                np.testing.assert_array_equal(
                    m["local"][k],
                    _chunk(v, m["specs"][k], shape, _coord(r["rank"], shape)),
                    err_msg=f"{name}: {k}")
        sharded = [k for k, s in out["meshes"]["2x2"]["specs"].items()
                   if any(e is not None for e in s)]
        assert len(sharded) > len(host) // 2
        for k, v in host.items():
            kind, arr = out["single"][k]
            assert kind == "Tensor"
            np.testing.assert_array_equal(arr, v)


@pytest.mark.parametrize("shape", ref_case.SPEC_MESHES,
                         ids=["x".join(map(str, s))
                              for s in ref_case.SPEC_MESHES])
def test_param_specs_equal_reference(runs, shape):
    import json
    ref, res = runs
    name = "x".join(map(str, shape))
    want = {k[len(f"specs/{name}/"):]: json.loads(str(v))
            for k, v in ref.items() if k.startswith(f"specs/{name}/")}
    for r in res:
        got = {k: [list(e) if isinstance(e, tuple) else e for e in s]
               for k, s in r["reshard"]["meshes"][name]["specs"].items()}
        assert got == want


def test_load_checkpoint_against_shardings(runs):
    _, res = runs
    host = res[0]["reshard"]["host"]
    specs = res[0]["reshard"]["meshes"]["2x2"]["specs"]
    for r in res:
        got = r["reshard"]["restored"]
        for k, v in host.items():
            np.testing.assert_array_equal(got["whole"][k], v, err_msg=k)
            np.testing.assert_array_equal(
                got["local"][k], _chunk(v, specs[k], (2, 2),
                                        _coord(r["rank"], (2, 2))),
                err_msg=k)


def test_launch_train_over_ranks_equals_lanes(runs):
    _, res = runs
    lanes = res[0]["train_lanes"]
    assert len(lanes) == 4 and lanes[-1] < lanes[0]
    assert res[0]["train_ranks"] == lanes
    assert res[1]["train_ranks"] == lanes


def test_init_ranks_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ranks.init_ranks(device=device, rank=0, world=1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ranks.init_ranks(device="cpu", backend="nccl", rank=0, world=1)
    assert not ranks.is_up()
    with pytest.raises(RuntimeError, match="init_ranks first"):
        make_search_mesh((1, 4), device="cpu", ranks=(1, 4))
