"""The port's mesh over the ranks of a process group (gloo, on the CPU),
against the reference on as many devices and against the lanes paths.

``tests/torch_distributed_ref.py --specs`` runs ``repro`` in a process of
its own (8 forced XLA host devices) and writes its sharded searches'
outputs and ``param_specs``; ``tests/torch_moe_ref.py`` writes the MoE's.
``tests/torch_ranks_worker.py`` spawns 4 ranks once for the module (each
join limited to 170 s, every group with a timeout, file rendezvous under
the test's tmp dir) and runs every case:

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
  from a checkpoint they wrote, it equals the unbroken 4-lane run; the
  moe model's step under ``set_moe_impl("a2a")`` on (2, 2) over ranks
  (2, 2) equals its lanes run;
* ``reshard_state`` (2, 2) -> (4, 1) -> (1, 4) -> one device keeps every
  leaf's bits, with the reference's specs; a checkpoint restored against
  ``param_shardings``; ``launch.train`` over 2 ranks repeats the 2-lane
  run's losses;
* serving over the ranks: the walker engine on (1, 4) over ranks (1, 4)
  and (2, 4) over (2, 2), the corpus engine on (1, 4), and the engine on
  the default mesh; rank 0's requests, coalesced queries and two
  threads' requests equal the reference and the search on the same mesh
  bit for bit, two bad requests fail on rank 0 alone, and the
  coalescer's close ends every worker's loop;
* the MoE over the ranks (``tests/torch_moe_ref.py`` runs the reference
  beside ``torch_distributed_ref.py``): ``moe_ffn_sharded`` on (2, 4)
  over ranks (2, 2), a2a and tp, equals the reference at the lane tests'
  tolerance and the lanes path bit for bit, gradients too (whole leaves
  and DTensor parts); the moe ``CausalLM`` under ``set_moe_impl("a2a")``
  gives the reference's logits and the lanes run's gradients;
* ``RankAxis.all_to_all`` and ``broadcast`` move the blocks they should;
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
import torch_moe_cases as moe_case
import torch_ranks_worker as worker
from repro_torch import ranks
from repro_torch.core.distributed import build_partitioned, make_search_mesh
from repro_torch.core.metrics import SearchStats

ROOT = pathlib.Path(__file__).resolve().parent.parent
STATS = SearchStats._fields


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    out, moe_out = tmp / "ref.npz", tmp / "moe_ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    # the two references run side by side, each in a process of its own
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / script), str(path), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for script, path, args in (
            ("torch_distributed_ref.py", out, ["--specs"]),
            ("torch_moe_ref.py", moe_out, []))]
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            assert p.returncode == 0, stdout + "\n" + stderr
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ref, moe = ({k: z[k] for k in z.files} for z in map(np.load, (out,
                                                                   moe_out)))
    return ref, worker.spawn(str(tmp), str(out), str(moe_out)), moe


def _same(ref, name, got, stats=True):
    for f in ("ids", "dists") + (STATS if stats else ()):
        np.testing.assert_array_equal(got[f], ref[f"{name}/{f}"],
                                      err_msg=f"{name}: {f}")


@pytest.mark.parametrize("case", worker.WALKER_RANKS,
                         ids=[f"{c[0]}@{c[4]}" for c in worker.WALKER_RANKS])
def test_walker_over_ranks_matches_reference(runs, case):
    ref, res, _ = runs
    for r in res:
        _same(ref, case[0], r["walker"][case[0]])
        assert r["transport"] == "gloo: host memory"


def test_walker_two_lanes_a_rank_matches_reference(runs):
    ref, res, _ = runs
    for r in res[:2]:
        _same(ref, "walker_1x4_bitmap", r["walker_b"])


def test_default_search_mesh_is_over_the_ranks(runs):
    """With a group up, a search without a mesh runs (1, world) over the
    ranks: every rank returns the explicit (1, 4)-over-(1, 4) answer; the
    engine without a mesh serves on that mesh, rank 0 that answer."""
    _, res, _ = runs
    first = res[0]["default_mesh"]["explicit"]
    for r in res:
        got = r["default_mesh"]
        for f in first:
            np.testing.assert_array_equal(got["default"][f], first[f])
            np.testing.assert_array_equal(got["explicit"][f], first[f])
        assert got["engine_mesh"] == ({"data": 1, "model": 4}, (1, 4))
    for f in first:
        np.testing.assert_array_equal(res[0]["default_mesh"]["served"][f],
                                      first[f])
    assert all(r["default_mesh"]["worker_served"] == 1 for r in res[1:])


def test_rank_axis_all_to_all_and_broadcast(runs):
    _, res, _ = runs
    for r in res:
        c, (d, m) = r["collectives"], _coord(r["rank"], (2, 2))
        peers = [2 * d + j for j in range(2)]       # this data row's ranks
        np.testing.assert_array_equal(
            c["all_to_all"], [[2 * m + 10 * p, 2 * m + 1 + 10 * p]
                              for p in peers])
        np.testing.assert_array_equal(c["broadcast"], [1.0] * 3)
        np.testing.assert_array_equal(c["world_broadcast"], [3, 21])


CORPUS = worker.CORPUS_RANKS + worker.CORPUS_RANKS_B


@pytest.mark.parametrize("case", CORPUS, ids=[f"{c[0]}@{c[2]}"
                                              for c in CORPUS])
def test_partitioned_build_over_ranks_equals_serial(runs, case):
    ref, res, _ = runs
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
    ref, res, _ = runs
    for r in (res if case[2] != (1, 2) else res[:2]):
        _same(ref, case[0], r["corpus"][f"{case[0]}@{case[2]}"],
              stats=False)


@pytest.mark.parametrize("which,n_ranks,model_ranks", [
    ("compressed_4", 4, 1), ("compressed_2x2", 2, 1),
    # the moe model under set_moe_impl("a2a") on (2, 2) over ranks (2, 2):
    # each rank's rows split over the mesh as its lanes, as the lanes run's
    ("compressed_moe", 4, 2)])
def test_compressed_step_over_ranks_equals_lanes(runs, which, n_ranks,
                                                 model_ranks):
    _, res, _ = runs
    for i, r in enumerate(res[:n_ranks]):
        got, want = r[which]["ranks"], r[which]["lanes"]
        assert got["metrics"] == want["metrics"]
        for part in ("params", "opt"):
            assert got[part].keys() == want[part].keys()
            for k, v in want[part].items():
                np.testing.assert_array_equal(got[part][k], v,
                                              err_msg=f"{part}/{k}")
                np.testing.assert_array_equal(
                    got[part][k], res[0][which]["ranks"][part][k])
        d = i // model_ranks                       # this rank's data row
        for k, v in want["err"].items():
            np.testing.assert_array_equal(got["err"][k], v, err_msg=k)
            lanes = len(v) * model_ranks // n_ranks
            assert got["err_here"][k].shape[0] == lanes
            np.testing.assert_array_equal(
                got["err_here"][k], v[d * lanes:(d + 1) * lanes], err_msg=k)


def test_compressed_resume_over_ranks_equals_lanes(runs):
    """Two steps over 2 ranks × 2 lanes, a checkpoint (every rank's
    residual rows, in lane order), a new Trainer resumed from it for two
    more: the unbroken 4-lane run's state and metrics, bit for bit."""
    _, res, _ = runs
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
    _, res, _ = runs
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
    ref, res, _ = runs
    name = "x".join(map(str, shape))
    want = {k[len(f"specs/{name}/"):]: json.loads(str(v))
            for k, v in ref.items() if k.startswith(f"specs/{name}/")}
    for r in res:
        got = {k: [list(e) if isinstance(e, tuple) else e for e in s]
               for k, s in r["reshard"]["meshes"][name]["specs"].items()}
        assert got == want


def test_load_checkpoint_against_shardings(runs):
    _, res, _ = runs
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
    _, res, _ = runs
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


# ---------------------------------------------------------------------------
# serving over ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", worker.SERVE_RANKS,
                         ids=[f"{c[0]}@{c[2]}" for c in worker.SERVE_RANKS])
def test_served_over_ranks_matches_reference(runs, case):
    """Rank 0's engine requests (padded to their buckets), the coalescer's
    answers and two threads' answers equal the reference and the search
    on the same mesh: ids, dists and, for the walker path, all 8
    counters."""
    ref, res, _ = runs
    name = case[0]
    key = f"{name}@{case[2]}"
    walker = name.startswith("walker")
    fields = ("ids", "dists") + (STATS if walker else ())
    for r in res:
        assert r["served"][key]["over_ranks"]
        _same(ref, name, r["served"][key]["direct"], stats=walker)
    got = res[0]["served"][key]
    for req in got["requests"]:
        lo = req["lo"]
        n = req["ids"].shape[0]
        for f in fields:
            np.testing.assert_array_equal(req[f], ref[f"{name}/{f}"][
                lo:lo + n], err_msg=f"{key} [{lo}:{lo + n}] {f}")
    assert [r["buckets"] for r in got["requests"]] == (
        [(8,), (1,), (4,), (2,)] if case[1][0] == 1
        else [(8,), (2,), (4,), (2,)])
    _same(ref, name, got["coalesced"], stats=False)
    for ids in got["threads"]:
        np.testing.assert_array_equal(ids, ref[f"{name}/ids"])


def test_concurrent_searches_do_not_mix_buckets(runs):
    """Two threads on rank 0 search one engine over ranks three times
    each: neither hangs, and every answer is the serial one (checked
    against the reference in the test above); every worker ran exactly
    the buckets rank 0 dispatched."""
    _, res, _ = runs
    for c in worker.SERVE_RANKS:
        key = f"{c[0]}@{c[2]}"
        got = res[0]["served"][key]
        assert got["threads_alive"] == [False, False]
        assert len(got["threads"]) == 3
        for r in res[1:]:
            assert r["served"][key]["worker_served"] == got["dispatched"]


def test_close_ends_every_worker(runs):
    """The coalescer's close closes the engine: every worker's loop
    returns, and the engine refuses further requests on rank 0."""
    _, res, _ = runs
    for c in worker.SERVE_RANKS:
        key = f"{c[0]}@{c[2]}"
        assert "closed" in res[0]["served"][key]["after_close"]
        for r in res[1:]:
            assert r["served"][key]["worker_served"] > 0
            assert r["served"][key]["serve_seconds"] < worker.JOIN_S


def test_idle_controller_keeps_workers_alive(runs):
    """Rank 0 idles past the group's timeout with an engine open: its
    no-op headers keep the worker's wait alive, and the request after the
    idle is served, equal to the search on the same mesh."""
    _, res, _ = runs
    got = res[0]["keepalive"]
    assert worker.KEEPALIVE_IDLE_S > worker.KEEPALIVE_TIMEOUT.total_seconds()
    assert res[1]["keepalive"]["worker_served"] == 1
    for f in ("ids", "dists"):
        np.testing.assert_array_equal(got[f], got["direct"][f])
        np.testing.assert_array_equal(res[1]["keepalive"]["direct"][f],
                                      got["direct"][f])


def test_bad_request_fails_on_rank_zero_alone(runs):
    """A request of the wrong dim and an empty one raise on rank 0 before
    any header goes out; the requests after them are served."""
    _, res, _ = runs
    for c in worker.SERVE_RANKS:
        bad = res[0]["served"][f"{c[0]}@{c[2]}"]["bad"]
        assert len(bad) == 2
        assert "dim" in bad[0] and "B >= 1" in bad[1]


# ---------------------------------------------------------------------------
# the MoE over ranks
# ---------------------------------------------------------------------------

MOE_CASES = [c[0] for c in moe_case.FFN_CASES]


def _moe_block(x, rank, name):
    """Rank ``rank``'s block of whole tokens x (..., d) on the moe mesh
    (2, 4) over ranks (2, 2), row-major: a2a splits the tokens over (data,
    model), one data lane and two model lanes a rank; tp over data."""
    dc, mc = _coord(rank, (2, 2))
    d = x.shape[-1]
    if name.startswith("a2a"):
        return x.reshape(2, 4, -1, d)[dc, 2 * mc:2 * mc + 2].reshape(-1, d)
    return x.reshape(2, -1, d)[dc]


@pytest.mark.parametrize("name", MOE_CASES)
def test_moe_over_ranks_matches_reference(runs, name):
    """This rank's token block through ``moe_ffn_sharded`` on (2, 4) over
    ranks (2, 2) gives the reference's output for that block, and its aux
    loss (the lane tests' tolerances, 1e-5 and 1e-6); the whole ``x``
    through ``moe_ffn_whole`` gives the reference's whole output."""
    _, res, moe = runs
    want = moe[f"{name}/y"]
    for r in res:
        got = r["moe"][name]
        np.testing.assert_array_equal(got["block"]["x"], _moe_block(
            moe[f"{name}/x"], r["rank"], name))
        np.testing.assert_allclose(got["ranks"]["y"], _moe_block(
            want, r["rank"], name), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["whole"]["y"], want, rtol=1e-5,
                                   atol=1e-5)
        for part in ("ranks", "dtensor", "whole"):
            np.testing.assert_allclose(got[part]["aux"],
                                       float(moe[f"{name}/aux"]), rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("name", MOE_CASES)
def test_moe_over_ranks_equals_lanes(runs, name):
    """Over ranks the block's output and x gradient, the aux loss and the
    gradients of the router and the three expert stacks (whole leaves,
    and DTensor parts placed by ``param_shardings``) equal the lanes
    path's bit for bit; so do ``moe_ffn_whole``'s output and x gradient."""
    _, res, _ = runs
    for r in res:
        got = r["moe"][name]
        lanes = got["lanes"]
        coord = _coord(r["rank"], (2, 2))
        for part in ("ranks", "dtensor", "whole"):
            assert got[part]["aux"] == lanes["aux"]
            for k, v in lanes["grads"].items():
                want = v if part != "dtensor" else _chunk(
                    v, got["specs"][k], (2, 2), coord)
                np.testing.assert_array_equal(got[part]["grads"][k], want,
                                              err_msg=f"{part}: {k}")
        for part in ("ranks", "dtensor"):
            for f in ("y", "x_grad"):
                np.testing.assert_array_equal(
                    got[part][f], _moe_block(lanes[f], r["rank"], name),
                    err_msg=f"{part}: {f}")
        for f in ("y", "x_grad"):
            np.testing.assert_array_equal(got["whole"][f], lanes[f])
    # the DTensor run gathers real shards
    assert any(e is not None for s in res[0]["moe"][name]["specs"].values()
               for e in s)


def test_causal_lm_a2a_over_ranks_matches_reference(runs):
    """The moe ``CausalLM`` under ``set_moe_impl("a2a")`` on (2, 4) over
    ranks (2, 2): every rank's logits and aux are the reference's (1e-5,
    1e-6) and the lanes run's, and so is every parameter's gradient, bit
    for bit."""
    _, res, moe = runs
    for r in res:
        got, lanes = r["moe"]["lm"]["ranks"], r["moe"]["lm"]["lanes"]
        np.testing.assert_allclose(got["logits"], moe["lm/logits"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["aux"], float(moe["lm/aux"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got["logits"], lanes["logits"])
        assert got["aux"] == lanes["aux"]
        assert got["grads"].keys() == lanes["grads"].keys()
        for k, v in lanes["grads"].items():
            np.testing.assert_array_equal(got["grads"][k], v, err_msg=k)
