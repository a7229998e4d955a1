"""The partitioned models on the CPU (``CausalLM`` and the ssm, hybrid and
encdec families): DTensor parameters placed by
``sharding.param_shardings`` on a (2, 2) mesh over 4 gloo ranks, against
the one-device port on the reference's weights, and the dry run's
counting group (``ranks.init_counting_ranks``) against a real rank, also
for the ANN dry run's searches.

``tests/torch_partition_worker.py`` spawns the 4 ranks and the counting
process once for the module.  The bar: f32 logits within 1e-5 of their
largest value, each gradient leaf within 1e-5 of its largest (the
partitioned sums add in another order); op records equal op for op.
"""
import jax
import numpy as np
import pytest
import torch

import torch_partition_worker as worker
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import build_model as ref_build_model
from repro_torch.models import build_model
from repro_torch.models.convert import tree_from_jax
from repro_torch.treepath import flatten_with_path, keystr_simple

RUNS = worker.LM_ARCHS + worker.FAMILY_ARCHS
ARCHS = RUNS + (worker.VLM_ARCH,)


def _ref_tree(arch):
    cfg = worker.smoke_cfg(arch, ref_smoke_config)
    return jax.tree.map(np.asarray, ref_build_model(cfg).init(
        jax.random.PRNGKey(7)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partition")
    trees = {arch: _ref_tree(arch) for arch in ARCHS}
    flat = {f"{arch}/{keystr_simple(p)}": np.asarray(a)
            for arch, t in trees.items() for p, a in flatten_with_path(t)}
    weights = tmp / "weights.npz"
    np.savez(weights, **flat)
    got = worker.spawn(str(tmp), str(weights))
    want = {arch: worker.run_lm(arch, tree_from_jax(trees[arch], "cpu"))
            for arch in RUNS}
    cfg = worker.smoke_cfg(worker.VLM_ARCH)
    x = worker.inputs(worker.VLM_ARCH)
    logits, st = build_model(cfg, device="cpu").prefill(
        tree_from_jax(trees[worker.VLM_ARCH], "cpu"),
        torch.from_numpy(x["tokens"]), s_max=worker.S_MAX,
        positions=torch.from_numpy(x["positions"]))
    want[worker.VLM_ARCH] = {"prefill": logits.numpy(),
                             "cache_k": st.caches.k.numpy()}
    return got, want


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    tol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: {err} > {tol}"


@pytest.mark.parametrize("arch", RUNS)
@pytest.mark.parametrize("part", ["logits", "decode"])
def test_partitioned_lm_equals_one_device(runs, arch, part):
    got, want = runs
    keys = [k for k in want[arch] if k.split("_")[0] == part]
    assert len(keys) == (1 if part == "logits" else worker.DECODE_STEPS + 1)
    for r in range(worker.WORLD):
        for k in keys:
            _close(got[f"rank{r}"][arch][k], want[arch][k],
                   f"{arch} {k} rank {r}")


@pytest.mark.parametrize("arch", RUNS)
def test_partitioned_train_step_equals_one_device(runs, arch):
    got, want = runs
    w = want[arch]
    grads = [k for k in w if k.startswith("m/")]
    assert grads
    for r in range(worker.WORLD):
        g = got[f"rank{r}"][arch]
        _close(g["loss"], w["loss"], f"{arch} loss rank {r}")
        _close(g["grad_norm"], w["grad_norm"], f"{arch} norm rank {r}")
        assert sorted(g) == sorted(w)
        # the first moments are (1 - beta1) times the clipped gradient
        for name in grads:
            _close(g[name], w[name], f"{arch} grad {name} rank {r}")


def test_partitioned_vlm_prefill_equals_one_device(runs):
    got, want = runs
    for r in range(worker.WORLD):
        for part in ("prefill", "cache_k"):
            _close(got[f"rank{r}"][worker.VLM_ARCH][part],
                   want[worker.VLM_ARCH][part], f"vlm {part} rank {r}")


def test_counting_record_equals_gloo_rank(runs):
    got, _ = runs
    meta, real = got["counting"]["record"], got["rank0"]["record"]
    assert len(meta) == len(real) and len(meta) > 0
    for i, (a, b) in enumerate(zip(meta, real)):
        assert a == b, f"op {i}: {a} != {b}"
    assert any(e[0].startswith("_c10d_functional.") for e in real)
    assert got["counting"]["arg_bytes"] == got["rank0"]["arg_bytes"]


@pytest.mark.parametrize("kind", ["walker", "corpus"])
def test_ann_counting_collectives_equal_gloo_rank(runs, kind):
    """The ANN dry run's trace on the meta device (each loop body once)
    issues the collectives a gloo rank's one-trip search issues, op for
    op, and ranks 0 and 3 issue the same ones."""
    got, _ = runs
    meta, real = got["counting"]["ann"][kind], got["rank0"]["ann"][kind]
    assert len(meta) == len(real) and len(meta) > 0
    for i, (a, b) in enumerate(zip(meta, real)):
        assert a == b, f"{kind} collective {i}: {a} != {b}"
    assert real == got["rank3"]["ann"][kind]
    names = {e[0] for e in real}
    assert "c10d.allgather_.default" in names
    if kind == "walker":
        assert "c10d.allreduce_.default" in names


def test_rank_zero_record_equals_rank_three(runs):
    got, _ = runs
    assert got["rank0"]["record"] == got["rank3"]["record"]
    assert got["rank0"]["arg_bytes"] == got["rank3"]["arg_bytes"]


def test_op_counter_counts_local_flops_and_one_all_reduce(runs):
    got, _ = runs
    first, second = got["counting"]["matmul"]
    for run in (first, second):
        assert run["names"] == ["aten.mm.default",
                                "_c10d_functional.all_reduce.default"]
        assert run["flops"] == {"f32": 2 * 32 * 32 * 32}
        assert run["collectives"]["all-reduce"] == 32 * 32 * 4
        assert sum(run["collectives"].values()) == 32 * 32 * 4
    # the live peak counts the local product and its reduced copy, and is
    # the same when a second trace in the process finds DTensor's shape
    # propagation cached
    assert first["peak"] == second["peak"] == 2 * 32 * 32 * 4


def test_shard_move_is_one_all_to_all(runs):
    """A move from rows split over ``data`` to columns split over it is one
    all-to-all of the moved block on the counting group and on gloo, as on
    an NCCL mesh (DTensor's own CPU fallback gathers the whole tensor and
    keeps a chunk), and moves the right values."""
    got, _ = runs
    want = np.arange(64.).reshape(8, 8)
    for who in ("counting", "rank0", "rank3"):
        move = got[who]["shard_move"]
        assert move["names"] == ["_dtensor.shard_dim_alltoall.default"], who
        assert move["local"] == (8, 4), who
        assert move["collectives"]["all-to-all"] == 8 * 4 * 4, who
        assert sum(move["collectives"].values()) == 8 * 4 * 4, who
        if who != "counting":
            np.testing.assert_array_equal(np.asarray(move["whole"]), want)


@pytest.mark.parametrize("entry", ["build", "serve_ann", "serve_lm",
                                   "train"])
def test_real_paths_refuse_the_counting_group(runs, entry):
    got, _ = runs
    msg = got["counting"]["refused"][entry]
    assert msg is not None and "counting group" in msg

