"""The port's gather-distance kernels against the reference's.

On the CPU each wrapper returns its plain version; those are held against
``repro``'s Pallas kernels (interpret mode) over the sweep of
``tests/test_kernels.py`` — rtol = atol = 1e-5 for f32, 2e-2 for bf16 — and
to exact equality on integer-valued data.  The kernels themselves are
held against these plain versions on the card by ``test_torch_cuda.py``.
"""
import os
import threading
import time
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dedup as j_dedup
from repro.kernels import ops as j_ops
from repro.kernels import registry as j_registry
from repro_torch.kernels import _cuda, registry
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.dedup import dedupdist, unique_ids_inverse
from repro_torch.kernels.l2dist import l2dist_dma, l2dist_rowgather

SWEEP = [
    (64, 8, 2, 16),
    (128, 128, 1, 32),
    (257, 96, 3, 8),     # non-power-of-two N, DEEP dims
    (50, 960, 1, 8),     # GIST dims
]
PORT = {"rowgather": l2dist_rowgather, "dma": l2dist_dma,
        "dedup_gather": dedupdist}


def _reference(impl, table, ids, q, metric):
    if impl == "dedup_gather":
        # the reference's dedupdist reads any metric but "ip" as l2; its
        # registry path lowers cosine to ip first, as the port's does
        kmetric = "ip" if metric in ("ip", "cosine") else metric
        return j_dedup.dedupdist(table, ids, q, metric=kmetric,
                                 interpret=True)
    return j_ops.l2dist(table, ids, q, impl=impl, metric=metric)


def _mk(n, d, b, c, bf16, seed=0, integer=False):
    """numpy inputs; a bf16 table is rounded once, in jax, and handed to
    torch through its exact f32 values."""
    rng = np.random.RandomState(seed)
    if integer:
        table = rng.randint(-8, 9, size=(n, d)).astype(np.float32)
        q = rng.randint(-8, 9, size=(b, d)).astype(np.float32)
    else:
        table = rng.normal(size=(n, d)).astype(np.float32)
        q = rng.normal(size=(b, d)).astype(np.float32)
    ids = rng.randint(0, n + 1, size=(b, c)).astype(np.int32)  # incl. pad
    jtable = jnp.asarray(table, jnp.bfloat16 if bf16 else jnp.float32)
    ttable = torch.from_numpy(np.array(jtable.astype(jnp.float32)))
    if bf16:
        ttable = ttable.to(torch.bfloat16)
    return (jtable, jnp.asarray(ids), jnp.asarray(q)), \
        (ttable, torch.from_numpy(ids), torch.from_numpy(q))


@pytest.mark.parametrize("impl", ["rowgather", "dma", "dedup_gather"])
@pytest.mark.parametrize("n,d,b,c", SWEEP)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plain_matches_reference_kernel(impl, n, d, b, c, bf16):
    (jt, ji, jq), (tt, ti, tq) = _mk(n, d, b, c, bf16)
    want = np.asarray(_reference(impl, jt, ji, jq, "l2"))
    got = PORT[impl](tt, ti, tq, metric="l2").numpy()
    tol = 2e-2 if bf16 else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert np.isinf(got[ti.numpy() >= n]).all()


@pytest.mark.parametrize("impl", ["rowgather", "dma", "dedup_gather"])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_plain_exact_on_integer_data(impl, metric):
    (jt, ji, jq), (tt, ti, tq) = _mk(200, 32, 4, 24, False, seed=5,
                                     integer=True)
    want = np.asarray(_reference(impl, jt, ji, jq, metric))
    got = PORT[impl](tt, ti, tq, metric=metric).numpy()
    np.testing.assert_array_equal(got, want)


def test_dma_ragged_candidates_and_registry_padding():
    (jt, ji, jq), (tt, ti, tq) = _mk(100, 16, 3, 13, False, seed=2)
    np.testing.assert_allclose(
        l2dist_dma(tt, ti, tq, g=8).numpy(),
        t_ref.dist_ref(tt, ti, tq).numpy(), rtol=1e-5, atol=1e-5)
    for tile in (4, 8):
        np.testing.assert_array_equal(
            registry.pad_ids_to_tile(ti, tile, 100).numpy(),
            np.asarray(j_registry.pad_ids_to_tile(ji, tile, 100)))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("tile", [1, 8])
def test_unique_ids_inverse_matches_reference(seed, tile):
    rng = np.random.RandomState(seed)
    n = 30
    ids = rng.randint(0, n + 5, size=(5, 11)).astype(np.int32)
    juniq, jinv, jn = j_dedup.unique_ids_inverse(jnp.asarray(ids), n, tile)
    tuniq, tinv, tn = unique_ids_inverse(torch.from_numpy(ids), n, tile)
    np.testing.assert_array_equal(tuniq.numpy(), np.asarray(juniq))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    assert int(tn) == int(jn)


def test_registry_names_and_errors():
    assert set(registry.available_backends()) == set(
        j_registry.available_backends())
    assert set(registry.available_backends()) == {
        "ref", "rowgather", "dma", "dedup_gather", "ref_int8",
        "rowgather_int8", "dedup_gather_int8", "ref_bf16"}
    from repro_torch.core.config import SearchConfig
    with pytest.raises(ValueError, match="available"):
        registry.resolve_backend(SearchConfig(dist_backend="rowgather_fp8"))


@pytest.mark.parametrize("bad", ["ids_dtype", "query_dtype", "shape",
                                 "table_dtype"])
def test_wrappers_check_inputs(bad):
    table = torch.zeros((10, 8))
    ids = torch.zeros((2, 4), dtype=torch.int32)
    q = torch.zeros((2, 8))
    if bad == "ids_dtype":
        ids = ids.long()
    elif bad == "query_dtype":
        q = q.double()
    elif bad == "shape":
        q = torch.zeros((3, 8))
    else:
        table = table.half()
    for fn in PORT.values():
        with pytest.raises((TypeError, ValueError)):
            fn(table, ids, q)


def _threads(target, n=2):
    """Run ``target(i)`` on ``n`` threads started together; returns their
    results in thread order."""
    start, out = threading.Barrier(n), [None] * n

    def run(i):
        start.wait(timeout=10)
        out[i] = target(i)
    ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    return out


def test_first_use_from_two_threads_builds_and_loads_once(monkeypatch):
    built, loaded = [], []

    def slow_build(names):
        built.append(list(names))
        time.sleep(0.05)            # the other thread arrives meanwhile
        return list(names)

    class FakeLib:
        def __init__(self, path):
            loaded.append(path)

        def __getattr__(self, entry):
            return types.SimpleNamespace(name=entry)

    monkeypatch.setattr(_cuda, "_FUNCS", {})
    monkeypatch.setattr(_cuda, "build", slow_build)
    monkeypatch.setattr(_cuda.ctypes, "CDLL", FakeLib)
    fns = _threads(lambda i: _cuda._func("rowgather"))
    assert built == [["rowgather"]] and len(loaded) == 1
    assert fns[0] is fns[1] and fns[0].name == "rowgather_launch"


def test_build_from_two_threads_runs_nvcc_once(monkeypatch, tmp_path):
    runs = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            runs.append(cmd)
            self.out = Path(cmd[cmd.index("-o") + 1])
            self.returncode = 0

        def communicate(self):
            time.sleep(0.05)
            self.out.write_bytes(b"")
            return "", ""

    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_cuda.subprocess, "Popen", FakeNvcc)
    got = _threads(lambda i: _cuda.build(["bitonic"]))
    assert sorted(got) == [[], ["bitonic"]]
    assert len(runs) == 1
    tmp = Path(runs[0][runs[0].index("-o") + 1]).name
    assert f".{os.getpid()}." in tmp and tmp.endswith(".tmp")
    assert [p.name for p in tmp_path.iterdir()] == [
        _cuda._lib_path("bitonic").name]
