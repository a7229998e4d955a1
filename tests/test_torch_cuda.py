"""The CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device (the kernels are CUDA C++ with no CPU
mode) and skips without one.  The file imports no JAX, so it also runs on a
machine with the card and without JAX::

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import knn_graph, make_padded_csr
from repro_torch.core.bfis import search_topm_batch
from repro_torch.core.config import SearchConfig
from repro_torch.core.speedann import search_speedann_batch
from repro_torch.kernels import _cuda
from repro_torch.kernels import ref
from repro_torch.kernels.dedup import dedupdist
from repro_torch.kernels.l2dist import l2dist_dma, l2dist_rowgather

pytestmark = pytest.mark.cuda

KERNELS = {"l2dist_rowgather": (l2dist_rowgather, ref.dist_ref),
           "l2dist_dma": (l2dist_dma, ref.dist_expanded_ref),
           "dedupdist": (dedupdist, ref.dist_ref)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "CPU mode (their plain versions are tested on the CPU)")
    return torch.device("cuda")


def _inputs(n, d, b, c, seed, integer=False, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    if integer:
        table = rng.randint(0, 256, size=(n, d)).astype(np.float32)
        q = rng.randint(0, 256, size=(b, d)).astype(np.float32)
    else:
        table = rng.normal(size=(n, d)).astype(np.float32)
        q = rng.normal(size=(b, d)).astype(np.float32)
    ids = rng.randint(0, n + 1, size=(b, c)).astype(np.int32)
    return (torch.from_numpy(table).to("cuda", dtype),
            torch.from_numpy(ids).cuda(), torch.from_numpy(q).cuda())


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("n,d,b,c", [(64, 8, 2, 16), (257, 96, 3, 8),
                                     (50, 960, 1, 8), (5000, 128, 512, 32),
                                     (5000, 128, 64, 250), (300, 20, 4, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda_device, kernel, n, d, b, c, dtype):
    table, ids, q = _inputs(n, d, b, c, seed=11, dtype=dtype)
    fn, plain = KERNELS[kernel]
    before = _cuda.LAUNCHES[kernel]
    got = fn(table, ids, q, metric="l2")
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[kernel] == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got, plain(table, ids, q, "l2"), rtol=tol,
                               atol=tol)
    assert bool(torch.isinf(got[ids >= n]).all())


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("d", [128, 20])
def test_kernels_exact_on_integer_data(cuda_device, metric, d):
    table, ids, q = _inputs(3000, d, 64, 256, seed=12, integer=True)
    want = ref.dist_ref(table, ids, q, metric)
    outs = {k: fn(table, ids, q, metric=metric)
            for k, (fn, _) in KERNELS.items()}
    for k, got in outs.items():
        assert torch.equal(got, want), k


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_negative_ids_read_row_zero(cuda_device, kernel):
    table, ids, q = _inputs(300, 128, 8, 16, seed=14, integer=True)
    ids[:, ::3] = -1
    ids[:, 1] = -7
    fn, plain = KERNELS[kernel]
    got = fn(table, ids, q, metric="l2")
    assert torch.equal(got, plain(table, ids, q, "l2"))
    assert torch.equal(got[:, 1], plain(table, torch.zeros_like(ids), q,
                                        "l2")[:, 1])


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_dedup_bitwise_equals_rowgather(cuda_device, metric):
    table, ids, q = _inputs(4000, 128, 512, 32, seed=13)
    ids[1::2] = ids[0::2]          # walkers sharing candidates
    assert torch.equal(dedupdist(table, ids, q, metric=metric),
                       l2dist_rowgather(table, ids, q, metric=metric))


@pytest.mark.parametrize("backend", ["rowgather", "dma", "dedup_gather"])
@pytest.mark.parametrize("algo", ["topm", "speedann"])
def test_search_on_card_equals_plain_search_on_cpu(cuda_device, backend,
                                                   algo):
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randint(0, 256, size=(2000, 32))
                         .astype(np.float32))
    q = torch.from_numpy(rng.randint(0, 256, size=(16, 32))
                         .astype(np.float32))
    nbrs = torch.cat([knn_graph(x, 12), torch.from_numpy(
        rng.randint(0, 2000, size=(2000, 4)).astype(np.int32))], dim=1)
    cfg = SearchConfig(k=10, queue_len=32, m_max=4, num_walkers=4,
                       dist_backend=backend)
    fn = {"topm": search_topm_batch, "speedann": search_speedann_batch}[algo]
    want = fn(make_padded_csr(nbrs, x, device="cpu"), q, cfg)
    got = fn(make_padded_csr(nbrs, x, device="cuda"), q.cuda(), cfg)
    for w, g in zip(want[:2], got[:2]):
        assert torch.equal(w, g.cpu())
    for w, g in zip(want[2], got[2]):
        assert torch.equal(w, g.cpu())
