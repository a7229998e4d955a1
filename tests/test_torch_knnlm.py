"""kNN-LM of the port against ``repro.serve.knnlm``, on the CPU.

The reference's own end-to-end case (``tests/test_system.py``): the
qwen2.5 smoke config, a ``TokenStream`` of 3 batches of 4 × 23 tokens,
degree 8.  The reference's weights cross through ``params_from_jax``.

* ``_final_hidden`` (bf16, as the reference hard-codes) equals the
  reference's run op by op to 2e-2.
* ``build_datastore``: values and node count equal; its keys are no
  farther from the reference's datastore keys than the reference's own
  op-by-op run is (the reference's jit fuses some bf16 roundings away,
  which moves a few keys by up to two bf16 ulps).
* The port's build over the REFERENCE's keys gives the reference's graph,
  at ``build_batch`` 32 and 256 and ``build_backend`` ref and rowgather:
  the two knobs ``build_datastore`` adds change no bit of it.
* ``knnlm_logits`` on the reference's datastore, saved by ``repro`` and
  loaded by the port: ids equal, mixed log-probs within 1e-6.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import SearchParams as JParams
from repro.configs import get_smoke_config as j_smoke
from repro.data.tokens import TokenStream, _batch_at
from repro.models import build_model as j_build
from repro.serve import knnlm as jk
from repro_torch.ann import AnnIndex as TIndex
from repro_torch.ann import IndexSpec as TSpec
from repro_torch.ann import SearchParams as TParams
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import knnlm as tk

PARAMS = dict(k=8, queue_len=32, m_max=4, num_walkers=4)


@pytest.fixture(scope="module")
def case():
    cfg_j, cfg_t = j_smoke("qwen2.5-3b"), t_smoke("qwen2.5-3b")
    model_j = j_build(cfg_j)
    tree = model_j.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, tree), cfg_t,
                             device="cpu")
    stream = TokenStream(vocab_size=cfg_j.vocab_size, seq_len=24, batch=4,
                         seed=1, shard=0, num_shards=1)
    corpus = [_batch_at(stream, s)["tokens"] for s in range(3)]
    ds_j = jk.build_datastore(model_j, tree, [jnp.asarray(c) for c in corpus],
                              cfg_j.vocab_size, degree=8)
    with jax.disable_jit():
        eager = np.stack([np.asarray(jk._final_hidden(
            model_j, tree, jnp.asarray(c)), np.float32) for c in corpus])
    queries = _batch_at(stream, 7)["tokens"]
    ds_t = tk.build_datastore(params, params, corpus, cfg_j.vocab_size,
                              degree=8)
    return dict(cfg_j=cfg_j, model_j=model_j, tree=tree, params=params,
                corpus=corpus, ds_j=ds_j, ds_t=ds_t, eager=eager,
                queries=queries)


def test_final_hidden_matches(case):
    for c, want in zip(case["corpus"], case["eager"]):
        got = tk._final_hidden(case["params"], case["params"],
                               torch.from_numpy(c))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2)


def test_build_datastore_matches(case):
    ds_j, ds_t = case["ds_j"], case["ds_t"]
    assert ds_t.graph.n_nodes == ds_j.graph.n_nodes == 3 * 4 * 22
    np.testing.assert_array_equal(ds_t.values.numpy(),
                                  np.asarray(ds_j.values))
    assert ds_t.values.dtype == torch.int32
    assert ds_t.index.spec == TSpec(degree=8, knn_k=8, ef_construction=16,
                                    passes=1)
    want = np.asarray(ds_j.graph.vectors)
    eager = case["eager"][:, :, :-1].reshape(want.shape)
    spread = np.abs(eager - want).max()
    assert spread < 0.1
    assert np.abs(ds_t.graph.vectors.numpy() - want).max() <= spread


@pytest.mark.parametrize("build_batch,backend", [(32, "ref"),
                                                 (256, "rowgather")])
def test_port_build_of_reference_keys_is_reference_graph(case, build_batch,
                                                         backend):
    ds_j = case["ds_j"]
    keys = np.asarray(ds_j.graph.vectors)
    spec = TSpec(builder="nsg", metric="l2", degree=8, knn_k=8,
                 ef_construction=16, passes=1, build_batch=build_batch,
                 build_backend=backend)
    got = TIndex.build(keys, spec, device="cpu")
    np.testing.assert_array_equal(got.graph.nbrs.numpy(),
                                  np.asarray(ds_j.graph.nbrs))
    assert int(got.graph.medoid) == int(ds_j.graph.medoid)


def test_build_datastore_knobs_change_no_bit(case):
    base = case["ds_t"]
    ds = tk.build_datastore(case["params"], case["params"], case["corpus"],
                            case["cfg_j"].vocab_size, degree=8,
                            build_batch=7, build_backend="dedup_gather")
    assert (ds.index.spec.build_batch, ds.index.spec.build_backend) \
        == (7, "dedup_gather")
    assert torch.equal(ds.graph.nbrs, base.graph.nbrs)
    assert int(ds.graph.medoid) == int(base.graph.medoid)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_knnlm_logits_on_reference_datastore(case, metric, tmp_path):
    model_j, tree = case["model_j"], case["tree"]
    if metric == "l2":
        ds_j = case["ds_j"]
    else:
        ds_j = jk.build_datastore(model_j, tree,
                                  [jnp.asarray(c) for c in case["corpus"]],
                                  case["cfg_j"].vocab_size, degree=8,
                                  metric="ip")
    path = ds_j.index.save(os.path.join(tmp_path, "ds.npz"))
    np.save(os.path.join(tmp_path, "values.npy"), np.asarray(ds_j.values))
    ds_t = tk.KNNLMDatastore(
        index=TIndex.load(path, device="cpu"),
        values=torch.from_numpy(np.load(os.path.join(tmp_path,
                                                     "values.npy"))),
        vocab_size=case["cfg_j"].vocab_size)
    # the same (B, d) hidden states and (B, V) logits into both
    tokens = jnp.asarray(case["queries"])
    hidden = np.asarray(jk._final_hidden(model_j, tree, tokens)[:, -1],
                        np.float32)
    logits = np.asarray(model_j.forward(tree, tokens, remat=False)[0][:, -1],
                        np.float32)
    for cfg_j, cfg_t in ((JParams(**PARAMS), TParams(**PARAMS)),
                         (JParams(**PARAMS).to_search_config(metric),
                          TParams(**PARAMS).to_search_config(metric))):
        want, ids_j = jk.knnlm_logits(ds_j, jnp.asarray(hidden),
                                      jnp.asarray(logits), cfg_j)
        got, ids_t = tk.knnlm_logits(ds_t, torch.from_numpy(hidden),
                                     torch.from_numpy(logits), cfg_t)
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        assert np.allclose(np.exp(got.numpy()).sum(-1), 1.0, atol=1e-5)


def test_knnlm_logits_padding_ids_weigh_nothing(case):
    """Rows whose retrieved ids are all padding get p_knn = 0 (the masked
    softmax's NaN never reaches the mix)."""
    ds = case["ds_t"]
    n = ds.graph.n_nodes

    class Padded:
        graph = ds.graph

        def search(self, q, params):
            ids = torch.full((q.shape[0], 4), n, dtype=torch.int32)
            ids[0, 0] = 3
            dists = torch.where(ids < n, 1.0, float("inf"))
            return ids, dists, None

    logits = torch.randn((2, ds.vocab_size), generator=torch.Generator()
                         .manual_seed(0))
    mixed, _ = tk.knnlm_logits(ds._replace(index=Padded()),
                               torch.zeros((2, 64)), logits,
                               TParams(k=4), lam=0.25)
    p_lm = torch.softmax(logits, -1)
    torch.testing.assert_close(mixed[1], torch.log(0.75 * p_lm[1]))
    want0 = 0.75 * p_lm[0]
    want0[int(ds.values[3])] += 0.25
    torch.testing.assert_close(mixed[0], torch.log(want0))
