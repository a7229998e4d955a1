"""The port's configs, data, model registry, LM engine and serving launcher
against the reference, on the CPU.

* ``param_count``/``active_param_count`` and the other config facts equal
  ``repro.config``'s for all ten architectures.
* ``_batch_at``/``synthetic_batches`` and ``make_vector_dataset`` give the
  reference's arrays for the same seed.
* ``build_model`` builds every family (the encdec family's forward takes
  frames).
* ``ServeEngine.generate``: greedy tokens equal the JAX engine's in f32,
  also past the end of the cache; a sampled run repeats under one seed.
* ``decode_step`` is pure as the reference's: branches from one state
  give the reference's logits.
* ``python -m repro_torch.launch.serve --mode lm --smoke --device cpu``
  runs.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as j_config
import repro_torch.config as t_config
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get
from repro.configs import get_smoke_config as j_smoke
from repro.data import make_vector_dataset as j_vectors
from repro.data.tokens import TokenStream as JStream
from repro.data.tokens import _batch_at as j_batch_at
from repro.data.tokens import synthetic_batches as j_batches
from repro.models import build_model as j_build
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data import make_vector_dataset as t_vectors
from repro_torch.data.tokens import TokenStream
from repro_torch.data.tokens import _batch_at, synthetic_batches
from repro_torch.launch import serve as t_launch
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeEngine

# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_arch_ids_match():
    assert ARCH_IDS == J_ARCH_IDS


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_config_facts_match(arch):
    for ref, got in ((j_get(arch), get_config(arch)),
                     (j_smoke(arch), get_smoke_config(arch))):
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.param_count() == ref.param_count()
        assert got.active_param_count() == ref.active_param_count()
        assert got.resolved_head_dim == ref.resolved_head_dim
        assert got.is_subquadratic == ref.is_subquadratic
        assert json.loads(t_config.to_json(got)) \
            == json.loads(j_config.to_json(ref))


def test_shapes_mesh_and_train_configs_match():
    assert [dataclasses.asdict(s) for s in t_config.ALL_SHAPES] \
        == [dataclasses.asdict(s) for s in j_config.ALL_SHAPES]
    assert list(t_config.SHAPES_BY_NAME) == list(j_config.SHAPES_BY_NAME)
    for name in ("MeshConfig", "TrainConfig", "MoEConfig", "SSMConfig"):
        assert dataclasses.asdict(getattr(t_config, name)()) \
            == dataclasses.asdict(getattr(j_config, name)())
    assert t_config.MeshConfig((2, 4)).num_devices == 8
    assert t_config.ALL_FAMILIES == j_config.ALL_FAMILIES


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 5])
@pytest.mark.parametrize("vocab,seq_len,batch,seed,shard", [
    (128, 24, 4, 1, 0), (151936, 33, 2, 7, 3)])
def test_batch_at_matches(vocab, seq_len, batch, seed, shard, step):
    args = (vocab, seq_len, batch, seed, shard, 4)
    got = _batch_at(TokenStream(*args), step)
    want = j_batch_at(JStream(*args), step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_synthetic_batches_match():
    args = (128, 16, 2, 3, 1, 2)
    got, want = synthetic_batches(TokenStream(*args), start_step=4), \
        j_batches(JStream(*args), start_step=4)
    for _ in range(3):
        g, w = next(got), next(want)
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
    got.close()
    want.close()


@pytest.mark.parametrize("name,dim", [("sift", 16), ("deep", None)])
def test_make_vector_dataset_matches(name, dim):
    kw = dict(n=500, n_queries=12, k=10, n_clusters=8, seed=3, dim=dim)
    want = j_vectors(name, **kw)
    got = t_vectors(name, device="cpu", **kw)
    for f in ("base", "queries", "centers"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.gt_ids, want.gt_ids)
    np.testing.assert_allclose(got.gt_dists, want.gt_dists, rtol=1e-5,
                               atol=1e-3)
    assert got.name == want.name


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "llama3.2-3b", "yi-9b",
                                  "mistral-large-123b", "qwen2-vl-7b",
                                  "qwen3-moe-30b-a3b", "grok-1-314b",
                                  "mamba2-2.7b", "zamba2-7b",
                                  "whisper-large-v3"])
def test_build_model_builds_dense_and_vlm(arch):
    """Every family (dense, vlm, moe, ssm, hybrid, encdec) builds and runs
    a forward (a ``CausalLM``'s returns (logits, aux), the others' logits,
    as in the reference; the encdec family's takes frames first)."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert params is model and model.device == torch.device("cpu")
    toks = torch.zeros((1, 3), dtype=torch.int64)
    if cfg.family == "encdec":
        frames = torch.ones((1, cfg.encoder_ctx, cfg.d_model))
        logits = model.forward(params, frames, toks)
    else:
        logits = model.forward(params, toks)
    if isinstance(logits, tuple):
        logits = logits[0]
    assert logits.shape == (1, 3, cfg.vocab_size)
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# ServeEngine
# ---------------------------------------------------------------------------

def _engines(arch, dtype="float32", s_max=32):
    cfg_j = dataclasses.replace(j_smoke(arch), dtype=dtype)
    cfg_t = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    model_j = j_build(cfg_j)
    tree = model_j.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, tree), cfg_t,
                             device="cpu")
    return (JEngine(model_j, tree, s_max=s_max),
            ServeEngine(params, params, s_max=s_max))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "llama3.2-3b"])
def test_greedy_tokens_equal_jax_engine(arch):
    eng_j, eng_t = _engines(arch)
    prompt = np.random.RandomState(1).randint(0, 128, size=(3, 8))
    toks_j, last_j = eng_j.generate(jnp.asarray(prompt), steps=12)
    toks_t, last_t = eng_t.generate(prompt, steps=12)
    assert toks_t.dtype == torch.int32 and toks_t.shape == (3, 12)
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    np.testing.assert_allclose(last_t.float().numpy(),
                               np.asarray(last_j, np.float32), rtol=1e-5,
                               atol=1e-5)


def test_decode_past_s_max_equals_reference():
    """Positions 10 and 11 fall past a 10-slot cache: the reference drops
    those writes and attends over all 10 slots; so does the port."""
    eng_j, eng_t = _engines("qwen2.5-3b", s_max=10)
    prompt = np.random.RandomState(1).randint(0, 128, size=(3, 8))
    toks_j, last_j = eng_j.generate(jnp.asarray(prompt), steps=5)
    toks_t, last_t = eng_t.generate(prompt, steps=5)
    want = [[7, 6, 54, 54, 54], [71, 46, 72, 54, 54], [34, 117, 8, 70, 104]]
    np.testing.assert_array_equal(np.asarray(toks_j), want)
    np.testing.assert_array_equal(toks_t.numpy(), want)
    np.testing.assert_allclose(last_t.float().numpy(),
                               np.asarray(last_j, np.float32), rtol=1e-5,
                               atol=1e-5)


def test_decode_branches_from_one_state_equal_reference():
    """``decode_step`` leaves its input state as it was: two branches from
    one prefill, and a step after the first branch, give the reference's
    logits; ``inplace=True`` writes into the state it is given."""
    eng_j, eng_t = _engines("qwen2.5-3b", s_max=16)
    prompt = np.random.RandomState(1).randint(0, 128, size=(3, 8))
    mj, pj, mt, pt = eng_j.model, eng_j.params, eng_t.model, eng_t.params
    _, st_j = mj.prefill(pj, jnp.asarray(prompt), 16)
    _, st_t = mt.prefill(pt, torch.from_numpy(prompt), 16)
    before = st_t.caches.k.clone()
    got, want = [], []
    for model, params, st, tok, out in (
            (mj, pj, st_j, jnp.asarray, want),
            (mt, pt, st_t, torch.tensor, got)):
        la, sa = model.decode_step(params, st, tok([[5], [6], [7]]))
        lb, _ = model.decode_step(params, st, tok([[9], [10], [11]]))
        lc, _ = model.decode_step(params, sa, tok([[1], [2], [3]]))
        out += [np.asarray(x, np.float32) if out is want else x.numpy()
                for x in (la, lb, lc)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    assert torch.equal(st_t.caches.k, before)
    _, s2 = mt.decode_step(pt, st_t, torch.tensor([[5], [6], [7]]),
                           inplace=True)
    assert s2.caches.k is st_t.caches.k
    assert not torch.equal(st_t.caches.k, before)


def test_sampled_tokens_repeat_under_one_seed():
    _, eng = _engines("qwen2.5-3b", dtype="bfloat16")
    prompt = np.random.RandomState(2).randint(0, 128, size=(4, 6))
    a, _ = eng.generate(prompt, steps=10, temperature=0.8, seed=5)
    b, _ = eng.generate(prompt, steps=10, temperature=0.8, seed=5)
    c, _ = eng.generate(prompt, steps=10, temperature=0.8, seed=6)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert bool(((a >= 0) & (a < 128)).all())
    none, last = eng.generate(prompt, steps=0)
    assert none.shape == (4, 0) and last.shape == (4, 1, 128)


def test_launch_serve_lm_runs_on_cpu(capsys):
    t_launch.main(["--mode", "lm", "--smoke", "--arch", "qwen2.5-3b",
                   "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "lm-serve: arch=qwen2.5-smoke 2x16 tokens" in out
    assert "device=cpu" in out
