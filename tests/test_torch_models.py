"""The port's model code against ``repro.models``, on the CPU.

The same numpy-seeded inputs go through the reference's function and its
port; a whole model crosses with its weights through
``models.convert.params_from_jax``.  Tolerances: float32 configs
(``dtype="float32"``) to rtol = atol = 1e-5; bf16 to 2e-2, and 3e-2 after
a decode step (the bounds of ``tests/test_models_smoke.py``).  Configs are
the smoke configs: 2 layers, d = 64, vocab 128.

A bf16 model is held against the reference run op by op
(``jax.disable_jit()``), where the port agrees to the last bit: compiled,
the reference's scanned layer fuses elementwise chains and skips some bf16
roundings, which moves a few of its own logits by up to 0.03 from its
op-by-op values at this size.  f32 models are held against the compiled
reference.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import attention as j_attn
from repro.models import build_model as j_build
from repro.models import common as j_common
from repro.models import mlp as j_mlp
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import attention as t_attn
from repro_torch.models import build_model
from repro_torch.models import common as t_common
from repro_torch.models import mlp as t_mlp
from repro_torch.models.convert import params_from_jax

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
DECODE_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _both(a, dtype):
    """A numpy array as (jax array, torch tensor), both in ``dtype``."""
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _cfg(arch, dtype):
    ref = dataclasses.replace(j_smoke(arch), dtype=dtype)
    return ref, dataclasses.replace(t_smoke(arch), dtype=dtype)


def _params(cfg_ref, cfg_port, seed=0):
    """The reference's random weights, and the port model holding them."""
    tree = j_build(cfg_ref).init(jax.random.PRNGKey(seed))
    return tree, params_from_jax(jax.tree.map(np.asarray, tree), cfg_port,
                                 device="cpu")


def _reference(dtype):
    return jax.disable_jit() if dtype == "bfloat16" \
        else contextlib.nullcontext()


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# common: norms and rotary embeddings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_matches(dtype):
    xj, xt = _both(_rand((2, 5, 64), 0, 3.0), dtype)
    scale = _rand((64,), 1) + 1.0
    tol = DTYPES[dtype][2]
    _close(t_common.rmsnorm({"scale": torch.from_numpy(scale)}, xt, 1e-5),
           j_common.rmsnorm({"scale": jnp.asarray(scale)}, xj, 1e-5), tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layernorm_matches(dtype):
    xj, xt = _both(_rand((2, 5, 64), 2, 3.0) + 1.0, dtype)
    p = {"scale": _rand((64,), 3) + 1.0, "bias": _rand((64,), 4)}
    _close(t_common.layernorm(_t(p), xt, 1e-5),
           j_common.layernorm({k: jnp.asarray(v) for k, v in p.items()}, xj,
                              1e-5), DTYPES[dtype][2])


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_angles_match(theta):
    pos = np.random.RandomState(5).randint(0, 600, size=(2, 7))
    got = t_common.rope_angles(torch.from_numpy(pos), 16, theta)
    want = j_common.rope_angles(jnp.asarray(pos), 16, theta)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_mrope_angles_match():
    pos = np.random.RandomState(6).randint(0, 600, size=(3, 2, 7))
    got = t_common.mrope_angles(torch.from_numpy(pos), 16, 1e6, (4, 2, 2))
    want = j_common.mrope_angles(jnp.asarray(pos), 16, 1e6, (4, 2, 2))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, 1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_rope_matches(dtype):
    pos = np.arange(7)[None].repeat(2, 0)
    cj, sj = j_common.rope_angles(jnp.asarray(pos), 16, 1e4)
    ct, st = t_common.rope_angles(torch.from_numpy(pos), 16, 1e4)
    xj, xt = _both(_rand((2, 7, 4, 16), 7), dtype)
    _close(t_common.apply_rope(xt, ct, st), j_common.apply_rope(xj, cj, sj),
           DTYPES[dtype][2])


@pytest.mark.parametrize("sq,sk,offset,window", [(5, 5, 0, 0), (3, 9, 6, 0),
                                                 (8, 8, 0, 3), (1, 12, 11, 4)])
def test_causal_mask_matches(sq, sk, offset, window):
    np.testing.assert_array_equal(
        t_attn.causal_mask(sq, sk, offset, window).numpy(),
        np.asarray(j_attn.causal_mask(sq, sk, offset, window)))


# ---------------------------------------------------------------------------
# attention and the MLPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sdpa_matches(dtype):
    cfg_j, cfg_t = _cfg("qwen2.5-3b", dtype)
    qj, qt = _both(_rand((2, 5, 4, 16), 8), dtype)
    kj, kt = _both(_rand((2, 7, 2, 16), 9), dtype)
    vj, vt = _both(_rand((2, 7, 2, 16), 10), dtype)
    mask = np.random.RandomState(11).rand(2, 1, 5, 7) < 0.7
    mask[..., 0] = True
    _close(t_attn._sdpa(qt, kt, vt, torch.from_numpy(mask), cfg_t),
           j_attn._sdpa(qj, kj, vj, jnp.asarray(mask), cfg_j),
           DTYPES[dtype][2])


def _attn_case(dtype, window=0):
    cfg_j, cfg_t = _cfg("qwen2.5-3b", dtype)
    if window:
        cfg_j = dataclasses.replace(cfg_j, sliding_window=window)
        cfg_t = dataclasses.replace(cfg_t, sliding_window=window)
    p = j_attn.attn_init(jax.random.PRNGKey(3), cfg_j)
    # non-zero biases, so that the bias path is held too
    p = {k: (v + 0.1 if k.endswith("_b") else v) for k, v in p.items()}
    pt = _t(p)
    xj, xt = _both(_rand((2, 6, 64), 12), dtype)
    pos = np.arange(6)[None].repeat(2, 0)
    rope_j = j_common.rope_angles(jnp.asarray(pos), 16, 1e4)
    rope_t = t_common.rope_angles(torch.from_numpy(pos), 16, 1e4)
    return cfg_j, cfg_t, p, pt, xj, xt, rope_j, rope_t


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attend_train_matches(dtype, window):
    cfg_j, cfg_t, p, pt, xj, xt, rj, rt = _attn_case(dtype, window)
    want, _ = j_attn.attend(p, xj, cfg_j, rope=rj, mode="train")
    got, _ = t_attn.attend(pt, xt, cfg_t, rope=rt, mode="train")
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attend_prefill_and_decode_match(dtype, window):
    cfg_j, cfg_t, p, pt, xj, xt, rj, rt = _attn_case(dtype, window)
    jd, td, tol = DTYPES[dtype]
    cache_j = j_attn.init_cache(cfg_j, 2, 9, 2, jd)
    cache_t = t_attn.init_cache(cfg_t, 2, 9, 2, td, device="cpu")
    want, cj = j_attn.attend(p, xj[:, :5], cfg_j,
                             rope=tuple(r[:, :5] for r in rj),
                             mode="prefill", cache=cache_j)
    got, ct = t_attn.attend(pt, xt[:, :5], cfg_t,
                            rope=tuple(r[:, :5] for r in rt),
                            mode="prefill", cache=cache_t)
    _close(got, want, tol)
    _close(ct.k, cj.k, tol)
    _close(ct.v, cj.v, tol)
    # one decode step at position 5, then a second at 6 (rows at
    # different positions: row 1 repeats position 5's write)
    for step, pos in enumerate(([5, 5], [6, 5])):
        x1j, x1t = xj[:, 5:6], xt[:, 5:6]
        pj, pt_ = jnp.asarray(pos, jnp.int32), torch.tensor(pos,
                                                            dtype=torch.int32)
        rope1_j = j_common.rope_angles(pj[:, None], 16, 1e4)
        rope1_t = t_common.rope_angles(pt_[:, None], 16, 1e4)
        want, cj = j_attn.attend(p, x1j, cfg_j, rope=rope1_j, mode="decode",
                                 cache=cj, pos=pj)
        got, ct = t_attn.attend(pt, x1t, cfg_t, rope=rope1_t, mode="decode",
                                cache=ct, pos=pt_)
        _close(got, want, DECODE_TOL[dtype])
        _close(ct.k, cj.k, DECODE_TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attend_cross_matches(dtype):
    cfg_j, cfg_t, p, pt, xj, xt, rj, rt = _attn_case(dtype)
    kvj, kvt = _both(_rand((2, 9, 64), 13), dtype)
    want, _ = j_attn.attend(p, xj, cfg_j, rope=rj, kv_x=kvj)
    got, _ = t_attn.attend(pt, xt, cfg_t, rope=rt, kv_x=kvt)
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_swiglu_matches(dtype):
    cfg_j, _ = _cfg("qwen2.5-3b", dtype)
    p = j_mlp.swiglu_init(jax.random.PRNGKey(4), cfg_j, jnp.float32)
    xj, xt = _both(_rand((2, 5, 64), 14), dtype)
    _close(t_mlp.swiglu(_t(p), xt), j_mlp.swiglu(p, xj), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gelu_mlp_matches(dtype):
    cfg_j, _ = _cfg("whisper-large-v3", dtype)
    p = j_mlp.gelu_mlp_init(jax.random.PRNGKey(5), cfg_j, dtype=jnp.float32)
    p = {k: (v + 0.05 if k.endswith("_b") else v) for k, v in p.items()}
    xj, xt = _both(_rand((2, 5, 64), 15), dtype)
    _close(t_mlp.gelu_mlp(_t(p), xt), j_mlp.gelu_mlp(p, xj),
           DTYPES[dtype][2])


# ---------------------------------------------------------------------------
# CausalLM: forward, prefill, decode_step
# ---------------------------------------------------------------------------

B, S = 2, 12


def _tokens(cfg, seed=2):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                               size=(B, S))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "llama3.2-3b", "yi-9b"])
def test_causal_lm_matches(arch, dtype):
    cfg_j, cfg_t = _cfg(arch, dtype)
    tree, params = _params(cfg_j, cfg_t)
    mj, mt = j_build(cfg_j), params
    tol = DTYPES[dtype][2]
    toks = _tokens(cfg_j)
    tt = torch.from_numpy(toks)
    with _reference(dtype):
        want, aux_j = mj.forward(tree, jnp.asarray(toks), remat=False)
    got, aux_t = mt.forward(params, tt, remat=False)
    _close(got, want, tol)
    assert float(aux_t) == float(aux_j) == 0.0

    with _reference(dtype):
        lp_j, st_j = mj.prefill(tree, jnp.asarray(toks[:, :S - 2]), S + 2)
    lp_t, st_t = mt.prefill(params, tt[:, :S - 2], S + 2)
    _close(lp_t, lp_j, tol)
    _close(st_t.caches.k, st_j.caches.k, tol)
    np.testing.assert_array_equal(st_t.pos.numpy(), np.asarray(st_j.pos))
    for i in (S - 2, S - 1):
        with _reference(dtype):
            ld_j, st_j = mj.decode_step(tree, st_j,
                                        jnp.asarray(toks[:, i:i + 1]))
        ld_t, st_t = mt.decode_step(params, st_t, tt[:, i:i + 1])
        _close(ld_t, ld_j, DECODE_TOL[dtype])
    np.testing.assert_array_equal(st_t.pos.numpy(), np.asarray(st_j.pos))
    _close(st_t.caches.v, st_j.caches.v, DECODE_TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_vlm_mrope_and_inputs_embeds_match(dtype):
    cfg_j, cfg_t = _cfg("qwen2-vl-7b", dtype)
    tree, params = _params(cfg_j, cfg_t, seed=1)
    mj, mt = j_build(cfg_j), params
    jd, td, tol = DTYPES[dtype]
    toks = _tokens(cfg_j, seed=3)
    rng = np.random.RandomState(4)
    # three position streams that differ (an image grid after text)
    pos = np.stack([np.arange(S), np.arange(S) // 3, np.arange(S) % 3])
    pos = np.broadcast_to(pos[:, None], (3, B, S)).copy()
    pos[1, 1] += rng.randint(0, 4, size=S)
    emb = (rng.normal(size=(B, S, 64)) * 0.5).astype(np.float32)
    ej, et = _both(emb, dtype)
    with _reference(dtype):
        want, _ = mj.forward(tree, jnp.asarray(toks),
                             positions=jnp.asarray(pos), inputs_embeds=ej,
                             remat=False)
    got, _ = mt.forward(params, torch.from_numpy(toks),
                        positions=torch.from_numpy(pos), inputs_embeds=et)
    _close(got, want, tol)
    # text only: (B, S) positions broadcast to the three streams
    with _reference(dtype):
        want, _ = mj.forward(tree, jnp.asarray(toks), remat=False)
    got, _ = mt.forward(params, torch.from_numpy(toks))
    _close(got, want, tol)
    with _reference(dtype):
        lp_j, st_j = mj.prefill(tree, jnp.asarray(toks[:, :S - 1]), S + 1,
                                positions=jnp.asarray(pos[:, :, :S - 1]))
    lp_t, st_t = mt.prefill(params, torch.from_numpy(toks[:, :S - 1]), S + 1,
                            positions=torch.from_numpy(pos[:, :, :S - 1]))
    _close(lp_t, lp_j, tol)
    with _reference(dtype):
        ld_j, _ = mj.decode_step(tree, st_j, jnp.asarray(toks[:, S - 1:]))
    ld_t, _ = mt.decode_step(params, st_t, torch.from_numpy(toks[:, S - 1:]))
    _close(ld_t, ld_j, DECODE_TOL[dtype])


def test_init_draws_reference_shapes_and_scales():
    cfg_j, cfg_t = _cfg("qwen2.5-3b", "float32")
    tree = j_build(cfg_j).init(jax.random.PRNGKey(0))
    params = build_model(cfg_t, device="cpu").init(
        torch.Generator().manual_seed(0))
    got = dict(params.named_parameters())
    assert got["embedding"].shape == tuple(tree["embedding"].shape)
    n_bias = 0
    for block, leaves in tree["layers"].items():
        for name, a in leaves.items():
            assert got[f"layers.{block}.{name}"].shape == a.shape, \
                (block, name)
            t = got[f"layers.{block}.{name}"][1]
            assert t.dtype == torch.float32
            # the same init scale: std within 20% of the reference's
            sa, st = float(np.std(np.asarray(a[1]))), float(t.std())
            assert (sa == st == 0.0) or abs(st / sa - 1) < 0.2, (block, name)
            n_bias += a.size if name.endswith("_b") else 0
    # param_count leaves the QKV biases out, in both packages
    assert sum(p.numel() for p in got.values()) \
        == cfg_t.param_count() + n_bias
