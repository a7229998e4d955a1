"""The port's moe family against ``repro.models.moe``, ``moe_a2a`` and the
moe ``CausalLM``, on the CPU.

* ``moe_ffn``, its aux loss and its gradients (``x``, the router and the
  three expert stacks) equal the reference's at capacity factor 4.0
  (nothing drops) and 1.0 (tokens drop, the same ones); a router of zeros
  ties every probability, and both route every token to experts
  0..k−1.  bf16 is held against the reference run op by op.
* The lane paths: ``tests/torch_moe_ref.py`` runs ``moe_ffn_sharded`` on
  a (2, 4) mesh of 8 forced XLA host devices (jitted, a process of its
  own) for the a2a path (8 experts) and the tp path (2 experts) at
  capacity factors 8.0 and 1.0, and one qwen3-moe smoke forward under
  ``use_rules`` with ``set_moe_impl("a2a")``; the port's lanes on the CPU
  give the same outputs and aux losses.
* qwen3-moe-smoke and grok1-smoke through ``params_from_jax``: forward
  logits and aux (f32, and bf16 against the reference op by op), prefill
  and decode, loss and every gradient leaf, greedy ``ServeEngine``
  tokens; one AdamW step; a checkpoint that crosses both ways.
* ``launch/serve.py`` and ``launch/train.py`` run the moe smoke config on
  the CPU.

Tolerances: f32 1e-5 (aux 1e-6); bf16 2e-2, the bound of
``tests/test_torch_models.py``.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
import repro.optim as jopt
import torch_moe_ref as ref_case
from repro.config import MoEConfig as JMoEConfig
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as j_smoke
from repro.data.tokens import TokenStream as JStream
from repro.data.tokens import _batch_at as j_batch_at
from repro.models import build_model as j_build
from repro.models import moe as j_moe
from repro.serve import ServeEngine as JEngine
from repro.sharding import keystr_simple as j_keystr
from repro.train.train_step import TrainState as JTrainState
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch import checkpoint as tckpt
from repro_torch.config import ModelConfig, MoEConfig, TrainConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.distributed import make_search_mesh
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import build_model
from repro_torch.models import moe as t_moe
from repro_torch.models import moe_a2a as t_a2a
from repro_torch.models.convert import (params_from_jax, params_to_jax,
                                        tree_from_jax)
from repro_torch.models.transformer import params_tree
from repro_torch.serve import ServeEngine
from repro_torch.sharding import DEFAULT_RULES, use_rules
from repro_torch.train import make_train_step
from repro_torch.train.convert import state_from_jax
from repro_torch.train.train_step import _zeros, loss_and_grad
from repro_torch.treepath import flatten_with_path, keystr_simple

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCHS = ["qwen3-moe-30b-a3b", "grok-1-314b"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny ops: one intra-op thread a worker of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _smoke(arch, dtype="float32", **moe):
    ref = j_smoke(arch)
    port = get_smoke_config(arch)
    return (dataclasses.replace(ref, dtype=dtype,
                                moe=dataclasses.replace(ref.moe, **moe)),
            dataclasses.replace(port, dtype=dtype,
                                moe=dataclasses.replace(port.moe, **moe)))


def _kept(top_e, cap, e):
    """The reference's keep mask of (token, slot) pairs (moe.py:69-72)."""
    flat = np.asarray(top_e).reshape(-1)
    onehot = np.eye(e, dtype=np.int64)[flat]
    pos = ((np.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    return pos < cap


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

FFN_CASES = [("float32", 4.0, False), ("float32", 1.0, False),
             ("float32", 1.0, True), ("bfloat16", 1.0, False)]


@pytest.mark.parametrize("dtype,cf,zero_router", FFN_CASES,
                         ids=["f32-cf4", "f32-cf1-drops", "f32-zero-router",
                              "bf16-cf1"])
def test_moe_ffn_matches(dtype, cf, zero_router):
    cfg_j, cfg_t = _smoke("qwen3-moe-30b-a3b", dtype, capacity_factor=cf)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    p = j_moe.moe_init(jax.random.PRNGKey(1), cfg_j, jdt)
    if zero_router:
        p["router"] = jnp.zeros_like(p["router"])
    x = np.random.RandomState(2).normal(size=(3, 16, 64)).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    if dtype == "bfloat16":
        with jax.disable_jit():
            want, aux_j = j_moe.moe_ffn(p, xj, cfg_j)
    else:
        want, aux_j = jax.jit(lambda pp, xx: j_moe.moe_ffn(pp, xx, cfg_j))(
            p, xj)
    pt = tree_from_jax(jax.tree.map(np.asarray, p), "cpu")
    xt = torch.from_numpy(x).to(pt["moe_gate"].dtype)
    got, aux_t = t_moe.moe_ffn(pt, xt, cfg_t)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    _close(got, want, TOL[dtype])
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=0,
                               atol=1e-6)
    # the same routing, and at cf 1 the same dropped pairs
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, 64).astype(
        jnp.float32) @ p["router"], axis=-1)
    _, top_e = jax.lax.top_k(probs, cfg_j.moe.top_k)
    _, _, top_t = t_moe.route(xt.reshape(-1, 64), pt["router"],
                              cfg_t.moe.top_k)
    np.testing.assert_array_equal(top_t.numpy(), np.asarray(top_e))
    cap = t_moe._capacity(cfg_t, 48)
    assert cap == j_moe._capacity(cfg_j, 48)
    kept = _kept(top_e, cap, cfg_j.moe.num_experts)
    assert (kept.all() if cf == 4.0 and not zero_router
            else (~kept).sum() > 0)
    if zero_router:
        # every probability ties: the lowest experts win, as lax.top_k's
        np.testing.assert_array_equal(
            top_t.numpy(), np.broadcast_to([0, 1], (48, 2)))


@pytest.mark.parametrize("cf", [4.0, 1.0])
def test_moe_ffn_gradients_match(cf):
    """jax.grad against torch.autograd of ``x``, the router and the three
    expert stacks, through a loss that weighs every output entry."""
    cfg_j, cfg_t = _smoke("qwen3-moe-30b-a3b", capacity_factor=cf)
    p = j_moe.moe_init(jax.random.PRNGKey(3), cfg_j, jnp.float32)
    x = np.random.RandomState(4).normal(size=(2, 24, 64)).astype(np.float32)
    w = np.random.RandomState(5).normal(size=(2, 24, 64)).astype(np.float32)

    def loss_j(pp, xx):
        y, aux = j_moe.moe_ffn(pp, xx, cfg_j)
        return jnp.sum(y * w) + aux
    gp, gx = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(p, jnp.asarray(x))
    pt = {k: v.requires_grad_(True) for k, v in
          tree_from_jax(jax.tree.map(np.asarray, p), "cpu").items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = t_moe.moe_ffn(pt, xt, cfg_t)
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    for k, g in gp.items():
        scale = float(np.abs(np.asarray(g)).max())
        np.testing.assert_allclose(pt[k].grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-5 * scale, err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-5 * float(np.abs(gx).max()))


@pytest.mark.parametrize("tokens", [8, 48, 4096, 4352])
def test_capacity_is_the_reference_integer(tokens):
    """``_capacity`` at qwen3-moe's full routing (128 experts, top-8),
    at its capacity factor and at E/k (capacity = tokens), and at the
    smoke's; a decode batch of 8 gets 8 slots an expert."""
    full = get_config("qwen3-moe-30b-a3b")
    for cfg in (full, get_smoke_config("qwen3-moe-30b-a3b"),
                dataclasses.replace(full, moe=dataclasses.replace(
                    full.moe, capacity_factor=16.0))):
        jcfg = dataclasses.replace(j_smoke("qwen3-moe-30b-a3b"),
                                   moe=JMoEConfig(**dataclasses.asdict(
                                       cfg.moe)))
        assert t_moe._capacity(cfg, tokens) == j_moe._capacity(jcfg, tokens)
    assert t_moe._capacity(full, 8) == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_build(arch):
    """The full-width configs build; construction draws no weights."""
    cfg = get_config(arch)
    model = build_model(cfg, device="cpu")
    assert model.cfg is cfg and not list(model.parameters())


def test_moe_ffn_sharded_without_mesh_is_moe_ffn():
    _, cfg = _smoke("grok-1-314b")
    p = t_moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn((2, 8, 64), generator=torch.Generator().manual_seed(1))
    y0, a0 = t_moe.moe_ffn(p, x, cfg)
    y1, a1 = t_a2a.moe_ffn_sharded(p, x, cfg)
    assert torch.equal(y0, y1) and torch.equal(a0, a1)


# ---------------------------------------------------------------------------
# the lane paths, against the reference on 8 devices
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_moe_ref.py"),
         str(out)], capture_output=True, text=True, timeout=120, env=env)
    assert run.returncode == 0, run.stdout + "\n" + run.stderr
    assert "REFERENCE_OK" in run.stdout
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _mesh():
    return make_search_mesh(*ref_case.MESH, device="cpu")


@pytest.mark.parametrize("case", ref_case.FFN_CASES,
                         ids=[c[0] for c in ref_case.FFN_CASES])
def test_lane_paths_match_reference_mesh(mesh_ref, case):
    name, e, cf = case
    r = ref_case.ffn_config(e, cf)
    cfg = ModelConfig(**{f.name: getattr(r, f.name) for f in
                         dataclasses.fields(r) if f.name != "moe"},
                      moe=MoEConfig(**dataclasses.asdict(r.moe)))
    p = {k: torch.from_numpy(mesh_ref[f"{name}/p/{k}"])
         for k in ("router", "moe_gate", "moe_up", "moe_down")}
    x = torch.from_numpy(mesh_ref[f"{name}/x"])
    with use_rules(DEFAULT_RULES, _mesh()):
        y, aux = t_a2a.moe_ffn_sharded(p, x, cfg)
    _close(y, mesh_ref[f"{name}/y"], 1e-5)
    np.testing.assert_allclose(float(aux), float(mesh_ref[f"{name}/aux"]),
                               rtol=0, atol=1e-6)
    if cf == 8.0:
        # nothing drops: the lanes compute moe_ffn
        y0, aux0 = t_moe.moe_ffn(p, x, cfg)
        _close(y, y0.numpy(), 1e-5)
        np.testing.assert_allclose(float(aux), float(aux0), atol=1e-6)


def test_causal_lm_a2a_forward_matches_reference_mesh(mesh_ref):
    _, cfg = _smoke(ref_case.LM_ARCH)
    tree = {}
    for k, v in mesh_ref.items():
        if k.startswith("lm/p/"):
            node = tree
            *parents, leaf = k[len("lm/p/"):].split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = v
    model = params_from_jax(tree, cfg, device="cpu")
    toks = torch.from_numpy(mesh_ref["lm/tokens"])
    t_a2a.set_moe_impl("a2a")
    try:
        with use_rules(DEFAULT_RULES, _mesh()):
            logits, aux = model.forward(model, toks, remat=False)
    finally:
        t_a2a.set_moe_impl("gspmd")
    _close(logits, mesh_ref["lm/logits"], 1e-5)
    np.testing.assert_allclose(float(aux), float(mesh_ref["lm/aux"]),
                               rtol=0, atol=1e-6)


def test_mesh_on_another_device_raises():
    _, cfg = _smoke("qwen3-moe-30b-a3b")
    p = t_moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    mesh = make_search_mesh((1, 4), device="meta")
    with use_rules(DEFAULT_RULES, mesh):
        with pytest.raises(ValueError, match=r"§1 item 8"):
            t_a2a.moe_ffn_sharded(p, torch.zeros((1, 4, 64)), cfg)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

B, S = 2, 12


def _models(arch, dtype="float32"):
    cfg_j, cfg_t = _smoke(arch, dtype)
    tree = j_build(cfg_j).init(jax.random.PRNGKey(0))
    return (cfg_j, cfg_t, tree,
            params_from_jax(jax.tree.map(np.asarray, tree), cfg_t,
                            device="cpu"))


def _tokens(vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, S))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_lm_forward_prefill_decode_match(arch):
    """f32: logits and aux of the forward, the prefill's last logits and
    two decode steps (a decode batch of 2 tokens keeps every pair)."""
    cfg_j, cfg_t, tree, params = _models(arch)
    mj = j_build(cfg_j)
    toks = _tokens(cfg_j.vocab_size)
    tt = torch.from_numpy(toks)
    want, aux_j = mj.forward(tree, jnp.asarray(toks), remat=False)
    got, aux_t = params.forward(params, tt, remat=False)
    _close(got, want, 1e-5)
    assert float(aux_j) > 0
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=0,
                               atol=1e-6)
    lp_j, st_j = mj.prefill(tree, jnp.asarray(toks[:, :S - 2]), S + 2)
    lp_t, st_t = params.prefill(params, tt[:, :S - 2], S + 2)
    _close(lp_t, lp_j, 1e-5)
    for i in (S - 2, S - 1):
        ld_j, st_j = mj.decode_step(tree, st_j,
                                    jnp.asarray(toks[:, i:i + 1]))
        ld_t, st_t = params.decode_step(params, st_t, tt[:, i:i + 1])
        _close(ld_t, ld_j, 1e-5)
    _close(st_t.caches.v, st_j.caches.v, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_lm_bf16_forward_matches_op_by_op(arch):
    """bf16 storage and compute: the forward's logits and aux against the
    reference run op by op (its compiled scan skips bf16 roundings)."""
    cfg_j, _, tree, params = _models(arch, "bfloat16")
    toks = _tokens(cfg_j.vocab_size, seed=1)
    with jax.disable_jit():
        want, aux_j = j_build(cfg_j).forward(tree, jnp.asarray(toks),
                                             remat=False)
    got, aux_t = params.forward(params, torch.from_numpy(toks), remat=False)
    assert got.dtype == torch.bfloat16
    _close(got, want, TOL["bfloat16"])
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=0,
                               atol=1e-6)


def _batch(cfg):
    return j_batch_at(JStream(cfg.vocab_size, 17, 4, 0, 0, 1), 0)


def _tbatch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _flat_j(tree) -> dict:
    return {j_keystr(p): np.asarray(leaf, np.float32) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree) -> dict:
    return {keystr_simple(p): leaf.detach().float().numpy()
            for p, leaf in flatten_with_path(tree)}


def _close_leaves(got: dict, want: dict, rtol: float):
    """Every leaf within ``rtol`` of its largest reference magnitude."""
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                   atol=rtol * scale, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_lm_loss_and_gradients_match(arch):
    cfg_j, cfg_t, tree, _ = _models(arch)
    batch = _batch(cfg_j)
    loss_j, grads_j = jax.jit(jax.value_and_grad(j_build(cfg_j).loss))(
        tree, jax.tree.map(jnp.asarray, batch))
    params = tree_from_jax(jax.tree.map(np.asarray, tree), "cpu")
    grads = _zeros(params)
    loss = loss_and_grad(build_model(cfg_t, device="cpu"), params,
                         _tbatch(batch), True, grads)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    flat = _flat_t(grads)
    assert {"layers/moe/router", "layers/moe/moe_gate", "layers/moe/moe_up",
            "layers/moe/moe_down"} <= set(flat)
    _close_leaves(flat, _flat_j(grads_j), 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_greedy_tokens_equal_jax_engine(arch):
    cfg_j, _, tree, params = _models(arch)
    eng_j = JEngine(j_build(cfg_j), tree, s_max=24)
    eng_t = ServeEngine(params, params, s_max=24)
    prompt = np.random.RandomState(1).randint(0, 128, size=(3, 8))
    toks_j, last_j = eng_j.generate(jnp.asarray(prompt), steps=10)
    toks_t, last_t = eng_t.generate(prompt, steps=10)
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    _close(last_t, last_j, 1e-5)


def test_moe_train_step_equals_reference():
    """One AdamW step of qwen3-moe-smoke: loss, gradient norm and the
    moments (m is linear in the gradient) at 1e-5; each parameter within
    two learning rates (Adam's first step is lr·sign(g))."""
    cfg_j, cfg_t, tree, _ = _models("qwen3-moe-30b-a3b")
    tkw = dict(total_steps=30, warmup_steps=2, learning_rate=3e-3)
    jcfg = JTrainConfig(**tkw)
    j_init, _ = jopt.make_optimizer(jcfg)
    state_j = JTrainState(tree, j_init(tree, jcfg), None)
    batch = _batch(cfg_j)
    new_j, m_j = jax.jit(j_make_train_step(j_build(cfg_j), jcfg))(
        state_j, jax.tree.map(jnp.asarray, batch))
    state = state_from_jax(jax.tree.map(np.asarray, state_j), "cpu")
    new_t, m_t = make_train_step(build_model(cfg_t, device="cpu"),
                                 TrainConfig(**tkw))(state, _tbatch(batch))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5)
    _close_leaves(_flat_t(new_t.opt), _flat_j(new_j.opt), 1e-5)
    got, want = _flat_t(new_t.params), _flat_j(new_j.params)
    lr1 = tkw["learning_rate"] / tkw["warmup_steps"]
    for k in want:
        assert float(np.abs(got[k] - want[k]).max()) <= 2 * lr1 + 1e-6, k


def test_moe_checkpoint_crosses_both_ways(tmp_path):
    """The moe leaves (router, moe_gate, moe_up, moe_down stacked on
    layers) through ``params_from_jax``/``params_to_jax`` and a checkpoint
    each way, bit for bit."""
    _, _, tree, params = _models("grok-1-314b")
    ref = jax.tree.map(np.asarray, tree)
    assert ref["layers"]["moe"]["moe_gate"].shape == (2, 4, 64, 64)
    _close_leaves(_flat_j(params_to_jax(params)), _flat_j(ref), 0.0)
    tckpt.save_checkpoint(str(tmp_path / "port"), 2, params_tree(params))
    got = jckpt.load_checkpoint(str(tmp_path / "port"), 2,
                                jax.tree.map(jnp.zeros_like, tree))
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, got), ref)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 2, tree)
    like = tree_from_jax(jax.tree.map(np.zeros_like, ref), "cpu")
    loaded = tckpt.load_checkpoint(str(tmp_path / "ref"), 2, like)
    _close_leaves(_flat_t(loaded), _flat_j(ref), 0.0)


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def test_launch_serve_moe_runs_on_cpu(capsys):
    t_serve.main(["--mode", "lm", "--smoke", "--arch", "qwen3-moe-30b-a3b",
                  "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "lm-serve: arch=qwen3-moe-smoke 2x16 tokens" in out
    assert "device=cpu" in out


def test_launch_train_moe_runs_on_cpu(tmp_path, capsys):
    t_train.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--steps", "3",
                  "--seq", "17", "--batch", "4", "--device", "cpu",
                  "--ckpt-dir", str(tmp_path)])
    assert "done: arch=qwen3-moe-smoke loss" in capsys.readouterr().out
