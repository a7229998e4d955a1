"""Checks of a whole port LM against ``repro``'s on the CPU, shared by the
ssm and hybrid test files (``test_torch_ssm.py``, ``test_torch_zamba2.py``).

Each check builds the reference's smoke model from ``PRNGKey(0)`` weights
and the port model holding them (``params_from_jax``), feeds both the
same numpy-seeded tokens and compares: f32 at rtol = atol = 1e-5 (every
gradient leaf relative to its largest magnitude), bf16 against the
reference run op by op (``jax.disable_jit()``) at 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.checkpoint as jckpt
import repro.optim as jopt
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as j_smoke
from repro.data.tokens import TokenStream as JStream
from repro.data.tokens import _batch_at as j_batch_at
from repro.models import build_model as j_build
from repro.sharding import keystr_simple as j_keystr
from repro.serve import ServeEngine as JEngine
from repro.train.train_step import TrainState as JTrainState
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch import checkpoint as tckpt
from repro_torch.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import build_model
from repro_torch.models.convert import (params_from_jax, params_to_jax,
                                        tree_from_jax)
from repro_torch.models.params import params_tree
from repro_torch.serve import ServeEngine
from repro_torch.train import make_train_step
from repro_torch.train.convert import state_from_jax
from repro_torch.train.train_step import _zeros, loss_and_grad
from repro_torch.treepath import flatten_with_path, keystr_simple, tree_leaves

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, S = 2, 12


def close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def configs(arch, dtype="float32", **kw):
    """The reference's and the port's smoke configs of ``arch``, with
    ``dtype`` and the fields ``kw`` replaced."""
    return (dataclasses.replace(j_smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw))


def models(arch, dtype="float32", **kw):
    """(reference config, port config, reference tree, port model holding
    it)."""
    cfg_j, cfg_t = configs(arch, dtype, **kw)
    tree = j_build(cfg_j).init(jax.random.PRNGKey(0))
    return cfg_j, cfg_t, tree, params_from_jax(
        jax.tree.map(np.asarray, tree), cfg_t, device="cpu")


def tokens(vocab, seed=0, shape=(B, S)):
    return np.random.RandomState(seed).randint(0, vocab, size=shape)


def close_states(got, want, tol):
    """Every leaf of a port decode state against the reference's."""
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        close(a, b, tol)


def check_forward_prefill_decode(arch, **kw):
    """f32: the forward's logits, the prefill's last logits and state, and
    two decode steps' logits and states."""
    cfg_j, _, tree, params = models(arch, **kw)
    mj = j_build(cfg_j)
    toks = tokens(cfg_j.vocab_size)
    tt = torch.from_numpy(toks)
    close(params.forward(params, tt, remat=False),
          jax.jit(mj.forward, static_argnames=("remat",))(
              tree, jnp.asarray(toks), remat=False), 1e-5)
    lp_j, st_j = jax.jit(mj.prefill, static_argnums=(2,))(
        tree, jnp.asarray(toks[:, :S - 2]), S + 2)
    lp_t, st_t = params.prefill(params, tt[:, :S - 2], S + 2)
    close(lp_t, lp_j, 1e-5)
    close_states(st_t, st_j, 1e-5)
    j_step = jax.jit(mj.decode_step)
    for i in (S - 2, S - 1):
        ld_j, st_j = j_step(tree, st_j, jnp.asarray(toks[:, i:i + 1]))
        ld_t, st_t = params.decode_step(params, st_t, tt[:, i:i + 1])
        close(ld_t, ld_j, 1e-5)
    close_states(st_t, st_j, 1e-5)


def check_bf16_forward(arch, seq=S):
    """bf16 storage and compute: the forward's logits on ``seq`` tokens
    against the reference run op by op."""
    cfg_j, _, tree, params = models(arch, "bfloat16")
    toks = tokens(cfg_j.vocab_size, seed=1, shape=(B, seq))
    with jax.disable_jit():
        want = j_build(cfg_j).forward(tree, jnp.asarray(toks), remat=False)
    got = params.forward(params, torch.from_numpy(toks), remat=False)
    assert got.dtype == torch.bfloat16
    close(got, want, TOL["bfloat16"])


def batch(cfg):
    return j_batch_at(JStream(cfg.vocab_size, 17, 4, 0, 0, 1), 0)


def tbatch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def flat_j(tree) -> dict:
    return {j_keystr(p): np.asarray(leaf, np.float32) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def flat_t(tree) -> dict:
    return {keystr_simple(p): leaf.detach().float().numpy()
            for p, leaf in flatten_with_path(tree)}


def close_leaves(got: dict, want: dict, rtol: float):
    """Every leaf within ``rtol`` of its largest reference magnitude."""
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                   atol=rtol * scale, err_msg=k)


def check_loss_and_grads(arch):
    """The loss and every gradient leaf (with and without remat, which
    give the same bits), and the module's own loss."""
    cfg_j, cfg_t, tree, _ = models(arch)
    b = batch(cfg_j)
    loss_j, grads_j = jax.jit(jax.value_and_grad(j_build(cfg_j).loss))(
        tree, jax.tree.map(jnp.asarray, b))
    params = tree_from_jax(jax.tree.map(np.asarray, tree), "cpu")
    model = build_model(cfg_t, device="cpu")
    grads = {}
    for remat in (True, False):
        grads[remat] = _zeros(params)
        loss = loss_and_grad(model, params, tbatch(b), remat, grads[remat])
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
        close_leaves(flat_t(grads[remat]), flat_j(grads_j), 1e-5)
    for (p, a), (_, c) in zip(flatten_with_path(grads[True]),
                              flatten_with_path(grads[False])):
        assert torch.equal(a, c), keystr_simple(p)
    model.set_params(params)
    with torch.no_grad():
        assert float(model.loss(model, tbatch(b))) == float(loss)


def check_branches(arch, state_leaf):
    """``decode_step`` leaves its input state as it was: two branches
    from one prefill, and a step after the first branch, give the
    reference's logits; ``inplace=True`` writes into the state it is
    given.  ``state_leaf(state)`` picks a tensor the step rewrites."""
    cfg_j, _, tree, params = models(arch)
    mj = j_build(cfg_j)
    prompt = tokens(cfg_j.vocab_size, seed=1, shape=(3, 8))
    _, st_j = jax.jit(mj.prefill, static_argnums=(2,))(
        tree, jnp.asarray(prompt), 16)
    _, st_t = params.prefill(params, torch.from_numpy(prompt), 16)
    before = [t.clone() for t in tree_leaves(st_t)]
    leaf_before = state_leaf(st_t).clone()
    got, want = [], []
    for step, p, st, tok, out in (
            (jax.jit(mj.decode_step), tree, st_j, jnp.asarray, want),
            (params.decode_step, params, st_t, torch.tensor, got)):
        la, sa = step(p, st, tok([[5], [6], [7]]))
        lb, _ = step(p, st, tok([[9], [10], [11]]))
        lc, _ = step(p, sa, tok([[1], [2], [3]]))
        out += [la, lb, lc]
    for g, w in zip(got, want):
        close(g, w, 1e-5)
    for a, b in zip(tree_leaves(st_t), before):
        assert torch.equal(a, b)
    _, s2 = params.decode_step(params, st_t, torch.tensor([[5], [6], [7]]),
                               inplace=True)
    assert state_leaf(s2) is state_leaf(st_t)
    assert not torch.equal(state_leaf(st_t), leaf_before)


def check_greedy(arch, s_max=24, steps=10):
    """Greedy ``ServeEngine`` tokens equal the JAX engine's (f32)."""
    cfg_j, _, tree, params = models(arch)
    prompt = tokens(cfg_j.vocab_size, seed=1, shape=(3, 8))
    toks_j, last_j = JEngine(j_build(cfg_j), tree, s_max=s_max).generate(
        jnp.asarray(prompt), steps=steps)
    toks_t, last_t = ServeEngine(params, params, s_max=s_max).generate(
        prompt, steps=steps)
    assert toks_t.dtype == torch.int32 and toks_t.shape == (3, steps)
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    close(last_t, last_j, 1e-5)


def check_params_and_checkpoint(arch, tmp_path):
    """The tree through ``params_from_jax``/``params_to_jax`` and an f32
    checkpoint each way, bit for bit."""
    _, _, tree, params = models(arch)
    ref = jax.tree.map(np.asarray, tree)
    close_leaves(flat_j(params_to_jax(params)), flat_j(ref), 0.0)
    tckpt.save_checkpoint(str(tmp_path / "port"), 2, params_tree(params))
    got = jckpt.load_checkpoint(str(tmp_path / "port"), 2,
                                jax.tree.map(jnp.zeros_like, tree))
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, got), ref)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 2, tree)
    like = tree_from_jax(jax.tree.map(np.zeros_like, ref), "cpu")
    loaded = tckpt.load_checkpoint(str(tmp_path / "ref"), 2, like)
    close_leaves(flat_t(loaded), flat_j(ref), 0.0)
    return ref


def check_train_step(arch):
    """One AdamW step: loss, gradient norm and the moments (m is linear
    in the gradient) at 1e-5; each parameter within two learning rates
    (Adam's first step is lr·sign(g))."""
    cfg_j, cfg_t, tree, _ = models(arch)
    tkw = dict(total_steps=30, warmup_steps=2, learning_rate=3e-3)
    jcfg = JTrainConfig(**tkw)
    j_init, _ = jopt.make_optimizer(jcfg)
    state_j = JTrainState(tree, j_init(tree, jcfg), None)
    b = batch(cfg_j)
    new_j, m_j = jax.jit(j_make_train_step(j_build(cfg_j), jcfg))(
        state_j, jax.tree.map(jnp.asarray, b))
    state = state_from_jax(jax.tree.map(np.asarray, state_j), "cpu")
    new_t, m_t = make_train_step(build_model(cfg_t, device="cpu"),
                                 TrainConfig(**tkw))(state, tbatch(b))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5)
    close_leaves(flat_t(new_t.opt), flat_j(new_j.opt), 1e-5)
    got, want = flat_t(new_t.params), flat_j(new_j.params)
    lr1 = tkw["learning_rate"] / tkw["warmup_steps"]
    for k in want:
        assert float(np.abs(got[k] - want[k]).max()) <= 2 * lr1 + 1e-6, k


def check_launchers(arch, smoke_name, tmp_path, capsys):
    t_serve.main(["--mode", "lm", "--smoke", "--arch", arch, "--batch", "2",
                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"lm-serve: arch={smoke_name} 2x16 tokens" in out
    assert "device=cpu" in out
    t_train.main(["--arch", arch, "--smoke", "--steps", "3", "--seq", "17",
                  "--batch", "4", "--device", "cpu", "--ckpt-dir",
                  str(tmp_path)])
    assert f"done: arch={smoke_name} loss" in capsys.readouterr().out
