"""The port's encdec family against ``repro.models.whisper``, ``common.
sinusoidal_positions`` and ``repro.configs.shapes``, on the CPU.

* ``sinusoidal_positions`` at (16, 64) and at whisper's (1500, 1280),
  against the eager reference (the reference's jitted table is 1.2e-4
  from its own eager one there; ROADMAP.md §3).
* whisper-smoke through ``params_from_jax`` (``PRNGKey(0)`` weights,
  numpy-seeded frames and tokens): ``encode`` and ``forward`` (f32, and
  bf16 against the reference run op by op), the loss and every gradient
  leaf through ``loss_and_grad``, ``prefill`` with its state (self caches,
  cross K/V, positions), decode steps and 8 greedy tokens, branches from
  one state, decode past ``s_max``, the tree and a checkpoint across both
  ways, and one AdamW step on a batch with ``frames`` (unsplit and in 2
  microbatches).
* ``build_model`` of whisper-large-v3 defaults to CUDA.
* ``configs.shapes.cell_matrix`` equals the reference's.

Tolerances: f32 rtol = atol = 1e-5; bf16 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_case as case
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as j_get
from repro.configs import shapes as j_shapes
from repro.data.tokens import TokenStream as JStream
from repro.data.tokens import _batch_at as j_batch_at
from repro.models import build_model as j_build
from repro.models import common as j_common
from repro.models.whisper import WhisperModel as JWhisper
import repro.optim as jopt
from repro.train.train_step import TrainState as JTrainState
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.configs import shapes as t_shapes
from repro_torch.models import build_model
from repro_torch.models import common as t_common
from repro_torch.models.convert import tree_from_jax
from repro_torch.models.whisper import WhisperModel
from repro_torch.train import make_train_step
from repro_torch.train.convert import state_from_jax
from repro_torch.train.train_step import _zeros, loss_and_grad
from repro_torch.treepath import flatten_with_path, keystr_simple, tree_leaves

ARCH = "whisper-large-v3"
B, S = 2, 12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The smoke models' ops are tiny: one torch thread a test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(cfg, seed=0, rows=B):
    return np.random.RandomState(seed + 100).normal(
        size=(rows, cfg.encoder_ctx, cfg.d_model)).astype(np.float32)


def _models(dtype="float32"):
    cfg_j, _, tree, params = case.models(ARCH, dtype)
    return cfg_j, tree, params, JWhisper(cfg_j)


# the reference runs jitted in f32 (one compile a shape)
def _j_forward(mj, tree, frames, toks, remat=False):
    return jax.jit(mj.forward, static_argnames=("remat",))(
        tree, jnp.asarray(frames), jnp.asarray(toks), remat=remat)


def _j_prefill(mj, tree, frames, toks, s_max):
    return jax.jit(mj.prefill, static_argnums=(3,))(
        tree, jnp.asarray(frames), jnp.asarray(toks), s_max)


def _j_decoder(mj, tree):
    step = jax.jit(mj.decode_step)
    return lambda state, tok: step(tree, state, jnp.asarray(tok))


# ---------------------------------------------------------------------------
# sinusoidal positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,tol", [(16, 64, 1e-6), (1500, 1280, 3.1e-5)])
def test_sinusoidal_positions_match(n, d, tol):
    """Within ``tol`` of the eager reference; at (1500, 1280) torch's and
    XLA's pow/sin/cos round angles near 1,400 rad (an f32 ulp of 1.2e-4)
    apart, and both tables sit within 1.23e-4 of the float64 truth."""
    got = t_common.sinusoidal_positions(n, d, device="cpu")
    assert got.shape == (n, d) and got.dtype == torch.float32
    want = np.asarray(j_common.sinusoidal_positions(n, d))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    pos = np.arange(n, dtype=np.float64)[:, None]
    ang = pos / (10000.0 ** (2 * np.arange(d // 2, dtype=np.float64) / d))
    truth = np.concatenate([np.sin(ang), np.cos(ang)], -1)
    for table in (got.numpy(), want):
        assert float(np.abs(table - truth).max()) <= 1.23e-4


# ---------------------------------------------------------------------------
# encode, forward, loss and gradients
# ---------------------------------------------------------------------------

def test_encode_and_forward_match():
    cfg_j, tree, params, mj = _models()
    frames = _frames(cfg_j)
    toks = case.tokens(cfg_j.vocab_size)
    enc_j = jax.jit(mj.encode)(tree, jnp.asarray(frames))
    enc_t = params.encode(params, torch.from_numpy(frames))
    assert enc_t.shape == (B, cfg_j.encoder_ctx, cfg_j.d_model)
    case.close(enc_t, enc_j, 1e-5)
    got = params.forward(params, torch.from_numpy(frames),
                         torch.from_numpy(toks), remat=False)
    assert got.shape == (B, S, cfg_j.vocab_size)
    case.close(got, _j_forward(mj, tree, frames, toks), 1e-5)


def test_bf16_forward_matches_op_by_op():
    cfg_j, tree, params, mj = _models("bfloat16")
    frames = _frames(cfg_j, seed=1)
    toks = case.tokens(cfg_j.vocab_size, seed=1)
    with jax.disable_jit():
        want = mj.forward(tree, jnp.asarray(frames), jnp.asarray(toks),
                          remat=False)
    got = params.forward(params, torch.from_numpy(frames),
                         torch.from_numpy(toks), remat=False)
    assert got.dtype == torch.bfloat16
    case.close(got, want, case.TOL["bfloat16"])


def _batch(cfg, rows=4, seq=16, seed=0):
    b = j_batch_at(JStream(cfg.vocab_size, seq + 1, rows, seed, 0, 1), 0)
    b["frames"] = _frames(cfg, seed, rows)
    return b


def test_loss_and_gradients_match():
    """The loss and every gradient leaf, with and without remat (the same
    bits), and the module's own loss."""
    cfg_j, tree, _, mj = _models()
    b = _batch(cfg_j)
    loss_j, grads_j = jax.jit(jax.value_and_grad(mj.loss))(
        tree, jax.tree.map(jnp.asarray, b))
    params = tree_from_jax(jax.tree.map(np.asarray, tree), "cpu")
    model = build_model(case.configs(ARCH)[1], device="cpu")
    grads = {}
    for remat in (True, False):
        grads[remat] = _zeros(params)
        loss = loss_and_grad(model, params, case.tbatch(b), remat,
                             grads[remat])
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
        case.close_leaves(case.flat_t(grads[remat]), case.flat_j(grads_j),
                          1e-5)
    for (p, a), (_, c) in zip(flatten_with_path(grads[True]),
                              flatten_with_path(grads[False])):
        assert torch.equal(a, c), keystr_simple(p)
    model.set_params(params)
    with torch.no_grad():
        assert float(model.loss(model, case.tbatch(b))) == float(loss)


# ---------------------------------------------------------------------------
# serving: prefill and decode
# ---------------------------------------------------------------------------

def test_prefill_matches():
    """The last position's logits (B, 1, V) and every state leaf: the
    self caches, the cross K/V of every layer and the positions."""
    cfg_j, tree, params, mj = _models()
    frames = _frames(cfg_j)
    toks = case.tokens(cfg_j.vocab_size)
    lj, st_j = _j_prefill(mj, tree, frames, toks, S + 4)
    lt, st_t = params.prefill(params, torch.from_numpy(frames),
                              torch.from_numpy(toks), S + 4)
    assert lt.shape == (B, 1, cfg_j.vocab_size)
    case.close(lt, lj, 1e-5)
    assert st_t.cross_k.shape == (cfg_j.num_layers, B, cfg_j.encoder_ctx,
                                  cfg_j.num_kv_heads,
                                  cfg_j.resolved_head_dim)
    assert st_t.pos.dtype == torch.int32
    case.close_states(st_t, st_j, 1e-5)


def _greedy(step, first, state, steps):
    """``steps`` greedy tokens from ``first``'s logits."""
    toks, logits = [], first
    for _ in range(steps):
        nxt = np.asarray(logits[:, -1].argmax(-1))[:, None]
        toks.append(nxt)
        logits, state = step(state, nxt)
    return np.concatenate(toks, 1), logits, state


def test_decode_steps_and_greedy_tokens_match():
    """8 greedy steps after the prefill: the same tokens, and each step's
    logits and the final state within 1e-5."""
    cfg_j, tree, params, mj = _models()
    frames = _frames(cfg_j, seed=2, rows=3)
    prompt = case.tokens(cfg_j.vocab_size, seed=2, shape=(3, 6))
    lj, st_j = _j_prefill(mj, tree, frames, prompt, 16)
    lt, st_t = params.prefill(params, torch.from_numpy(frames),
                              torch.from_numpy(prompt), 16)
    decode_j = _j_decoder(mj, tree)
    seen_j, seen_t = [], []

    def step_j(st, tok):
        out = decode_j(st, tok)
        seen_j.append(out[0])
        return out

    def step_t(st, tok):
        out = params.decode_step(params, st, torch.from_numpy(tok))
        seen_t.append(out[0])
        return out
    toks_j, _, st_j = _greedy(step_j, lj, st_j, 8)
    toks_t, _, st_t = _greedy(step_t, lt, st_t, 8)
    np.testing.assert_array_equal(toks_t, toks_j)
    for g, w in zip(seen_t, seen_j):
        case.close(g, w, 1e-5)
    case.close_states(st_t, st_j, 1e-5)
    assert st_t.pos.tolist() == [14, 14, 14]


def test_decode_branches_from_one_state():
    """``decode_step`` leaves its input state as it was: two branches from
    one prefill, and a step after the first, give the reference's logits;
    ``inplace=True`` writes into the state's self caches."""
    cfg_j, tree, params, mj = _models()
    frames = _frames(cfg_j, seed=3, rows=3)
    prompt = case.tokens(cfg_j.vocab_size, seed=3, shape=(3, 8))
    _, st_j = _j_prefill(mj, tree, frames, prompt, 16)
    _, st_t = params.prefill(params, torch.from_numpy(frames),
                             torch.from_numpy(prompt), 16)
    before = [t.clone() for t in tree_leaves(st_t)]
    got, want = [], []
    for step, st, tok, out in (
            (_j_decoder(mj, tree), st_j, np.asarray, want),
            (lambda s, t: params.decode_step(params, s, t), st_t,
             torch.tensor, got)):
        la, sa = step(st, tok([[5], [6], [7]]))
        lb, _ = step(st, tok([[9], [10], [11]]))
        lc, _ = step(sa, tok([[1], [2], [3]]))
        out += [la, lb, lc]
    for g, w in zip(got, want):
        case.close(g, w, 1e-5)
    for a, b in zip(tree_leaves(st_t), before):
        assert torch.equal(a, b)
    k_before = st_t.self_caches.k.clone()
    _, s2 = params.decode_step(params, st_t, torch.tensor([[5], [6], [7]]),
                               inplace=True)
    assert s2.self_caches.k is st_t.self_caches.k
    assert not torch.equal(st_t.self_caches.k, k_before)
    assert s2.cross_k is st_t.cross_k


def test_decode_takes_row_zero_position():
    """Rows at different positions: each writes and attends at its own,
    and every row adds the learned position of row 0's, as in the
    reference."""
    cfg_j, tree, params, mj = _models()
    frames = _frames(cfg_j, seed=6, rows=3)
    prompt = case.tokens(cfg_j.vocab_size, seed=6, shape=(3, 8))
    _, st_j = _j_prefill(mj, tree, frames, prompt, 16)
    _, st_t = params.prefill(params, torch.from_numpy(frames),
                             torch.from_numpy(prompt), 16)
    pos = [5, 8, 2]
    st_j = st_j._replace(pos=jnp.asarray(pos, jnp.int32))
    st_t = st_t._replace(pos=torch.tensor(pos, dtype=torch.int32))
    tok = [[3], [4], [5]]
    lj, nj = _j_decoder(mj, tree)(st_j, tok)
    lt, nt = params.decode_step(params, st_t, torch.tensor(tok))
    case.close(lt, lj, 1e-5)
    case.close_states(nt, nj, 1e-5)


def test_decode_past_s_max_equals_reference():
    """Positions 10 and 11 fall past a 10-slot cache: their writes are
    dropped and the step attends over all 10 slots, in both packages."""
    cfg_j, tree, params, mj = _models()
    frames = _frames(cfg_j, seed=4, rows=3)
    prompt = case.tokens(cfg_j.vocab_size, seed=1, shape=(3, 8))
    lj, st_j = _j_prefill(mj, tree, frames, prompt, 10)
    lt, st_t = params.prefill(params, torch.from_numpy(frames),
                              torch.from_numpy(prompt), 10)
    toks_j, last_j, st_j = _greedy(_j_decoder(mj, tree), lj, st_j, 5)
    toks_t, last_t, st_t = _greedy(
        lambda s, t: params.decode_step(params, s, torch.from_numpy(t),
                                        inplace=True), lt, st_t, 5)
    np.testing.assert_array_equal(toks_t, toks_j)
    case.close(last_t, last_j, 1e-5)
    case.close_states(st_t, st_j, 1e-5)


# ---------------------------------------------------------------------------
# trees, checkpoints, training
# ---------------------------------------------------------------------------

def test_params_and_checkpoint_cross_both_ways(tmp_path):
    ref = case.check_params_and_checkpoint(ARCH, tmp_path)
    assert ref["enc_layers"]["attn"]["wq"].shape == (2, 64, 64)
    assert ref["dec_layers"]["cross"]["wk"].shape == (2, 64, 64)
    assert ref["pos_embedding"].shape == (64, 64)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_equals_reference(microbatches):
    """One AdamW step on a batch with ``frames``: loss, gradient norm and
    the moments at 1e-5; each parameter within two learning rates (Adam's
    first step is lr·sign(g))."""
    cfg_j, tree, _, mj = _models()
    tkw = dict(total_steps=30, warmup_steps=2, learning_rate=3e-3,
               microbatches=microbatches)
    jcfg = JTrainConfig(**tkw)
    j_init, _ = jopt.make_optimizer(jcfg)
    state_j = JTrainState(tree, j_init(tree, jcfg), None)
    b = _batch(cfg_j, seed=5)
    new_j, m_j = jax.jit(j_make_train_step(mj, jcfg))(
        state_j, jax.tree.map(jnp.asarray, b))
    state = state_from_jax(jax.tree.map(np.asarray, state_j), "cpu")
    new_t, m_t = make_train_step(build_model(case.configs(ARCH)[1],
                                             device="cpu"),
                                 TrainConfig(**tkw))(state, case.tbatch(b))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5)
    case.close_leaves(case.flat_t(new_t.opt), case.flat_j(new_j.opt), 1e-5)
    got, want = case.flat_t(new_t.params), case.flat_j(new_j.params)
    lr1 = tkw["learning_rate"] / tkw["warmup_steps"]
    for k in want:
        assert float(np.abs(got[k] - want[k]).max()) <= 2 * lr1 + 1e-6, k


# ---------------------------------------------------------------------------
# registry and the cell matrix
# ---------------------------------------------------------------------------

def test_build_model_whisper_defaults_to_cuda(monkeypatch):
    """A ``WhisperModel`` of the full config, on the CPU only when asked
    (construction draws no weights); without a card the default raises,
    as does the sinusoidal table's."""
    cfg = get_config(ARCH)
    model = build_model(cfg, device="cpu")
    assert isinstance(model, WhisperModel)
    assert model.device == torch.device("cpu")
    assert model.stacked_axes == {"enc_layers": 1, "dec_layers": 1}
    assert isinstance(j_build(j_get(ARCH)), JWhisper)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_common.sinusoidal_positions(4, 8)


def test_cell_matrix_matches_reference():
    def key(cells):
        return [(c.arch, c.shape.name, c.shape.seq_len, c.shape.global_batch,
                 c.shape.kind, c.skip) for c in cells]
    got, want = t_shapes.cell_matrix(), j_shapes.cell_matrix()
    assert len(got) == 40
    assert key(got) == key(want)
    assert key(t_shapes.runnable_cells()) == key(j_shapes.runnable_cells())
