"""The port's training side against the reference, on the CPU.

* The loss and every gradient leaf of a smoke model equal ``repro``'s
  (f32, 1e-5) on the same weights and batch; ``remat`` changes no bit.
* AdamW (f32 and bf16 moments) and Adafactor, fed the same numpy
  gradients, parameters and state as the reference, give its updates and
  state (1e-6 relative), with its state names and shapes, on a tree with
  stacked (L, d) norm and bias leaves; the in-place update equals the
  functional one bit for bit.
* ``warmup_cosine``, ``clip_by_global_norm``, the int8 codec and
  ``compressed_psum`` (one lane against ``repro`` under ``shard_map``; four
  lanes against a numpy transcription of the reference) equal the
  reference's.
* One train step equals the reference's step, and the one-lane
  compressed step the reference's ``make_compressed_dp_train_step`` on a
  1-device mesh.  The microbatched step's first moment (linear in the
  gradient) equals the unsplit step's; the 4-lane compressed step's is
  the exact step's within the int8 quantization step, and with the
  lanes' residuals added it is the exact gradient.
* The properties of ``tests/test_train.py`` hold for the port's Trainer.
* ``python -m repro_torch.launch.train ... --device cpu`` runs.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.optim as jopt
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as j_smoke
from repro.data.tokens import TokenStream as JStream
from repro.data.tokens import _batch_at as j_batch_at
from repro.models import build_model as j_build
from repro.optim.grad import compressed_psum as j_compressed_psum
from repro.sharding import keystr_simple as j_keystr
from repro.train.train_step import TrainState as JTrainState
from repro.train.train_step import \
    make_compressed_dp_train_step as j_make_compressed_step
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch import optim
from repro_torch.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.data.tokens import TokenStream, _batch_at
from repro_torch.launch import train as t_launch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import tree_from_jax
from repro_torch.optim.grad import compressed_psum
from repro_torch.runtime import FailureInjector
from repro_torch.train import Trainer, make_train_step
from repro_torch.train.convert import state_from_jax
from repro_torch.train.train_step import (_zeros, init_train_state,
                                          loss_and_grad,
                                          make_compressed_dp_train_step)
from repro_torch.treepath import flatten_with_path, keystr_simple, tree_map

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The smoke models' ops are tiny: with every worker of a parallel
    test run using all cores, torch's intra-op threads spin against each
    other and a step takes tens of times longer.  One thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TCFG = dict(total_steps=30, warmup_steps=2, learning_rate=3e-3,
            checkpoint_every=5)


def _flat_j(tree) -> dict:
    return {j_keystr(p): np.asarray(leaf, np.float32) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree) -> dict:
    return {keystr_simple(p): leaf.detach().float().numpy()
            for p, leaf in flatten_with_path(tree)}


def _close(got: dict, want: dict, rtol: float):
    """Every leaf within ``rtol`` of the reference, relative to the
    leaf's largest magnitude."""
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                   atol=rtol * scale, err_msg=k)


def _reference(arch, **tkw):
    """The reference's f32 smoke model, its weights and a batch."""
    cfg = dataclasses.replace(j_smoke(arch), dtype="float32")
    model = j_build(cfg)
    tree = model.init(jax.random.PRNGKey(0))
    batch = j_batch_at(JStream(cfg.vocab_size, 17, 4, 0, 0, 1), 0)
    return cfg, model, tree, batch


def _port_model(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    return build_model(cfg, device="cpu")


def _tbatch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2.5-3b"])
def test_loss_and_grads_equal_reference(arch):
    _, model_j, tree, batch = _reference(arch)
    loss_j, grads_j = jax.jit(jax.value_and_grad(model_j.loss))(
        tree, jax.tree.map(jnp.asarray, batch))
    params = tree_from_jax(jax.tree.map(np.asarray, tree), "cpu")
    model = _port_model(arch)
    grads = {}
    for remat in (True, False):
        grads[remat] = _zeros(params)
        loss = loss_and_grad(model, params, _tbatch(batch), remat,
                             grads[remat])
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5,
                                   atol=1e-5)
        _close(_flat_t(grads[remat]), _flat_j(grads_j), 1e-5)
    for a, b in zip(flatten_with_path(grads[True]),
                    flatten_with_path(grads[False])):
        assert torch.equal(a[1], b[1]), keystr_simple(a[0])
    # the module holding the same tensors (serving's params) gives the
    # same loss
    model.set_params(params)
    with torch.no_grad():
        assert float(model.loss(model, _tbatch(batch))) == float(loss)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _stacked_tree(rng, dtype=np.float32):
    """A reference-shaped tree: stacked (L, d) norm scales and biases,
    (L, d, f) weights, (V, d) and (d,) leaves."""
    L, d, f, v = 3, 8, 12, 20
    shapes = {"embedding": (v, d), "final_norm": {"scale": (d,)},
              "layers": {"attn": {"wq": (L, d, f), "wq_b": (L, f)},
                         "attn_norm": {"scale": (L, d)},
                         "mlp": {"w_down": (L, f, d)}}}
    return jax.tree.map(lambda s: rng.randn(*s).astype(dtype), shapes,
                        is_leaf=lambda s: isinstance(s, tuple))


@pytest.mark.parametrize("optimizer,moments", [("adamw", "float32"),
                                               ("adamw", "bfloat16"),
                                               ("adafactor", "float32")])
def test_optimizer_equals_reference(optimizer, moments):
    kw = dict(optimizer=optimizer, moment_dtype=moments, warmup_steps=2,
              total_steps=10, learning_rate=1e-2)
    jcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    rng = np.random.RandomState(7)
    params_np = _stacked_tree(rng)
    j_init, j_update = jopt.make_optimizer(jcfg)
    t_init, t_update = optim.make_optimizer(tcfg)
    state_j = j_init(jax.tree.map(jnp.asarray, params_np), jcfg)
    params = tree_from_jax(params_np, "cpu")
    state_t = t_init(params, tcfg)
    assert {k: v.shape for k, v in _flat_t(state_t).items()} \
        == {k: v.shape for k, v in _flat_j(state_j).items()}
    assert {keystr_simple(p): str(x.dtype).removeprefix("torch.")
            for p, x in flatten_with_path(state_t)} \
        == {j_keystr(p): str(x.dtype) for p, x in
            jax.tree_util.tree_flatten_with_path(state_j)[0]}
    for _ in range(3):
        g_np = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32),
                            params_np)
        upd_j, new_j = jax.jit(j_update, static_argnums=3)(
            jax.tree.map(jnp.asarray, g_np), state_j,
            jax.tree.map(jnp.asarray, params_np), jcfg)
        # the port's step from the reference's state and parameters
        state_in = tree_from_jax(jax.tree.map(np.asarray, state_j), "cpu")
        upd_t, new_t = t_update(tree_from_jax(g_np, "cpu"), state_in,
                                tree_from_jax(params_np, "cpu"), tcfg)
        _close(_flat_t(upd_t), _flat_j(upd_j), 1e-6)
        _close(_flat_t(new_t), _flat_j(new_j), 1e-6)
        # in place: the same update added into the parameters, the same
        # state written over the old
        p_in = tree_from_jax(params_np, "cpu")
        state_in = tree_from_jax(jax.tree.map(np.asarray, state_j), "cpu")
        none, same = t_update(tree_from_jax(g_np, "cpu"), state_in, p_in,
                              tcfg, inplace=True)
        assert none is None
        for (_, a), (_, b) in zip(flatten_with_path(same),
                                  flatten_with_path(new_t)):
            assert torch.equal(a, b)
        for (_, a), (_, b) in zip(flatten_with_path(p_in), flatten_with_path(
                optim.apply_updates(tree_from_jax(params_np, "cpu"),
                                    upd_t))):
            assert torch.equal(a, b)
        params_np = jax.tree.map(np.asarray,
                                 jopt.apply_updates(params_np, upd_j))
        state_j = new_j


def test_schedule_clip_and_codec_equal_reference():
    for step in (0, 1, 5, 10, 11, 57, 100, 130):
        assert float(optim.warmup_cosine(step, 1e-3, 10, 100)) \
            == float(jopt.warmup_cosine(step, 1e-3, 10, 100))
    lr10 = float(optim.warmup_cosine(10, 1e-3, 10, 100))
    assert abs(lr10 - 1e-3) < 1e-9
    tree = {"a": torch.full((10,), 3.0), "b": torch.full((10,), 4.0)}
    clipped, norm = optim.clip_by_global_norm(tree, 1.0)
    assert abs(float(norm) - np.sqrt(250.0)) < 1e-3
    assert abs(float(optim.global_norm(clipped)) - 1.0) < 1e-5
    rng = np.random.RandomState(3)
    g_np = _stacked_tree(rng)
    for max_norm in (1.0, 1e3):
        c_j, n_j = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g_np),
                                            max_norm)
        c_t, n_t = optim.clip_by_global_norm(tree_from_jax(g_np, "cpu"),
                                             max_norm)
        np.testing.assert_allclose(float(n_t), float(n_j), rtol=1e-6)
        _close(_flat_t(c_t), _flat_j(c_j), 1e-6)
    q_j, s_j = jopt.int8_compress(jax.tree.map(jnp.asarray, g_np))
    q_t, s_t = optim.int8_compress(tree_from_jax(g_np, "cpu"))
    assert _flat_t(q_t).keys() == _flat_j(q_j).keys()
    for k, v in _flat_j(q_j).items():
        np.testing.assert_array_equal(_flat_t(q_t)[k], v)
    _close(_flat_t(s_t), _flat_j(s_j), 0)
    _close(_flat_t(optim.int8_decompress(q_t, s_t)),
           _flat_j(jopt.int8_decompress(q_j, s_j)), 0)


# ---------------------------------------------------------------------------
# compressed all-reduce
# ---------------------------------------------------------------------------

def test_compressed_psum_one_lane_equals_reference():
    rng = np.random.RandomState(11)
    g_np, e_np = _stacked_tree(rng), _stacked_tree(rng)
    e_np = jax.tree.map(lambda e: 1e-3 * e, e_np)
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    spec = jax.tree.map(lambda _: P(), g_np)
    fn = jax.jit(jax.shard_map(
        lambda g, e: j_compressed_psum(g, "data", e), mesh=mesh,
        in_specs=(spec, spec), out_specs=(spec, spec), check_vma=False))
    mean_j, err_j = fn(jax.tree.map(jnp.asarray, g_np),
                       jax.tree.map(jnp.asarray, e_np))
    lanes = tree_from_jax(jax.tree.map(lambda g: g[None], g_np), "cpu")
    mean_t, err_t = compressed_psum(lanes, tree_from_jax(e_np, "cpu"))
    _close(_flat_t(mean_t), _flat_j(mean_j), 1e-7)
    # XLA contracts g - q·s into one FMA and the port rounds q·s first, so
    # the residuals agree to an ulp of g, not of the residual
    got, want = _flat_t(err_t), _flat_j(err_j)
    for k, g in _flat_j(g_np).items():
        np.testing.assert_allclose(got[k][0], want[k], rtol=0,
                                   atol=1e-7 * float(np.abs(g).max()))


def _numpy_compressed_psum(lanes: list, errors: list):
    """``repro.optim.grad.compressed_psum`` (grad.py:45-74) for one leaf,
    transcribed to numpy: one array per position of the data axis."""
    n = len(lanes)
    g = [x.astype(np.float32) + e for x, e in zip(lanes, errors)]
    scale = np.float32(max(max(float(np.max(np.abs(x))), 1e-12)
                           for x in g)) / np.float32(127.0)
    q = [np.clip(np.round(x / scale), -127, 127).astype(np.int8) for x in g]
    summed = np.sum([x.astype(np.int32) for x in q], axis=0)
    mean = summed.astype(np.float32) * scale / np.float32(n)
    return mean, [x - y.astype(np.float32) * scale for x, y in zip(g, q)]


def test_compressed_psum_four_lanes_equal_numpy():
    rng = np.random.RandomState(12)
    g = {"w": rng.randn(4, 6, 5).astype(np.float32),
         "b": (rng.randn(4, 5) * 100).astype(np.float32)}
    e = {k: (1e-2 * rng.randn(*v.shape)).astype(np.float32)
         for k, v in g.items()}
    mean, err = compressed_psum(tree_from_jax(g, "cpu"),
                                tree_from_jax(e, "cpu"))
    for k in g:
        want_mean, want_err = _numpy_compressed_psum(list(g[k]), list(e[k]))
        np.testing.assert_allclose(mean[k].numpy(), want_mean, rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(err[k].numpy(), np.stack(want_err),
                                   rtol=1e-6, atol=1e-7)
        # the residual is exactly what the int8 payload did not carry
        gf = torch.from_numpy(g[k] + e[k])
        scale = gf.abs().max() / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127)
        assert torch.equal(err[k], gf - q * scale)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_case():
    """The reference's llama smoke step (f32) from PRNGKey(0) weights, and
    the port's state from the same weights."""
    cfg, model_j, tree, batch = _reference("llama3.2-3b")
    jcfg = JTrainConfig(**TCFG)
    j_init, _ = jopt.make_optimizer(jcfg)
    state_j = JTrainState(tree, j_init(tree, jcfg), None)
    new_j, m_j = jax.jit(j_make_train_step(model_j, jcfg))(
        state_j, jax.tree.map(jnp.asarray, batch))
    state_t = state_from_jax(jax.tree.map(np.asarray, state_j), "cpu")
    return batch, jax.tree.map(np.asarray, new_j), m_j, state_t


def _copy(state):
    return tree_map(torch.clone, state)


def _step(state, batch, **tkw):
    """One port step from a copy of ``state`` (a step updates the state
    it is given)."""
    tcfg = TrainConfig(**{**TCFG, **tkw})
    return make_train_step(_port_model("llama3.2-3b"), tcfg)(
        _copy(state), _tbatch(batch))


def _gradient(m: dict, metrics, tcfg) -> dict:
    """A first step's gradient before clipping, per leaf, from its first
    moment ``m`` (flat): m = (1 - b1)·c·g with c = min(1, grad_clip /
    |g|)."""
    c = min(1.0, tcfg.grad_clip / max(float(metrics["grad_norm"]), 1e-6))
    return {k: v / ((1 - tcfg.beta1) * c) for k, v in m.items()}


def test_train_step_equals_reference(step_case):
    """Loss, grad norm and moments at 1e-5; each parameter within two
    learning rates of the reference's (Adam's first step is lr·sign(g),
    and a gradient entry near zero may take either sign)."""
    batch, new_j, m_j, state = step_case
    new_t, m_t = _step(state, batch)
    for k in ("loss", "grad_norm", "step"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5)
    _close(_flat_t(new_t.opt), _flat_j(new_j.opt), 1e-5)
    got, want = _flat_t(new_t.params), _flat_j(new_j.params)
    lr1 = TCFG["learning_rate"] / TCFG["warmup_steps"]      # step 1's lr
    for k in want:
        assert float(np.abs(got[k] - want[k]).max()) <= 2 * lr1 + 1e-6, k
    # the step writes into the state it is given, and returns it
    owned = _copy(state)
    same, m_same = make_train_step(_port_model("llama3.2-3b"),
                                   TrainConfig(**TCFG))(owned, _tbatch(batch))
    assert same.params is owned.params
    for (p, a), (_, b), (_, c) in zip(flatten_with_path(same),
                                      flatten_with_path(owned),
                                      flatten_with_path(new_t)):
        assert torch.equal(a, c), p
        assert (a is b) == (p != ("opt", "step")), p   # a new counter
    assert float(m_same["loss"]) == float(m_t["loss"])


def test_microbatch_step_within_reference_bounds(step_case):
    """grad accumulation over 2 microbatches == one big batch: the
    reference's bounds (loss 1e-3, params 3e-2), and the first moment,
    (1 - b1)·clip(g) after one step, within 1e-5 of each leaf's largest."""
    batch, _, _, state = step_case
    s1, m1 = _step(state, batch)
    s2, m2 = _step(state, batch, microbatches=2)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-3
    d = [float(np.abs(a - b).max()) for a, b in
         zip(_flat_t(s1.params).values(), _flat_t(s2.params).values())]
    assert max(d) < 3e-2, d
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]),
                               rtol=1e-5)
    _close(_flat_t(s2.opt["m"]), _flat_t(s1.opt["m"]), 1e-5)
    _close(_flat_t(s2.opt["v"]), _flat_t(s1.opt["v"]), 1e-5)


def test_compressed_step_one_lane_equals_reference(step_case):
    """The port's compressed step on a 1-lane ``data`` axis against
    ``repro``'s ``make_compressed_dp_train_step`` on a 1-device mesh (f32,
    the same weights and batch): loss and grad norm at 1e-5; the int8
    payload plus its residual (the gradient) at 1e-5 of each leaf's
    largest; the payload alone within one quantization step (an entry on
    a rounding boundary may round either way)."""
    batch, _, _, state = step_case
    _, model_j, tree, _ = _reference("llama3.2-3b")
    tkw = dict(grad_compression="int8", learning_rate=1e-3, warmup_steps=1,
               total_steps=10)
    jcfg, tcfg = JTrainConfig(**tkw), TrainConfig(**tkw)
    j_init, _ = jopt.make_optimizer(jcfg)
    state_j = JTrainState(tree, j_init(tree, jcfg),
                          jax.tree.map(jnp.zeros_like, tree))
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    new_j, m_j = j_make_compressed_step(model_j, jcfg, mesh)(
        state_j, jax.tree.map(jnp.asarray, batch))
    new_j = jax.tree.map(np.asarray, new_j)
    port = state_from_jax(jax.tree.map(np.asarray, state_j), "cpu")
    new_t, m_t = make_compressed_dp_train_step(
        _port_model("llama3.2-3b"), tcfg, make_host_mesh(1, 1, "cpu"))(
        port, _tbatch(batch))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5)
    assert int(new_t.opt["step"]) == int(new_j.opt["step"]) == 1
    q_t = _gradient(_flat_t(new_t.opt["m"]), m_t, tcfg)
    q_j = _gradient(_flat_j(new_j.opt["m"]), m_j, tcfg)
    err_t = {k: v[0] for k, v in _flat_t(new_t.err).items()}
    err_j = _flat_j(new_j.err)
    _close({k: q_t[k] + err_t[k] for k in q_t},
           {k: q_j[k] + err_j[k] for k in q_j}, 1e-5)
    for k in q_j:
        top = float(np.abs(q_j[k] + err_j[k]).max())        # max |g|
        # one int8 step (a flipped rounding), plus the two scales' own
        # 1e-5 (each is max |g| / 127)
        assert float(np.abs(q_t[k] - q_j[k]).max()) \
            <= top / 127 + 1e-5 * top, k


def test_compressed_step_within_exact_step_bounds():
    """The 4-lane int8 step against the exact step (f32):
    tests/elastic_compress_check.py's bounds (loss 1e-3, params 5e-3,
    non-zero residuals); its gradient (from the first moment) within half
    an int8 step (the leaf's largest lane gradient / 127) of the exact
    one entry by entry, and equal to it at 1e-5 of the leaf's largest
    once the lanes' mean residual is added back; each lane's residual
    within half a step of its own gradient, a whole number of steps
    away."""
    model = _port_model("llama3.2-3b")
    stream = TokenStream(model.cfg.vocab_size, 16, 16, 0, 0, 1)
    batch = _tbatch(_batch_at(stream, 0))
    tcfg = TrainConfig(grad_compression="int8", learning_rate=1e-3,
                       warmup_steps=1, total_steps=10)
    state = init_train_state(model, torch.Generator().manual_seed(0), tcfg)
    mesh = make_host_mesh(4, 1, device="cpu")
    owned = _copy(state)
    sc, mc = make_compressed_dp_train_step(model, tcfg, mesh)(owned, batch)
    assert sc.params is owned.params
    se, me = make_train_step(model, tcfg)(_copy(state), batch)
    assert abs(float(mc["loss"]) - float(me["loss"])) < 1e-3
    diffs = [float((a.float() - b.float()).abs().max()) for (_, a), (_, b)
             in zip(flatten_with_path(sc.params),
                    flatten_with_path(se.params))]
    assert max(diffs) < 5e-3, max(diffs)
    assert all(e.shape[0] == 4 for _, e in flatten_with_path(sc.err))
    assert sum(float(e.abs().sum()) for _, e in flatten_with_path(sc.err)) \
        > 0
    # each lane's own gradient gives the leaf's int8 step
    lanes = []
    for i in range(4):
        g = _zeros(state.params)
        loss_and_grad(model, state.params,
                      {k: v[4 * i:4 * i + 4] for k, v in batch.items()},
                      True, g)
        lanes.append(_flat_t(g))
    g_c = _gradient(_flat_t(sc.opt["m"]), mc, tcfg)
    g_e = _gradient(_flat_t(se.opt["m"]), me, tcfg)
    mean_err = {k: v.mean(axis=0) for k, v in _flat_t(sc.err).items()}
    err = _flat_t(sc.err)
    # g / step and q·step round at |g| <= 127 steps: an ulp there is
    # 1.5e-5 of a half step, so a residual may pass it by a few of them
    half = 0.5 * (1 + 1e-4)
    for k in g_e:
        step = max(float(np.abs(lane[k]).max()) for lane in lanes) / 127
        assert float(np.abs(g_c[k] - g_e[k]).max()) \
            <= step * half + 1e-5 * float(np.abs(g_e[k]).max()), k
        # lane i's residual is what its own gradient's payload left out:
        # a whole number of int8 steps away from that gradient
        for i, lane in enumerate(lanes):
            q = (lane[k] - err[k][i]) / step
            assert float(np.abs(q - np.round(q)).max()) < 1e-3, (k, i)
            assert float(np.abs(err[k][i]).max()) <= step * half, (k, i)
    _close({k: g_c[k] + mean_err[k] for k in g_c}, g_e, 1e-5)
    with pytest.raises(ValueError, match="int8"):
        make_compressed_dp_train_step(model, TrainConfig(), mesh)(
            init_train_state(model, torch.Generator().manual_seed(0),
                             TrainConfig()), batch)
    elsewhere = make_host_mesh(4, 1, device="meta")
    with pytest.raises(ValueError, match="§1 item 8"):
        make_compressed_dp_train_step(model, tcfg, elsewhere)(state, batch)


def test_compressed_step_refuses_residuals_of_another_axis():
    """Residual rows kept for 4 data positions do not fit a 2-position
    axis: the step raises rather than broadcast them against its lanes."""
    model = _port_model("llama3.2-3b")
    stream = TokenStream(model.cfg.vocab_size, 16, 16, 0, 0, 1)
    batch = _tbatch(_batch_at(stream, 0))
    tcfg = TrainConfig(grad_compression="int8", learning_rate=1e-3,
                       warmup_steps=1, total_steps=10)
    state = init_train_state(model, torch.Generator().manual_seed(0), tcfg)
    four, _ = make_compressed_dp_train_step(
        model, tcfg, make_host_mesh(4, 1, device="cpu"))(state, batch)
    assert all(e.shape[0] == 4 for _, e in flatten_with_path(four.err))
    two = make_compressed_dp_train_step(model, tcfg,
                                        make_host_mesh(2, 1, device="cpu"))
    with pytest.raises(ValueError, match="fits neither"):
        two(four, batch)


# ---------------------------------------------------------------------------
# the reference's properties (tests/test_train.py), on the port
# ---------------------------------------------------------------------------

def _setup(tmp_path, arch="llama3.2-3b", **tkw):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    tcfg = TrainConfig(**TCFG, checkpoint_dir=str(tmp_path), **tkw)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=16, batch=4,
                         seed=0, shard=0, num_shards=1)
    return model, tcfg, stream


def test_loss_decreases(tmp_path):
    model, tcfg, stream = _setup(tmp_path)
    tr = Trainer(model, tcfg, stream)
    tr.run(steps=30)
    losses = [m["loss"] for m in tr.metrics_log]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


@pytest.mark.parametrize("optimizer,moments", [("adafactor", "float32"),
                                               ("adamw", "bfloat16")])
def test_optimizer_state_kinds(tmp_path, optimizer, moments):
    """Adafactor's second moments are O(rows + cols); bf16 moments are
    bf16; a step of either is finite."""
    model, tcfg, stream = _setup(tmp_path, optimizer=optimizer,
                                 moment_dtype=moments)
    state = init_train_state(model, torch.Generator().manual_seed(0), tcfg)
    if optimizer == "adafactor":
        p_size = sum(x.numel() for _, x in flatten_with_path(state.params))
        o_size = sum(x.numel() for _, x in flatten_with_path(state.opt))
        assert o_size < 0.2 * p_size
    else:
        assert all(x.dtype == torch.bfloat16
                   for _, x in flatten_with_path(state.opt["m"]))
    _, m = make_train_step(model, tcfg)(state, Trainer(
        model, tcfg, stream).batch(0))
    assert np.isfinite(float(m["loss"]))


def test_checkpoint_roundtrip_and_resume(tmp_path):
    model, tcfg, stream = _setup(tmp_path)
    tr = Trainer(model, tcfg, stream)
    state = tr.run(steps=10)
    # a fresh trainer resumes from step 10 with identical params
    st2, step = Trainer(model, tcfg, stream).init_or_resume()
    assert step == 10
    for (_, a), (_, b) in zip(flatten_with_path(state),
                              flatten_with_path(st2)):
        assert torch.equal(a, b)


def test_fault_recovery_continues_training(tmp_path):
    """Crash at steps 7 and 13 -> recover from checkpoints -> finish."""
    model, tcfg, stream = _setup(tmp_path)
    inj = FailureInjector([7, 13])
    state = Trainer(model, tcfg, stream).run(steps=20, fault_hook=inj)
    assert inj.fired == {7, 13}
    assert int(state.opt["step"]) == 20


def test_fault_recovery_is_deterministic(tmp_path):
    """Recovered run == uninterrupted run, bit for bit on the CPU."""
    model, tcfg, stream = _setup(tmp_path)
    clean = Trainer(model, tcfg, stream).run(steps=12)
    shutil.rmtree(tcfg.checkpoint_dir)
    faulty = Trainer(model, tcfg, stream).run(
        steps=12, fault_hook=FailureInjector([8]))
    for (_, a), (_, b) in zip(flatten_with_path(clean.params),
                              flatten_with_path(faulty.params)):
        assert torch.equal(a, b)


def test_launch_train_runs_on_cpu(tmp_path, capsys):
    t_launch.main(["--arch", "llama3.2-3b", "--smoke", "--steps", "6",
                   "--device", "cpu", "--ckpt-dir", str(tmp_path / "a")])
    assert "done: arch=llama3.2-smoke loss" in capsys.readouterr().out
    t_launch.main(["--arch", "qwen2.5-3b", "--smoke", "--steps", "3",
                   "--seq", "17", "--batch", "4", "--data", "2",
                   "--compress", "--device", "cpu",
                   "--ckpt-dir", str(tmp_path / "b")])
    assert "done: arch=qwen2.5-smoke loss" in capsys.readouterr().out
