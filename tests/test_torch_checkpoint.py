"""Checkpoints cross between the port and the reference, on the CPU.

A ``repro`` checkpoint of a ``TrainState`` (f32 and bf16 moments) loads
into the port bit for bit; the port writes the reference's manifest (keys,
shapes, dtype names) and npz entries byte for byte, and
``repro.checkpoint.load_checkpoint(like=...)`` loads a port checkpoint
bit for bit (f32: the reference restores no bf16 leaf, even its own).
The state converters round-trip, the port names leaves in JAX's order,
and ``CheckpointManager`` keeps the last k.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.sharding import keystr_simple as j_keystr
from repro.train.train_step import init_train_state as j_init_train_state
from repro_torch import checkpoint as tckpt
from repro_torch.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.train.convert import state_from_jax, state_to_jax
from repro_torch.train.train_step import init_train_state
from repro_torch.treepath import flatten_with_path, keystr_simple


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The smoke models' ops are tiny: with every worker of a parallel
    test run using all cores, torch's intra-op threads spin against each
    other and a step takes tens of times longer.  One thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def ref_state(request):
    """The reference's qwen2.5 smoke TrainState (stacked QKV biases and
    norms) with ``moment_dtype`` and non-zero moments, as numpy."""
    tcfg = JTrainConfig(moment_dtype=request.param)
    state = j_init_train_state(j_build(j_smoke("qwen2.5-3b")),
                               jax.random.PRNGKey(0), tcfg)
    rng = np.random.RandomState(4)
    state = state._replace(opt={**state.opt, "step": np.int32(7), **{
        k: jax.tree.map(lambda x: (0.01 * rng.randn(*x.shape)).astype(
            x.dtype), state.opt[k]) for k in ("m", "v")}})
    return jax.tree.map(np.asarray, state)


def _bits(x) -> np.ndarray:
    a = x.detach().cpu() if isinstance(x, torch.Tensor) else np.asarray(x)
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same(port_tree, ref_tree):
    got = {keystr_simple(p): x for p, x in flatten_with_path(port_tree)}
    want = {j_keystr(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
    assert got.keys() == want.keys()
    for k in want:
        assert _bits(got[k]).shape == np.shape(want[k]), k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                      err_msg=k)


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


def test_reference_checkpoint_loads_into_port(ref_state, tmp_path):
    jckpt.save_checkpoint(str(tmp_path), 3, ref_state)
    like = state_from_jax(ref_state, "cpu")
    for x in jax.tree.leaves(like):
        x.zero_()
    got = tckpt.load_checkpoint(str(tmp_path), 3, like)
    _assert_same(got, ref_state)
    assert got.opt["m"]["embedding"].dtype == like.opt["m"]["embedding"].dtype


def test_port_checkpoint_loads_into_reference(ref_state, tmp_path):
    """The port writes the reference's file: the same manifest and the
    same npz entries, byte for byte; ``repro`` loads it as its own.  (The
    reference cannot restore a bf16 leaf from any npz, its own included:
    ``jnp.asarray`` of the ``|V2`` array it wrote raises.  The port reads
    them through a uint16 view.)"""
    port = state_from_jax(ref_state, "cpu")
    tckpt.save_checkpoint(str(tmp_path / "port"), 3, port)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 3, ref_state)
    assert _manifest(tmp_path / "port", 3) == _manifest(tmp_path / "ref", 3)
    dtypes = _manifest(tmp_path / "port", 3)["dtypes"]
    assert dtypes["opt/step"] == "int32"
    assert dtypes["opt/m/layers/attn/wq_b"] == str(
        ref_state.opt["m"]["layers"]["attn"]["wq_b"].dtype)
    path = os.path.join(tmp_path, "{}", "step_00000003", "arrays.npz")
    with np.load(path.format("port")) as got, \
            np.load(path.format("ref")) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            a, b = got[k], want[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
    like = jax.tree.map(lambda x: jax.numpy.zeros_like(x), ref_state)
    if ref_state.opt["m"]["embedding"].dtype.name == "bfloat16":
        for who in ("port", "ref"):
            with pytest.raises(ValueError, match="cast"):
                jckpt.load_checkpoint(str(tmp_path / who), 3, like)
        return
    back = jckpt.load_checkpoint(str(tmp_path / "port"), 3, like)
    _assert_same(port, jax.tree.map(np.asarray, back))


def test_state_and_params_converters_round_trip(ref_state):
    port = state_from_jax(ref_state, "cpu")
    _assert_same(port, ref_state)
    _assert_same(state_to_jax(port), ref_state)
    cfg = get_smoke_config("qwen2.5-3b")
    model = params_from_jax(ref_state.params, cfg, device="cpu")
    _assert_same(params_to_jax(model), ref_state.params)
    _assert_same(params_to_jax(port.params), ref_state.params)


def test_port_state_names_and_order_equal_reference(tmp_path):
    """A port TrainState of the same config has the reference's leaf
    names, in JAX's order, with the reference's shapes and dtypes."""
    ref = jax.tree.map(np.asarray, j_init_train_state(
        j_build(j_smoke("llama3.2-3b")), jax.random.PRNGKey(0),
        JTrainConfig(grad_compression="int8", optimizer="adafactor")))
    port = init_train_state(
        build_model(get_smoke_config("llama3.2-3b"), device="cpu"),
        torch.Generator().manual_seed(0),
        TrainConfig(grad_compression="int8", optimizer="adafactor"))
    want = [(j_keystr(p), x.shape, str(x.dtype)) for p, x in
            jax.tree_util.tree_flatten_with_path(ref)[0]]
    got = [(keystr_simple(p), tuple(x.shape),
            str(x.dtype).removeprefix("torch.")) for p, x in
           flatten_with_path(port)]
    assert got == want


def test_manager_keeps_last_k_and_restores_latest(tmp_path):
    like = {"w": torch.zeros(3),
            "n": {"s": torch.zeros((), dtype=torch.int32)}}
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, {"w": torch.full((3,), float(step)),
                        "n": {"s": torch.tensor(step, dtype=torch.int32)}})
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    assert tckpt.latest_step(str(tmp_path)) == 4
    got, step = mgr.restore_latest(like)
    assert step == 4 and torch.equal(got["w"], torch.full((3,), 4.0))
    assert got["n"]["s"].shape == () and int(got["n"]["s"]) == 4
    assert tckpt.latest_step(str(tmp_path / "none")) is None
