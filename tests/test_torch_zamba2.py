"""The port's hybrid family against ``repro.models.zamba2``, on the CPU.

zamba2-smoke (7 positions: 2 groups of 2 mamba layers and the shared
block, then 1 tail layer) through ``params_from_jax``: forward logits
(f32, and bf16 against the reference run op by op), prefill and decode
with every state leaf (grouped and tail SSM states, each application's KV
cache), loss and every gradient leaf (the shared block's summed over its
applications), branches from one state, greedy ``ServeEngine`` tokens,
also past the end of the cache, the tree and a checkpoint across both
ways, one AdamW step and the two launchers; and a layout with no tail
layer (6 positions), whose tail state is the reference's zeros.

Tolerances: f32 rtol = atol = 1e-5; bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_case as case
from repro.models import build_model as j_build
from repro.models.zamba2 import _layout as j_layout
from repro.serve import ServeEngine as JEngine
from repro_torch.models.zamba2 import _layout
from repro_torch.serve import ServeEngine

ARCH = "zamba2-7b"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The smoke models' ops are tiny: one torch thread a test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("num_layers", [7, 6])
def test_zamba2_forward_prefill_decode_match(num_layers):
    """7 positions: 2 groups and 1 tail layer; 6: 2 groups and none (the
    tail state stays the reference's zeros)."""
    cfg_j, cfg_t = case.configs(ARCH, num_layers=num_layers)
    assert _layout(cfg_t) == j_layout(cfg_j) == \
        (2, 2, 1 if num_layers == 7 else 0)
    case.check_forward_prefill_decode(ARCH, num_layers=num_layers)


def test_zamba2_bf16_forward_matches_op_by_op():
    case.check_bf16_forward(ARCH)


def test_zamba2_loss_and_gradients_match():
    case.check_loss_and_grads(ARCH)


def test_zamba2_decode_branches_from_one_state():
    case.check_branches(ARCH, lambda st: st.attn_caches.k)


def test_zamba2_greedy_tokens_equal_jax_engine():
    case.check_greedy(ARCH)


def test_zamba2_decode_past_s_max_equals_reference():
    """Positions 10 and 11 fall past a 10-slot cache: the shared block's
    writes there are dropped in every application and it attends over all
    10 slots, in both packages."""
    cfg_j, _, tree, params = case.models(ARCH)
    prompt = case.tokens(cfg_j.vocab_size, seed=1, shape=(3, 8))
    toks_j, last_j = JEngine(j_build(cfg_j), tree, s_max=10).generate(
        jnp.asarray(prompt), steps=5)
    toks_t, last_t = ServeEngine(params, params, s_max=10).generate(
        prompt, steps=5)
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    case.close(last_t, last_j, 1e-5)


def test_zamba2_params_and_checkpoint_cross_both_ways(tmp_path):
    ref = case.check_params_and_checkpoint(ARCH, tmp_path)
    assert ref["grouped"]["mamba"]["in_proj"].shape == (2, 2, 64, 296)
    assert ref["tail"]["norm"]["scale"].shape == (1, 64)
    assert ref["shared"]["attn"]["wq"].shape == (128, 128)


def test_zamba2_train_step_equals_reference():
    case.check_train_step(ARCH)


def test_launch_serve_and_train_zamba2_run_on_cpu(tmp_path, capsys):
    case.check_launchers(ARCH, "zamba2-smoke", tmp_path, capsys)


def test_zamba2_tail_free_state_is_zeros():
    """With no tail layer the reference keeps a zero tail state with a
    leading 1 and returns it unchanged from a decode step; so does the
    port, from prefill and from ``init_decode_state``."""
    _, _, _, params = case.models(ARCH, num_layers=6)
    tok = torch.from_numpy(case.tokens(128, shape=(2, 5)))
    _, st = params.prefill(params, tok, 8)
    for state in (st, params.init_decode_state(2, 8)):
        assert state.ssm_tail.ssm.shape == (1, 2, 8, 16, 16)
        assert not bool(state.ssm_tail.ssm.any())
        _, nxt = params.decode_step(params, state, tok[:, :1])
        assert torch.equal(nxt.ssm_tail.ssm, state.ssm_tail.ssm)
