"""The port's ssm family against ``repro.models.ssm``, ``common.
gated_rmsnorm`` and ``repro.models.mamba_lm``, on the CPU.

* ``gated_rmsnorm``, ``_segsum``, ``ssd_chunked`` (against the
  reference's, and against ``ssd_scan_ref``, with and without an initial
  state, B and C in float32 and bf16), ``mamba2_forward`` with its state
  (a T the config's chunk divides, a T that forces chunks of 1, a T below
  the conv window, an initial state) and ``mamba2_step`` over several
  steps; bf16 against the reference run op by op.
* The deterministic init leaves: the linspaces bit for bit at the smoke
  config's 8 heads and at mamba2-2.7b's 80 and zamba2-7b's 112; A_log and
  dt_bias within one ulp (XLA's log/expm1 are not torch's: ROADMAP.md
  §3); D, conv_b and ssm_norm exactly.
* mamba2-smoke through ``params_from_jax``: forward logits (f32, and bf16
  op by op), prefill and decode with their states, loss and every
  gradient leaf, branches from one state, greedy ``ServeEngine`` tokens,
  the tree and a checkpoint across both ways, one AdamW step, and the two
  launchers.

Tolerances: f32 rtol = atol = 1e-5; bf16 2e-2 (3e-2 after a decode step),
the bounds of ``tests/test_torch_models.py``.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_case as case
from repro.configs import get_smoke_config as j_smoke
from repro.models import common as j_common
from repro.models import ssm as j_ssm
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import common as t_common
from repro_torch.models import ssm as t_ssm

ARCH = "mamba2-2.7b"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The smoke models' ops are tiny: with every worker of a parallel
    test run using all cores, torch's intra-op threads spin against each
    other.  One thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _both(a, dtype):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _reference(dtype):
    return jax.disable_jit() if dtype == "bfloat16" \
        else contextlib.nullcontext()


# f32 runs of the reference are compiled (one compile a shape, where op by
# op compiles each op); bf16 runs go op by op (see the module docstring)
_J_FORWARD = jax.jit(j_ssm.mamba2_forward,
                     static_argnames=("cfg", "return_state"))
_J_STEP = jax.jit(j_ssm.mamba2_step, static_argnames=("cfg",))


def _j_forward(dtype, p, x, cfg, state=None):
    fn = j_ssm.mamba2_forward if dtype == "bfloat16" else _J_FORWARD
    with _reference(dtype):
        return fn(p, x, cfg=cfg, state=state, return_state=True)


def _j_step(dtype, p, x, cfg, state):
    fn = j_ssm.mamba2_step if dtype == "bfloat16" else _J_STEP
    with _reference(dtype):
        return fn(p, x, cfg=cfg, state=state)


# ---------------------------------------------------------------------------
# the block's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gated_rmsnorm_matches(dtype):
    xj, xt = _both(_rand((2, 5, 64), 0, 3.0), dtype)
    zj, zt = _both(_rand((2, 5, 64), 1, 2.0), dtype)
    scale = _rand((64,), 2) + 1.0
    got = t_common.gated_rmsnorm(torch.from_numpy(scale), xt, zt, 1e-5)
    want = j_common.gated_rmsnorm(jnp.asarray(scale), xj, zj, 1e-5)
    assert got.dtype == DTYPES[dtype][1]
    case.close(got, want, DTYPES[dtype][2])


def test_segsum_matches():
    x = -np.abs(_rand((2, 3, 8), 3, 0.5))
    got = t_ssm._segsum(torch.from_numpy(x)).numpy()
    want = np.asarray(j_ssm._segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5,
                               atol=1e-5)


def _ssd_inputs(b, t, h, p, g, n, seed, bc_dtype=np.float32):
    xdt = _rand((b, t, h, p), seed)
    a_dt = -np.abs(_rand((b, t, h), seed + 1, 0.3))
    bmat = _rand((b, t, g, n), seed + 2, 0.5)
    cmat = _rand((b, t, g, n), seed + 3, 0.5)
    if bc_dtype != np.float32:
        # values a bf16 conv output holds
        bmat = np.asarray(jnp.asarray(bmat).astype(jnp.bfloat16), np.float32)
        cmat = np.asarray(jnp.asarray(cmat).astype(jnp.bfloat16), np.float32)
    return xdt, a_dt, bmat, cmat


@pytest.mark.parametrize("b,t,h,p,g,n,chunk,with_h0,bc", [
    (2, 16, 4, 8, 1, 8, 8, False, "float32"),
    (2, 16, 6, 4, 2, 8, 4, True, "float32"),
    (1, 12, 4, 8, 1, 16, 12, True, "bfloat16")])
def test_ssd_chunked_matches(b, t, h, p, g, n, chunk, with_h0, bc):
    """The chunked SSD against the reference's (its y and final state),
    and both against the sequential oracles (the port's and the
    reference's ``ssd_scan_ref``)."""
    xdt, a_dt, bmat, cmat = _ssd_inputs(b, t, h, p, g, n, 5)
    h0 = _rand((b, h, p, n), 9, 0.5) if with_h0 else None
    jbc = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)) if bc == \
        "bfloat16" else jnp.asarray
    tbc = (lambda a: torch.from_numpy(a).bfloat16()) if bc == "bfloat16" \
        else torch.from_numpy
    jh0 = None if h0 is None else jnp.asarray(h0)
    th0 = None if h0 is None else torch.from_numpy(h0)
    want = jax.jit(j_ssm.ssd_chunked, static_argnums=(4,))(
        jnp.asarray(xdt), jnp.asarray(a_dt), jbc(bmat), jbc(cmat), chunk,
        h0=jh0)
    got = t_ssm.ssd_chunked(torch.from_numpy(xdt), torch.from_numpy(a_dt),
                            tbc(bmat), tbc(cmat), chunk, h0=th0)
    oracle_j = jax.jit(j_ssm.ssd_scan_ref)(jnp.asarray(xdt),
                                           jnp.asarray(a_dt), jbc(bmat),
                                           jbc(cmat), h0=jh0)
    oracle_t = t_ssm.ssd_scan_ref(torch.from_numpy(xdt),
                                  torch.from_numpy(a_dt), tbc(bmat),
                                  tbc(cmat), h0=th0)
    for g_, w_, oj, ot in zip(got, want, oracle_j, oracle_t):
        assert g_.dtype == torch.float32 and g_.shape == w_.shape
        case.close(g_, w_, 1e-5)
        case.close(ot, oj, 1e-5)
        case.close(g_, oj, 1e-5)


def _block(dtype, seed=0):
    cfg_j = dataclasses.replace(j_smoke(ARCH), dtype=dtype)
    cfg_t = dataclasses.replace(t_smoke(ARCH), dtype=dtype)
    pj = j_ssm.mamba2_init(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    return cfg_j, cfg_t, pj, pt


@pytest.mark.parametrize("t,with_state,dtype", [
    (16, False, "float32"),     # chunk 8
    (15, False, "float32"),     # gcd(15, 8) = 1: chunks of 1
    (2, False, "float32"),      # T < W - 1: a zero-padded conv tail
    (12, True, "float32"),      # chunk 4, an initial state
    (16, True, "bfloat16")])
def test_mamba2_forward_matches(t, with_state, dtype):
    """The block's output and its state (the conv tail of pre-conv
    inputs, the final SSM state)."""
    cfg_j, cfg_t, pj, pt = _block(dtype)
    xj, xt = _both(_rand((2, t, cfg_j.d_model), 11), dtype)
    sj = st = None
    if with_state:
        h0 = _rand((2, 8, 16, 16), 12, 0.5)
        sj = j_ssm.SSMState(conv=None, ssm=jnp.asarray(h0))
        st = t_ssm.SSMState(conv=None, ssm=torch.from_numpy(h0))
    out_j, state_j = _j_forward(dtype, pj, xj, cfg_j, sj)
    out_t, state_t = t_ssm.mamba2_forward(pt, xt, cfg_t, state=st,
                                          return_state=True)
    tol = DTYPES[dtype][2]
    assert out_t.dtype == DTYPES[dtype][1]
    case.close(out_t, out_j, tol)
    assert state_t.conv.dtype == DTYPES[dtype][1]
    case.close(state_t.conv, state_j.conv, tol)
    case.close(state_t.ssm, state_j.ssm, tol)
    out_n, none = t_ssm.mamba2_forward(pt, xt, cfg_t, state=st)
    assert none is None and torch.equal(out_n, out_t)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba2_step_matches(dtype):
    """Decode steps from a prefill's state: outputs and states."""
    cfg_j, cfg_t, pj, pt = _block(dtype, seed=1)
    xj, xt = _both(_rand((2, 16, cfg_j.d_model), 13), dtype)
    tol = DTYPES[dtype][2] * (1.5 if dtype == "bfloat16" else 1)
    _, sj = _j_forward(dtype, pj, xj, cfg_j)
    _, st = t_ssm.mamba2_forward(pt, xt, cfg_t, return_state=True)
    for i in range(2):
        yj, yt = _both(_rand((2, 1, cfg_j.d_model), 14 + i), dtype)
        oj, sj = _j_step(dtype, pj, yj, cfg_j, sj)
        before = st.ssm.clone()
        ot, st_new = t_ssm.mamba2_step(pt, yt, cfg_t, st)
        assert torch.equal(st.ssm, before)
        st = st_new
        case.close(ot, oj, tol)
        case.close(st.conv, sj.conv, tol)
        case.close(st.ssm, sj.ssm, tol)


@pytest.mark.parametrize("nheads", [8, 80, 112])
def test_deterministic_init_leaves(nheads):
    """The linspaces bit for bit; A_log and dt_bias within one ulp; D,
    conv_b and ssm_norm exactly.  80 and 112 are the heads of mamba2-2.7b
    and zamba2-7b (d_in = 2·d; head_dim 2 keeps the widths small)."""
    cfg_j = dataclasses.replace(j_smoke(ARCH), d_model=nheads,
                                ssm=dataclasses.replace(j_smoke(ARCH).ssm,
                                                        head_dim=2))
    cfg_t = dataclasses.replace(t_smoke(ARCH), d_model=nheads,
                                ssm=dataclasses.replace(t_smoke(ARCH).ssm,
                                                        head_dim=2))
    for start, stop in ((1.0, 16.0), (1e-3, 1e-1)):
        want = np.asarray(jnp.linspace(start, stop, nheads))
        got = t_ssm.linspace_f32(start, stop, nheads).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    want = jax.tree.map(np.asarray, j_ssm.mamba2_init(
        jax.random.PRNGKey(0), cfg_j, jnp.float32))
    got = t_ssm.mamba2_init(torch.Generator().manual_seed(0), cfg_t,
                            torch.float32)
    assert got.keys() == want.keys()
    for k in ("A_log", "dt_bias"):
        assert got[k].dtype == torch.float32
        ulps = np.abs(got[k].numpy().view(np.int32).astype(np.int64)
                      - want[k].view(np.int32))
        assert ulps.max() <= 1, (k, ulps)
    for k in ("D", "conv_b", "ssm_norm"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k


# ---------------------------------------------------------------------------
# MambaLM
# ---------------------------------------------------------------------------

def test_mamba_lm_forward_prefill_decode_match():
    case.check_forward_prefill_decode(ARCH)


def test_mamba_lm_bf16_forward_matches_op_by_op():
    case.check_bf16_forward(ARCH, seq=16)


def test_mamba_lm_loss_and_gradients_match():
    case.check_loss_and_grads(ARCH)


def test_mamba_decode_branches_from_one_state():
    case.check_branches(ARCH, lambda st: st.states.ssm)


def test_mamba_greedy_tokens_equal_jax_engine():
    case.check_greedy(ARCH)


def test_mamba_params_and_checkpoint_cross_both_ways(tmp_path):
    ref = case.check_params_and_checkpoint(ARCH, tmp_path)
    assert ref["layers"]["mamba"]["in_proj"].shape == (2, 64, 296)


def test_mamba_train_step_equals_reference():
    case.check_train_step(ARCH)


def test_launch_serve_and_train_mamba_run_on_cpu(tmp_path, capsys):
    case.check_launchers(ARCH, "mamba2-smoke", tmp_path, capsys)
