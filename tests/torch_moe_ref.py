"""Reference outputs of ``repro.models.moe_a2a`` on a mesh of 8 devices,
for ``tests/test_torch_moe.py``.

    python tests/torch_moe_ref.py OUT.npz

XLA must be told to make 8 host devices before JAX is imported, hence a
process of its own.  Writes, per case, the inputs (weights, tokens) and
``moe_ffn_sharded``'s output and aux loss on a (2, 4) ("data", "model")
mesh: 8 experts (the a2a path, 2 experts a position) and 2 experts (the
tp path) at capacity factors 8.0 (nothing drops) and 1.0 (tokens drop);
and one ``CausalLM.forward`` of the qwen3-moe smoke config under
``use_rules`` with ``set_moe_impl("a2a")``.  Every call is jitted.
"""
import os
import sys

# 8 host devices; LLVM's level-0 optimization halves the compile time of
# these small programs (16 s -> 9 s for the file); the program is the same
os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 "
    "--xla_backend_optimization_level=0 "
    + os.environ.get("XLA_FLAGS", ""))

import dataclasses                                      # noqa: E402

import jax                                              # noqa: E402
import jax.numpy as jnp                                 # noqa: E402
import numpy as np                                      # noqa: E402

from repro.config import FAMILY_MOE, ModelConfig, MoEConfig  # noqa: E402
from repro.configs import get_smoke_config              # noqa: E402
from repro.models import build_model                    # noqa: E402
from repro.models import moe as moe_mod                 # noqa: E402
from repro.models import moe_a2a                        # noqa: E402
from repro.sharding import DEFAULT_RULES, use_rules     # noqa: E402

MESH = ((2, 4), ("data", "model"))
X_SHAPE = (4, 32, 32)                   # 128 tokens, 16 a position (a2a)
# (case name, experts, capacity factor)
FFN_CASES = [(f"{path}_cf{cf:g}", e, cf)
             for path, e in (("a2a", 8), ("tp", 2)) for cf in (8.0, 1.0)]
LM_ARCH = "qwen3-moe-30b-a3b"
LM_TOKENS = (2, 16)


def ffn_config(num_experts: int, capacity_factor: float) -> ModelConfig:
    return ModelConfig(
        name="t", family=FAMILY_MOE, num_layers=1, d_model=32, num_heads=4,
        num_kv_heads=2, d_ff=16, vocab_size=64, dtype="float32",
        moe=MoEConfig(num_experts=num_experts, top_k=2,
                      capacity_factor=capacity_factor))


def lm_config() -> ModelConfig:
    return dataclasses.replace(get_smoke_config(LM_ARCH), dtype="float32")


def main(out_path: str) -> None:
    assert len(jax.devices()) == 8, jax.devices()
    mesh = jax.make_mesh(*MESH, axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for name, e, cf in FFN_CASES:
        cfg = ffn_config(e, cf)
        p = moe_mod.moe_init(jax.random.PRNGKey(e), cfg, jnp.float32)
        x = np.random.RandomState(e).normal(size=X_SHAPE).astype(np.float32)
        with use_rules(DEFAULT_RULES, mesh):
            y, aux = jax.jit(
                lambda pp, xx: moe_a2a.moe_ffn_sharded(pp, xx, cfg))(
                    p, jnp.asarray(x))
        out[f"{name}/x"] = x
        for k, v in p.items():
            out[f"{name}/p/{k}"] = np.asarray(v)
        out[f"{name}/y"] = np.asarray(y)
        out[f"{name}/aux"] = np.asarray(aux)

    cfg = lm_config()
    model = build_model(cfg)
    tree = model.init(jax.random.PRNGKey(0))
    toks = np.random.RandomState(3).randint(0, cfg.vocab_size,
                                            size=LM_TOKENS)
    moe_a2a.set_moe_impl("a2a")
    try:
        with use_rules(DEFAULT_RULES, mesh):
            logits, aux = jax.jit(
                lambda pp, tt: model.forward(pp, tt, remat=False))(
                    tree, jnp.asarray(toks))
    finally:
        moe_a2a.set_moe_impl("gspmd")
    out["lm/tokens"] = toks
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["lm/p/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
    out["lm/logits"] = np.asarray(logits)
    out["lm/aux"] = np.asarray(aux)
    np.savez(out_path, **out)
    print("REFERENCE_OK")


if __name__ == "__main__":
    main(sys.argv[1])
