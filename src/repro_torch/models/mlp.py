"""Feed-forward blocks: SwiGLU (llama family) and GELU MLP (whisper).

Port of ``repro.models.mlp``.  The activation runs in f32 and is cast to
the compute dtype before the gate product, which stays in that dtype, as
in the reference.  The reference's ``shard(...)`` constraints stand where
it has them (``sharding.shard``: the identity but on DTensors over
ranks)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.common import normal_init
from repro_torch.sharding import shard


def swiglu_init(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": normal_init(generator, (d, f), d ** -0.5, dtype),
        "w_up": normal_init(generator, (d, f), d ** -0.5, dtype),
        "w_down": normal_init(generator, (f, d), f ** -0.5, dtype),
    }


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = x @ p["w_gate"].to(dt)
    u = x @ p["w_up"].to(dt)
    h = shard(F.silu(g.float()).to(dt) * u, "batch", "seq", "mlp")
    return shard(h @ p["w_down"].to(dt), "batch", "seq", "embed")


def gelu_mlp_init(generator: torch.Generator, cfg: ModelConfig, d_in=None,
                  dtype=None) -> dict:
    d = d_in or cfg.d_model
    f = cfg.d_ff
    dtype = dtype or torch.float32
    dev = generator.device
    return {
        "fc1": normal_init(generator, (d, f), d ** -0.5, dtype),
        "fc1_b": torch.zeros((f,), dtype=dtype, device=dev),
        "fc2": normal_init(generator, (f, cfg.d_model), f ** -0.5, dtype),
        "fc2_b": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["fc1"].to(dt) + p["fc1_b"].to(dt)
    # jax.nn.gelu defaults to the tanh approximation
    h = shard(F.gelu(h.float(), approximate="tanh").to(dt),
              "batch", "seq", "mlp")
    return shard(h @ p["fc2"].to(dt) + p["fc2_b"].to(dt),
                 "batch", "seq", "embed")
