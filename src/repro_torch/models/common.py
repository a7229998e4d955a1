"""Shared model components: norms, rotary and sinusoidal position
embeddings (incl. M-RoPE), initializers.  Port of ``repro.models.common``: the same functional (init,
apply) pairs, where a layer's params are a mapping of tensors (a
``nn.ParameterDict`` inside a model).  Every apply function computes in
float32 inside and casts back to its input's dtype exactly where the
reference does, so bf16 results agree to the rounding of the last cast."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.sharding import (arange_like, is_dtensor, like, replicated,
                                  shard, sharded_dim, unshard, vocab_lookup)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; one of {tuple(_DTYPES)}")
    return _DTYPES[name]


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    """The activation/compute dtype (``cfg.dtype``)."""
    return _torch_dtype(cfg.dtype)


def pdtype_of(cfg: ModelConfig) -> torch.dtype:
    """The parameter storage dtype (``cfg.param_dtype``)."""
    return _torch_dtype(cfg.param_dtype)


def normal_init(generator: torch.Generator, shape, scale: float,
                dtype: torch.dtype) -> torch.Tensor:
    """N(0, scale²) drawn in float32 from ``generator`` on its device, cast
    to ``dtype``.  (Draws cannot reproduce ``jax.random``; parity with the
    reference goes through ``models.convert.params_from_jax``.)  On the
    meta device (``models.params.NO_DRAW``) nothing is drawn."""
    if generator.device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * scale).to(dtype)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Mean masked token cross-entropy, f32 accumulation."""
    lf = logits.float()
    if sharded_dim(lf, -1):
        logz, gold = _vocab_parallel(lf, targets)
    else:
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)


def _vocab_parallel(lf: torch.Tensor, targets: torch.Tensor):
    """logsumexp and the target's logit of f32 logits whose vocab dim is
    split over ranks (a DTensor), each as partial results over the rank's
    block of the vocab and one reduction: the max, then the sum of exp,
    and the target's logit where the block holds it.  DTensor's own
    ``logsumexp`` would gather the logits whole, and its ``gather`` on a
    split dim breaks on a 3-D index."""
    top = lf.detach().amax(dim=-1, keepdim=True)
    logz = torch.log(torch.sum(torch.exp(lf - top), dim=-1)) + top[..., 0]
    hit = targets.long()[..., None] == arange_like(lf, -1)
    gold = torch.sum(torch.where(hit, lf, 0.0), dim=-1)
    return logz, gold


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def gated_rmsnorm(scale: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Mamba2's RMSNorm(x * silu(z)) output gate."""
    xf = x.float() * F.silu(z.float())
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm_init(d: int, dtype, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------

def _inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin (..., S, head_dim/2) in f32."""
    inv = replicated(_inv_freq(head_dim, theta, positions.device), positions)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, int, int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL multimodal RoPE.

    positions: (3, B, S) — temporal / height / width position ids.  The
    head_dim/2 frequency slots are split into three contiguous sections,
    each driven by its own position stream."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to "
                         f"head_dim/2 = {half}")
    inv = replicated(_inv_freq(head_dim, theta, positions.device), positions)
    sec_id = torch.cat([torch.full((s,), i, dtype=torch.long,
                                   device=positions.device)
                        for i, s in enumerate(sections)])
    # (half, B, S); index_select, as DTensor has no rule for aten.index
    pos_sel = torch.index_select(positions.float(), 0,
                                 replicated(sec_id, positions))
    pos_sel = torch.movedim(pos_sel, 0, -1)                  # (B, S, half)
    ang = pos_sel * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (..., S, H, D); cos/sin (..., S, D/2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (n, d) f32 on ``device``
    (default CUDA).  The reference's own f32 arithmetic; at whisper's
    (1500, 1280) an angle near 1,400 rad has an f32 ulp of 1.2e-4, so
    torch's and XLA's ``pow``/``sin``/``cos`` leave up to 3.1e-5 between
    the two tables (ROADMAP.md §3)."""
    dev = resolve_device(device)
    pos = torch.arange(n, dtype=torch.float32, device=dev)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=dev)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# token embedding, logits and positions of the LM families
# ---------------------------------------------------------------------------

def embed(table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """The rows of ``table`` (V, d) for ``tokens``, in ``dtype``, at the
    reference's constraint; over ranks the table FSDP-gathered and looked
    up on each rank's own rows (``sharding.vocab_lookup``)."""
    if is_dtensor(table):
        x = vocab_lookup(unshard(table, "pod", "data"), tokens)
    else:
        x = table[tokens.long()]
    return shard(x.to(dtype), "batch", "seq", "embed")


def lm_logits(head: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` against the output head (d, V) (a tied embedding's ``.T``),
    at the reference's constraint (the vocab split over ``model`` where it
    divides)."""
    return shard(x @ head.to(x.dtype), "batch", "seq", "vocab")


def prompt_end(b: int, s: int, x: torch.Tensor) -> torch.Tensor:
    """(b,) int32 positions ``s`` after a prompt, laid out as ``x``'s
    rows."""
    return shard(replicated(torch.full((b,), s, dtype=torch.int32,
                                       device=x.device), x), "batch")


def token_positions(tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) positions 0..S-1, laid out as ``tokens`` (a DTensor's own
    rows on each rank)."""
    local = tokens.to_local() if is_dtensor(tokens) else tokens
    b, s = local.shape
    return like(torch.arange(s, device=local.device)[None].expand(b, s),
                tokens)
