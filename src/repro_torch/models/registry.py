"""Uniform model interface over the ported families (port of
``repro.models.registry``).

``build_model(cfg, device=None)`` returns an object exposing:
    init(generator) -> params
    forward(params, tokens, ...) -> (logits, aux)
    prefill(params, ...) -> (logits, decode_state)
    decode_step(params, state, token) -> (logits, decode_state)
    init_decode_state(batch, s_max) -> decode_state

The dense, moe and vlm families are ported (``CausalLM``); the others
raise ``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

from repro_torch.config import (FAMILY_DENSE, FAMILY_ENCDEC, FAMILY_HYBRID,
                                FAMILY_MOE, FAMILY_SSM, FAMILY_VLM,
                                ModelConfig)
from repro_torch.models.transformer import CausalLM

_NOT_PORTED = {
    FAMILY_ENCDEC: "the encdec family (models/whisper.py)",
    FAMILY_SSM: "the ssm family (models/ssm.py, mamba_lm.py)",
    FAMILY_HYBRID: "the hybrid family (models/zamba2.py, ssm.py)",
}


def build_model(cfg: ModelConfig, device=None):
    """The model of ``cfg`` on ``device`` (default CUDA)."""
    if cfg.family in (FAMILY_DENSE, FAMILY_MOE, FAMILY_VLM):
        return CausalLM(cfg, device=device)
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(f"{_NOT_PORTED[cfg.family]} is not ported "
                                  f"yet: ROADMAP.md §1 item 6")
    raise ValueError(f"unknown family {cfg.family!r}")
