"""Uniform model interface over the ported families (port of
``repro.models.registry``).

``build_model(cfg, device=None)`` returns an object exposing:
    init(generator) -> params
    forward(params, tokens, ...) -> (logits, aux)
    prefill(params, ...) -> (logits, decode_state)
    decode_step(params, state, token) -> (logits, decode_state)
    init_decode_state(batch, s_max) -> decode_state

Every family is ported: dense, moe and vlm (``CausalLM``), ssm
(``MambaLM``), hybrid (``Zamba2Model``) and encdec (``WhisperModel``,
whose ``forward`` and ``prefill`` take the frames before the tokens).
"""
from __future__ import annotations

from repro_torch.config import (FAMILY_DENSE, FAMILY_ENCDEC, FAMILY_HYBRID,
                                FAMILY_MOE, FAMILY_SSM, FAMILY_VLM,
                                ModelConfig)
from repro_torch.models.mamba_lm import MambaLM
from repro_torch.models.transformer import CausalLM
from repro_torch.models.whisper import WhisperModel
from repro_torch.models.zamba2 import Zamba2Model


def build_model(cfg: ModelConfig, device=None):
    """The model of ``cfg`` on ``device`` (default CUDA)."""
    if cfg.family in (FAMILY_DENSE, FAMILY_MOE, FAMILY_VLM):
        return CausalLM(cfg, device=device)
    if cfg.family == FAMILY_SSM:
        return MambaLM(cfg, device=device)
    if cfg.family == FAMILY_HYBRID:
        return Zamba2Model(cfg, device=device)
    if cfg.family == FAMILY_ENCDEC:
        return WhisperModel(cfg, device=device)
    raise ValueError(f"unknown family {cfg.family!r}")
