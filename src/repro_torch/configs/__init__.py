"""Architecture registry (the port's copy of ``repro.configs``): the 10
assigned configs.

``get_config(arch_id)`` / ``get_smoke_config(arch_id)`` resolve by id;
``--arch <id>`` flags on the launchers go through here.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig

ARCH_IDS: List[str] = [
    "whisper-large-v3",
    "yi-9b",
    "qwen2.5-3b",
    "llama3.2-3b",
    "mistral-large-123b",
    "qwen3-moe-30b-a3b",
    "grok-1-314b",
    "qwen2-vl-7b",
    "mamba2-2.7b",
    "zamba2-7b",
]

_MODULES: Dict[str, str] = {
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "yi-9b": "repro_torch.configs.yi_9b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "llama3.2-3b": "repro_torch.configs.llama3_2_3b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}


def get_config(arch_id: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch_id]).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch_id]).smoke_config()
