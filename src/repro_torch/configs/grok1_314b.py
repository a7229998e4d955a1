"""grok-1-314b [moe] — hf:xai-org/grok-1 (unverified tier).

64L, d_model=6144, 48 heads (GQA kv=8), expert d_ff=32768, vocab=131072,
8 experts top-2.
"""
from repro_torch.config import FAMILY_MOE, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family=FAMILY_MOE,
        num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=32768, vocab_size=131072,
        moe=MoEConfig(num_experts=8, top_k=2))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok1-smoke", family=FAMILY_MOE,
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=64, vocab_size=128,
        moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=4.0))
