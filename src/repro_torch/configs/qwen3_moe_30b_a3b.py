"""qwen3-moe-30b-a3b [moe] — hf:Qwen/Qwen3-30B-A3B (hf tier).

48L, d_model=2048, 32 heads (GQA kv=4, head_dim=128), expert d_ff=768,
vocab=151936, 128 experts top-8.
"""
from repro_torch.config import FAMILY_MOE, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family=FAMILY_MOE,
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
        head_dim=128, d_ff=768, vocab_size=151936,
        rope_theta=1_000_000.0,
        moe=MoEConfig(num_experts=128, top_k=8))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family=FAMILY_MOE,
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=32, vocab_size=128,
        moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=4.0))
