"""qwen2.5-3b [dense] — GQA with QKV bias, hf:Qwen/Qwen2.5 family (hf tier).

36L, d_model=2048, 16 heads (GQA kv=2), d_ff=11008, vocab=151936, QKV bias,
tied embeddings.
"""
from repro_torch.config import FAMILY_DENSE, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family=FAMILY_DENSE,
        num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
        d_ff=11008, vocab_size=151936, qkv_bias=True, tie_embeddings=True,
        rope_theta=1_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke", family=FAMILY_DENSE,
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=128, qkv_bias=True, tie_embeddings=True)
