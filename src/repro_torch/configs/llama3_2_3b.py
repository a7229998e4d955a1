"""llama3.2-3b [dense] — small llama3, hf:meta-llama/Llama-3.2 (unverified).

28L, d_model=3072, 24 heads (GQA kv=8), d_ff=8192, vocab=128256.
"""
from repro_torch.config import FAMILY_DENSE, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", family=FAMILY_DENSE,
        num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
        d_ff=8192, vocab_size=128256, rope_theta=500_000.0,
        tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-smoke", family=FAMILY_DENSE,
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=128, tie_embeddings=True)
