"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407
(unverified tier).

88L, d_model=12288, 96 heads (GQA kv=8, head_dim=128), d_ff=28672,
vocab=32768.
"""
from repro_torch.config import FAMILY_DENSE, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b", family=FAMILY_DENSE,
        num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
        head_dim=128, d_ff=28672, vocab_size=32768,
        rope_theta=1_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-smoke", family=FAMILY_DENSE,
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=128)
