"""yi-9b [dense] — llama-arch GQA, arXiv:2403.04652 (hf tier).

48L, d_model=4096, 32 heads (GQA kv=4), d_ff=11008, vocab=64000.
"""
from repro_torch.config import FAMILY_DENSE, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b", family=FAMILY_DENSE,
        num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
        d_ff=11008, vocab_size=64000, rope_theta=5_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-smoke", family=FAMILY_DENSE,
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=128)
