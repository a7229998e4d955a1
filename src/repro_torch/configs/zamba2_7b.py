"""zamba2-7b [hybrid] — Mamba2 + shared attention blocks, arXiv:2411.15242
(unverified tier).

81 layers (70 mamba2 + 11 shared-attn applications at every 7th position),
d_model=3584, 32 heads (MHA kv=32) in the shared block, d_ff=14336,
vocab=32000, ssm_state=64.
"""
from repro_torch.config import FAMILY_HYBRID, ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family=FAMILY_HYBRID,
        num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
        head_dim=224, d_ff=14336, vocab_size=32000, hybrid_attn_every=6,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk=256))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family=FAMILY_HYBRID,
        num_layers=7, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=32, d_ff=128, vocab_size=128, hybrid_attn_every=2,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk=8))
