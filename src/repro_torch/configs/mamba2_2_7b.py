"""mamba2-2.7b [ssm] — SSD (state-space duality), arXiv:2405.21060
(unverified tier).

64L, d_model=2560 (attention-free), vocab=50280, ssm_state=128, head_dim=64,
expand=2 (d_inner=5120, 80 SSM heads).
"""
from repro_torch.config import FAMILY_SSM, ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family=FAMILY_SSM,
        num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=256))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family=FAMILY_SSM,
        num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=128,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk=8))
