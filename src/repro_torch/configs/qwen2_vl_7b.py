"""qwen2-vl-7b [vlm] — M-RoPE backbone, arXiv:2409.12191 (hf tier).

28L, d_model=3584, 28 heads (GQA kv=4), d_ff=18944, vocab=152064.  The
vision patch frontend is a STUB: input_specs provides M-RoPE position ids
(3, B, S); patch embeddings arrive as inputs_embeds when multimodal.
"""
from repro_torch.config import FAMILY_VLM, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family=FAMILY_VLM,
        num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
        d_ff=18944, vocab_size=152064, qkv_bias=True, mrope=True,
        mrope_sections=(16, 24, 24), rope_theta=1_000_000.0,
        frontend_stub=True, frontend_dim=3584)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", family=FAMILY_VLM,
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=128, qkv_bias=True, mrope=True,
        mrope_sections=(4, 2, 2), frontend_stub=True, frontend_dim=64)
