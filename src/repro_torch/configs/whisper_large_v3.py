"""whisper-large-v3 [audio/enc-dec] — arXiv:2212.04356 (unverified tier).

32 decoder + 32 encoder layers, d_model=1280, 20 heads (MHA), d_ff=5120,
vocab=51866.  Conv/mel frontend is a STUB: input_specs provides precomputed
(B, 1500, d_model) frame embeddings.  Whisper uses GELU MLPs, LayerNorm,
learned decoder positions, tied output embedding.
"""
from repro_torch.config import FAMILY_ENCDEC, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family=FAMILY_ENCDEC,
        num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
        d_ff=5120, vocab_size=51866, encoder_layers=32, encoder_ctx=1500,
        act="gelu", frontend_stub=True, frontend_dim=1280,
        tie_embeddings=True, max_seq_len=33024, scan_layers=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family=FAMILY_ENCDEC,
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=128, encoder_layers=2, encoder_ctx=16,
        act="gelu", frontend_stub=True, frontend_dim=64,
        tie_embeddings=True, max_seq_len=64)
