"""Configuration for the port: the port's own copy of ``repro.config``.

Plain frozen dataclasses so configs are hashable, serializable, and
diffable.  Every assigned architecture has a module in
``repro_torch.configs`` that returns a :class:`ModelConfig`; search / train /
serve behaviour is configured with the companion dataclasses here.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

# Families understood by the model registry.
FAMILY_DENSE = "dense"          # llama-style decoder-only GQA transformer
FAMILY_MOE = "moe"              # dense + mixture-of-experts FFN
FAMILY_ENCDEC = "encdec"        # whisper-style encoder-decoder
FAMILY_VLM = "vlm"              # decoder backbone w/ M-RoPE + patch frontend stub
FAMILY_SSM = "ssm"              # mamba2 (SSD) attention-free
FAMILY_HYBRID = "hybrid"        # zamba2: mamba2 trunk + shared attention blocks

ALL_FAMILIES = (
    FAMILY_DENSE, FAMILY_MOE, FAMILY_ENCDEC, FAMILY_VLM, FAMILY_SSM,
    FAMILY_HYBRID,
)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""
    num_experts: int = 0
    top_k: int = 0
    # capacity factor for expert buffers (tokens per expert =
    # cf * tokens * top_k / num_experts), standard for dropping/padding.
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""
    state_dim: int = 128          # N, per-head SSM state size
    head_dim: int = 64            # P, channels per SSM head
    expand: int = 2               # d_inner = expand * d_model
    chunk: int = 256              # SSD chunk length
    conv_width: int = 4           # depthwise causal conv width
    ngroups: int = 1              # B/C groups (GVA-style)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture configuration (exact values from the assignment table)."""
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    # --- attention details ---
    rope_theta: float = 10000.0
    qkv_bias: bool = False        # qwen2 uses bias on QKV
    mrope: bool = False           # qwen2-vl multimodal rope (3 sections)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    sliding_window: int = 0       # 0 = full attention
    # --- norm / act ---
    norm_eps: float = 1e-5
    act: str = "silu"             # silu (swiglu) | gelu (whisper)
    # --- families ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every k mamba layers
    hybrid_attn_every: int = 6
    # encoder-decoder (whisper): encoder config mirrors decoder dims
    encoder_layers: int = 0
    encoder_ctx: int = 1500       # whisper: 30s audio -> 1500 frames
    # vlm / audio frontends are STUBS: input_specs provides embeddings directly
    frontend_stub: bool = False
    frontend_dim: int = 0         # embedding dim delivered by the stub
    max_seq_len: int = 131072
    tie_embeddings: bool = False
    # scan-over-layers for compile-time/HLO-size control (heterogeneous
    # families override how the scan is blocked)
    scan_layers: bool = True
    # dtypes
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"  # parameter storage dtype

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_subquadratic(self) -> bool:
        """True when 500k-token contexts are tractable (SSM/hybrid/windowed)."""
        return self.family in (FAMILY_SSM, FAMILY_HYBRID) or self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs and memory)."""
        d, h = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        emb = self.vocab_size * d
        out = 0 if self.tie_embeddings else self.vocab_size * d
        per_layer = 0
        if self.family in (FAMILY_DENSE, FAMILY_MOE, FAMILY_VLM):
            attn = d * (n_q * h) + 2 * d * (n_kv * h) + (n_q * h) * d
            if self.moe:
                ffn = self.moe.num_experts * 3 * d * self.d_ff + d * self.moe.num_experts
            else:
                ffn = 3 * d * self.d_ff
            per_layer = attn + ffn + 2 * d
            total = emb + out + per_layer * self.num_layers + d
        elif self.family == FAMILY_ENCDEC:
            attn = d * (n_q * h) + 2 * d * (n_kv * h) + (n_q * h) * d
            ffn = 2 * d * self.d_ff  # whisper uses gelu MLP (fc1, fc2)
            dec_layer = 2 * attn + ffn + 3 * d   # self + cross attn
            enc_layer = attn + ffn + 2 * d
            total = (emb + out + dec_layer * self.num_layers
                     + enc_layer * self.encoder_layers + 2 * d)
        elif self.family == FAMILY_SSM:
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            proj_in = d * (2 * d_in + 2 * s.ngroups * s.state_dim + nheads)
            conv = s.conv_width * (d_in + 2 * s.ngroups * s.state_dim)
            per_layer = proj_in + conv + d_in * d + nheads * 2 + d_in + d
            total = emb + out + per_layer * self.num_layers + d
        elif self.family == FAMILY_HYBRID:
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            proj_in = d * (2 * d_in + 2 * s.ngroups * s.state_dim + nheads)
            conv = s.conv_width * (d_in + 2 * s.ngroups * s.state_dim)
            mamba_layer = proj_in + conv + d_in * d + nheads * 2 + d_in + d
            attn = (2 * d) * (n_q * h) + 2 * (2 * d) * (n_kv * h) + (n_q * h) * d
            shared_attn = attn + 3 * (2 * d) * self.d_ff + 2 * (2 * d)
            n_attn_applications = self.num_layers // (self.hybrid_attn_every + 1)
            n_mamba = self.num_layers - n_attn_applications
            # zamba2 shares ONE attention block's weights across applications
            total = emb + out + mamba_layer * n_mamba + shared_attn + d
        else:
            raise ValueError(f"unknown family {self.family}")
        return int(total)

    def active_param_count(self) -> int:
        """Active (per-token) parameters — differs from total only for MoE."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        dense_ffn_total = self.num_layers * self.moe.num_experts * 3 * d * self.d_ff
        active_ffn = self.num_layers * self.moe.top_k * 3 * d * self.d_ff
        return self.param_count() - dense_ffn_total + active_ffn


# ---------------------------------------------------------------------------
# Shapes (assigned input-shape sets)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# Speed-ANN search configuration (lives in repro_torch.core.config)
# ---------------------------------------------------------------------------

from repro_torch.core.config import SearchConfig  # noqa: E402,F401


# ---------------------------------------------------------------------------
# Mesh / training configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    # ZeRO-1: optimizer-state sharding dtype ("float32" | "bfloat16");
    # >=100B configs use bf16 moments to fit a 256x16GB pod.
    moment_dtype: str = "float32"
    optimizer: str = "adamw"      # "adamw" | "adafactor"
    microbatches: int = 1         # gradient accumulation steps
    remat: str = "full"           # "none" | "full" | "selective"
    grad_compression: str = "none"  # "none" | "int8"
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3


def to_json(cfg: Any) -> str:
    def default(o):
        if dataclasses.is_dataclass(o):
            return dataclasses.asdict(o)
        raise TypeError(type(o))
    return json.dumps(cfg, default=default, indent=2)
