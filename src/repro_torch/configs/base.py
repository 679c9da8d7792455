"""Config dataclasses shared by every architecture and the launch tooling."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden size
    capacity_factor: float = 1.25
    shared_expert: bool = False    # llama4-style always-on shared expert
    dense_residual: bool = False   # arctic-style parallel dense MLP path
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"           # "mamba2" | "rwkv6"
    state_dim: int = 64            # N (mamba2) / head_dim (rwkv6 per-head state)
    head_dim: int = 64             # P: channels per SSM head
    conv_kernel: int = 4           # depthwise conv width (mamba2)
    expand: int = 2                # d_inner = expand * d_model
    chunk: int = 128               # chunked-scan block length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: input_specs() hands the backbone precomputed
    frame/patch embeddings, per the assignment."""

    kind: str                      # "audio_frames" | "image_patches"
    n_tokens: int                  # encoder frames / image patches
    embed_dim: int                 # embedding dim delivered by the stub


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | encdec | ssm | hybrid | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # --- attention details -------------------------------------------------
    qk_norm: bool = False          # qwen3
    rope_theta: float = 10_000.0
    use_rope: bool = True
    attn_logit_softcap: float = 0.0
    # --- block details -----------------------------------------------------
    act: str = "silu"              # gated (swiglu) unless gated=False
    gated_mlp: bool = True
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0            # hybrid: shared attn block after every k SSM layers
    # --- encoder (enc-dec and vlm prefixes) --------------------------------
    enc_layers: int = 0
    frontend: Optional[FrontendConfig] = None
    # --- numerics / execution ----------------------------------------------
    param_dtype: str = "float32"   # training master layout (serve: bfloat16)
    compute_dtype: str = "bfloat16"
    remat: str = "full"            # full | dots | none
    scan_layers: bool = True
    attn_chunk: int = 1024         # KV-block size for chunked (flash-style) attention
    attn_chunk_q: int = 512        # Q-block size for chunked attention
    causal_skip: bool = False      # skip fully-masked KV blocks (causal only)
    attn_chunk_threshold: int = 2048   # use chunked attention when S >= this
    use_kernels: bool = False      # Pallas fast path (TPU); False on CPU/dry-run
    mlp_tp_overlap: bool = False   # Relic-ring TP MLP (needs seq act layout)
    bf16_reduce: bool = False      # bf16 cross-shard partial-sum reductions
    max_seq: int = 8192
    # --- notes --------------------------------------------------------------
    source: str = ""               # provenance tag from the assignment table

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def subquadratic(self) -> bool:
        """True iff decode state is O(1) in context length (SSM/hybrid-SSM)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int


# The four assigned LM-family shape cells.
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic (O(1)-state decode)
    archs; decode shapes skipped for encoder-only archs (none assigned)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} is pure full-attention — skipped per assignment"
        )
    return True, ""
