"""phi3-mini-3.8b [dense]: RoPE SwiGLU, MHA-equivalent GQA (kv=32).
[arXiv:2404.14219; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10_000.0,
    source="arXiv:2404.14219; unverified",
)

SMOKE = CONFIG.replace(
    name="phi3-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=512,
)
