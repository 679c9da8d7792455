"""paligemma-3b [vlm]: SigLIP patch embeddings (stubbed) + gemma backbone,
prefix-LM attention, MQA kv=1. [arXiv:2407.07726; hf]"""

from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    act="gelu",             # GeGLU
    rope_theta=10_000.0,
    tie_embeddings=True,
    frontend=FrontendConfig(kind="image_patches", n_tokens=256, embed_dim=1152),
    source="arXiv:2407.07726; hf",
)

SMOKE = CONFIG.replace(
    name="paligemma-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
    vocab_size=512,
    frontend=FrontendConfig(kind="image_patches", n_tokens=8, embed_dim=32),
)
