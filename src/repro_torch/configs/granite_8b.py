"""granite-8b [dense]: llama-arch code model, GQA kv=8.
[arXiv:2405.04324; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    rope_theta=10_000_000.0,
    tie_embeddings=True,
    source="arXiv:2405.04324; hf",
)

SMOKE = CONFIG.replace(
    name="granite-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=160,
    vocab_size=512,
)
