"""llama3-405b [dense]: GQA kv=8, 128k vocab — the TP-heavy flagship.
[arXiv:2407.21783; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500_000.0,
    source="arXiv:2407.21783; unverified",
)

SMOKE = CONFIG.replace(
    name="llama3-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=192,
    vocab_size=512,
)
