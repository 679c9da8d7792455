"""Paper-scale tiny config (~100M) for the runnable end-to-end examples:
train a few hundred steps on CPU / 1 chip."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="relic-tiny-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab_size=32000,
    remat="none",
    source="this repo",
)

SMOKE = CONFIG.replace(
    name="relic-tiny-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=512,
)
