"""rwkv6-1.6b [ssm] "Finch": attention-free, data-dependent decay.
O(1)-state decode => runs the long_500k cell. [arXiv:2404.05892; unverified]"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,             # wkv heads = d_model / head_dim
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    use_rope=False,
    ssm=SSMConfig(kind="rwkv6", head_dim=64, chunk=64),
    source="arXiv:2404.05892; unverified",
)

SMOKE = CONFIG.replace(
    name="rwkv6-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=512,
    ssm=SSMConfig(kind="rwkv6", head_dim=16, chunk=8),
)
