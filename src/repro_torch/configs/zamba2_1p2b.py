"""zamba2-1.2b [hybrid]: Mamba-2 backbone + shared attention block applied
every 6 SSM layers (one shared param set). [arXiv:2411.15242; hf]"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,            # mamba2 layers
    d_model=2048,
    n_heads=32,             # shared attention block heads
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    attn_every=6,
    ssm=SSMConfig(kind="mamba2", state_dim=64, head_dim=64, conv_kernel=4,
                  expand=2, chunk=128),
    source="arXiv:2411.15242; hf",
)

SMOKE = CONFIG.replace(
    name="zamba2-smoke",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=512, attn_every=2,
    ssm=SSMConfig(kind="mamba2", state_dim=16, head_dim=16, conv_kernel=4,
                  expand=2, chunk=8),
)
