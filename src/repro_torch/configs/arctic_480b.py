"""arctic-480b [moe]: 128 experts top-2 with a parallel dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff=4864, dense_residual=True),
    source="hf:Snowflake/snowflake-arctic-base; hf",
)

SMOKE = CONFIG.replace(
    name="arctic-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
    vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=96, dense_residual=True),
)
