"""llama4-maverick-400b-a17b [moe]: 128 experts top-1 + shared expert
("early fusion" multimodality not in the LM-backbone scope).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=128, top_k=1, d_ff=8192, shared_expert=True),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)

SMOKE = CONFIG.replace(
    name="llama4-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=1, d_ff=128, shared_expert=True),
)
