"""whisper-large-v3 [audio]: enc-dec, conv frontend stubbed to precomputed
frame embeddings. [arXiv:2212.04356; unverified]"""

from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,            # decoder layers
    enc_layers=32,          # encoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    use_rope=False,         # sinusoidal (enc) + learned (dec) absolute positions
    tie_embeddings=True,
    frontend=FrontendConfig(kind="audio_frames", n_tokens=1500, embed_dim=1280),
    max_seq=32768,
    source="arXiv:2212.04356; unverified",
)

SMOKE = CONFIG.replace(
    name="whisper-smoke",
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, max_seq=128,
    frontend=FrontendConfig(kind="audio_frames", n_tokens=24, embed_dim=64),
)
