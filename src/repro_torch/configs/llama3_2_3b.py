"""llama3.2-3b [dense] — small llama3 [hf:meta-llama/Llama-3.2].

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256; SwiGLU; tied
embeddings (the 3.2 small models tie).
"""

from repro_torch.configs.base import ModelConfig, uniform_stages

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128_256,
    head_dim=128,
    stages=uniform_stages("attn", 28),
    mlp_type="swiglu",
    rope_theta=500_000.0,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab_size=256, head_dim=12, stages=uniform_stages("attn", 2),
    )
