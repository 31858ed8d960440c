"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

24L d_model=768, attn-free (d_ff=0), vocab=50280, ssm_state=128.
d_inner = 2·768 = 1536, headdim 64 → 24 SSD heads, 1 B/C group.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=12,            # unused (attention-free)
    n_kv_heads=12,
    d_ff=0,
    vocab_size=50_280,
    stages=((("ssm",), 24),),
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=64,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, vocab_size=256,
        stages=((("ssm",), 2),),
        ssm_state=16, ssm_headdim=16, ssm_chunk=8,
    )
