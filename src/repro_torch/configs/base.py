"""Model configuration, counterpart of `repro.configs.base.ModelConfig`.

The same frozen dataclass with the same fields and defaults, so a
configuration of the reference reads the same here. The sharding rules
(`ShardingRules` and the ``*_RULES`` sets) and the shape and training
configurations are left out: they come with the sharded and training
slices of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # block layout: list of (pattern, n_units); pattern entries are block
    # kinds: "attn" | "window_attn" | "chunk_attn" | "ssm" | "rglru"
    stages: Tuple[Tuple[Tuple[str, ...], int], ...] = ()

    # attention
    window: int = 0                 # window/chunk size for local attention
    rope_theta: float = 10_000.0
    rope_mode: str = "rope"         # rope | mrope | none
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    nope_on_global: bool = False    # llama4 iRoPE: no RoPE on global-attn layers
    logit_softcap: float = 0.0

    # mlp
    mlp_type: str = "swiglu"        # swiglu | geglu | squared_relu | gelu | moe
    n_experts: int = 0
    moe_top_k: int = 0
    moe_shared_expert: bool = False
    moe_capacity_factor: float = 1.25

    # ssm (mamba-2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 64

    # hybrid (RG-LRU)
    rglru_width: int = 0
    rglru_conv: int = 4

    # enc-dec (whisper)
    is_encdec: bool = False
    encoder_layers: int = 0
    enc_len: int = 1500

    # io
    input_embeds: bool = False      # vlm: inputs are precomputed embeddings
    tie_embeddings: bool = True
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # embedding-table padding so the vocab axis divides a tensor-parallel
    # degree; pad logits are masked to −1e9 so argmax is unchanged.
    vocab_pad_multiple: int = 1

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


def uniform_stages(kind: str, n_layers: int) -> tuple:
    return (((kind,), n_layers),)
