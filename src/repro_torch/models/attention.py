"""GQA attention: prefill forward and cached single-token decode
(counterpart of `repro.models.attention` for the kind ``"attn"``).

Both go through one kernel, `flash_attention` (K8): the prefill with the
causal mask over the prompt, the decode with ``Sq = 1`` at ``q_offset =
pos`` over the full-length cache — the reference's decode mask
``slot ≤ pos`` on a full buffer is exactly that causal mask. The other
kinds (sliding-window and chunked ring buffers, cross-attention, mrope)
are a later slice of the port and raise here; the kernel itself takes
all four masks.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import Params, apply_rope

_MASK_OF_KIND = {"attn": "causal"}
LATER = ("window_attn, chunk_attn, attn_bidir and xattn_dec (ring-buffer, "
         "encoder and cross-attention) and mrope come with a later slice of "
         "the port")


def _check_kind(cfg: ModelConfig, kind: str) -> str:
    if kind not in _MASK_OF_KIND:
        raise NotImplementedError(f"attention kind {kind!r}: {LATER}")
    if cfg.rope_mode != "rope" or cfg.nope_on_global:
        raise NotImplementedError(f"rope_mode {cfg.rope_mode!r}: {LATER}")
    return _MASK_OF_KIND[kind]


def init_attention(cfg: ModelConfig, dtype: torch.dtype,
                   kv_dim: Optional[int] = None) -> Params:
    D, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    Dh = cfg.resolved_head_dim
    kv_dim = kv_dim or D
    p = Params()
    p.add("wq", (D, H, Dh), dtype)
    p.add("wk", (kv_dim, Hkv, Dh), dtype)
    p.add("wv", (kv_dim, Hkv, Dh), dtype)
    p.add("wo", (H, Dh, D), dtype)
    return p


def _project(x, w):
    """(B, S, D) · (D, H, Dh) → (B, H, S, Dh), contiguous."""
    return torch.einsum("bsd,dhk->bhsk", x, w).contiguous()


def attn_forward(p, x, cfg: ModelConfig, kind: str, positions,
                 xkv=None, return_kv: bool = False):
    """x: (B, S, D) → (B, S, D); positions: (B, S) int.

    ``return_kv=True`` also returns the post-RoPE (k, v), the prefill's
    cache feed.
    """
    mode = _check_kind(cfg, kind)
    if xkv is not None:
        raise NotImplementedError(f"cross-attention: {LATER}")
    q = apply_rope(_project(x, p["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(x, p["wk"]), positions, cfg.rope_theta)
    v = _project(x, p["wv"])
    out = flash_attention(q, k, v, mode=mode, window=cfg.window,
                          logit_softcap=cfg.logit_softcap)
    y = torch.einsum("bhsk,hkd->bsd", out, p["wo"])
    if return_kv:
        return y, (k, v)
    return y


# ------------------------------------------------------------- decoding ----
def init_attn_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                    dtype: torch.dtype, device) -> dict:
    """Full-length (batch, Hkv, max_len, Dh) K and V buffers."""
    _check_kind(cfg, kind)
    shape = (batch, cfg.n_kv_heads, max_len, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p, x, cache: dict, pos: int, cfg: ModelConfig, kind: str):
    """One-token decode. x: (B, 1, D); pos: the global position written.

    Writes the token's K/V into ``cache`` in place at ``pos`` and returns
    ``(y (B, 1, D), cache)``.
    """
    _check_kind(cfg, kind)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q = apply_rope(_project(x, p["wq"]), positions, cfg.rope_theta)
    k_new = apply_rope(_project(x, p["wk"]), positions, cfg.rope_theta)
    v_new = _project(x, p["wv"])
    cache["k"][:, :, pos] = k_new[:, :, 0].to(cache["k"].dtype)
    cache["v"][:, :, pos] = v_new[:, :, 0].to(cache["v"].dtype)
    out = flash_attention(q, cache["k"], cache["v"], mode="causal",
                          q_offset=pos, logit_softcap=cfg.logit_softcap)
    y = torch.einsum("bhsk,hkd->bsd", out, p["wo"])
    return y, cache
