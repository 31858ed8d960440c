"""LM assembly: a stack of blocks → prefill / decode (counterpart of
`repro.models.lm.LM`, serving path).

The reference scans over stacked layer units; here `LM` is an
`nn.Module` whose ``blocks`` `nn.ModuleList` holds one `Block` a layer in
the reference's order (stage by stage, unit by unit, the pattern's blocks
in turn), and the layer loop is a Python loop. The decode cache is a list
with one dict a layer — ``{"k", "v"}`` (B, Hkv, max_len, Dh) for
attention, ``{"conv", "state"}`` for an SSM block — with the batch on
axis 0 of every tensor.

Block kinds ``attn`` and ``ssm`` are ported; ``rglru``, the local and
cross-attention kinds, encoder-decoder stacks and ``input_embeds`` come
with later slices and raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as att
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import Params, apply_norm, init_norm

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Block(nn.Module):
    """One layer: pre-norm mixer (attention or SSM) and, for attention,
    a pre-norm MLP, each added to the residual stream."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype: torch.dtype):
        super().__init__()
        self.kind = kind
        self.norm_1 = init_norm(cfg.d_model, cfg.norm_type)
        if kind == "attn":
            self.attn = att.init_attention(cfg, dtype)
            self.norm_2 = init_norm(cfg.d_model, cfg.norm_type)
            self.mlp = mlp_mod.init_mlp(cfg, dtype)
        elif kind == "ssm":
            self.ssm = ssm_mod.init_ssm(cfg, dtype)
        else:
            raise NotImplementedError(
                f"block kind {kind!r} comes with a later slice of the port "
                "(ported: attn, ssm)")


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if not cfg.stages:
            raise ValueError("ModelConfig.stages must be set")
        if cfg.is_encdec or cfg.input_embeds:
            raise NotImplementedError("encoder-decoder and embedding-input "
                                      "models come with a later slice of the port")
        self.cfg = cfg
        self.dtype = DTYPES[cfg.dtype]
        self.kinds = [kind for pattern, n_units in cfg.stages
                      for _ in range(n_units) for kind in pattern]
        self.io = Params()
        # d^-1/2 init keeps tied-head logits O(1) at depth
        self.io.add("embedding", (cfg.padded_vocab, cfg.d_model), self.dtype,
                    scale=cfg.d_model ** -0.5)
        if not cfg.tie_embeddings:
            self.io.add("lm_head", (cfg.d_model, cfg.padded_vocab), self.dtype)
        self.blocks = nn.ModuleList(Block(cfg, kind, self.dtype)
                                    for kind in self.kinds)
        self.final_norm = init_norm(cfg.d_model, cfg.norm_type)

    # ------------------------------------------------------------- init ----
    def init(self, seed: int = 0, device=None) -> "LM":
        """Random weights at the reference's scales, drawn from one
        `torch.Generator` seeded with ``seed`` on ``device``."""
        dev = resolve_device(device)
        self.to_empty(device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, Params):
                mod.fill_(gen)
        return self

    def load(self, state: dict, device=None) -> "LM":
        """Weights from a state dict (`repro_torch.convert.lm_params`)."""
        self.to_empty(device=resolve_device(device))
        self.load_state_dict(state)
        return self

    @property
    def device(self) -> torch.device:
        return self.io["embedding"].device

    # ---------------------------------------------------------- forward ----
    def _embed(self, tokens: torch.Tensor):
        h = self.io["embedding"][tokens]
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        return h, positions

    def _block_fwd(self, blk: Block, h, positions, cache_len: int = 0):
        """One block forward → (h, cache | None); the cache when
        ``cache_len > 0`` (prefill)."""
        cfg = self.cfg
        cache = None
        hn = apply_norm(h, blk.norm_1, cfg.norm_type, cfg.norm_eps)
        if blk.kind == "attn":
            if cache_len > 0:
                y, (k, v) = att.attn_forward(blk.attn, hn, cfg, blk.kind,
                                             positions, return_kv=True)
                cache = self._kv_to_cache(k, v, cache_len)
            else:
                y = att.attn_forward(blk.attn, hn, cfg, blk.kind, positions)
            h = h + y
            hn2 = apply_norm(h, blk.norm_2, cfg.norm_type, cfg.norm_eps)
            h = h + mlp_mod.mlp_forward(blk.mlp, hn2, cfg)
        else:
            if cache_len > 0:
                y, cache = ssm_mod.ssm_prefill(blk.ssm, hn, cfg)
            else:
                y = ssm_mod.ssm_forward(blk.ssm, hn, cfg)
            h = h + y
        return h, cache

    @staticmethod
    def _kv_to_cache(k, v, cache_len: int) -> dict:
        """Prefill (B, Hkv, S, Dh) K/V → full-length decode buffers."""
        pad = cache_len - k.shape[2]
        return {"k": torch.nn.functional.pad(k, (0, 0, 0, pad)),
                "v": torch.nn.functional.pad(v, (0, 0, 0, pad))}

    def _logits(self, h):
        cfg = self.cfg
        head = self.io["embedding"].T if cfg.tie_embeddings else self.io["lm_head"]
        logits = (h @ head.to(h.dtype)).to(torch.float32)
        if cfg.padded_vocab != cfg.vocab_size:
            pad = torch.arange(cfg.padded_vocab, device=h.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e9)
        return logits

    # ------------------------------------------------------------ decode ---
    def init_cache(self, batch: int, max_len: int) -> list:
        cfg, dev = self.cfg, self.device
        return [att.init_attn_cache(cfg, kind, batch, max_len, self.dtype, dev)
                if kind == "attn" else ssm_mod.init_ssm_cache(cfg, batch, dev)
                for kind in self.kinds]

    def _block_decode(self, blk: Block, c: dict, h, pos: int):
        cfg = self.cfg
        hn = apply_norm(h, blk.norm_1, cfg.norm_type, cfg.norm_eps)
        if blk.kind == "attn":
            y, c = att.attn_decode(blk.attn, hn, c, pos, cfg, blk.kind)
            h = h + y
            hn2 = apply_norm(h, blk.norm_2, cfg.norm_type, cfg.norm_eps)
            h = h + mlp_mod.mlp_forward(blk.mlp, hn2, cfg)
        else:
            y, c = ssm_mod.ssm_decode(blk.ssm, hn, c, cfg)
            h = h + y
        return h, c

    @torch.no_grad()
    def decode_step(self, cache: list, tokens: torch.Tensor, pos: int):
        """One serving step. tokens: (B, 1) int; pos: the global position
        being written. Returns (logits (B, V) f32, cache); attention caches
        are written in place."""
        h = self.io["embedding"][tokens]
        new_cache = []
        for blk, c in zip(self.blocks, cache):
            h, c = self._block_decode(blk, c, h, pos)
            new_cache.append(c)
        h = apply_norm(h, self.final_norm, self.cfg.norm_type, self.cfg.norm_eps)
        return self._logits(h)[:, 0], new_cache

    # ----------------------------------------------------------- prefill ---
    @torch.no_grad()
    def prefill(self, batch: dict, max_len: Optional[int] = None):
        """Forward over ``batch["tokens"]`` (B, S) and cache extraction.
        Returns (last-position logits (B, V) f32, cache)."""
        h, positions = self._embed(batch["tokens"])
        max_len = max_len or h.shape[1]
        cache = []
        for blk in self.blocks:
            h, c = self._block_fwd(blk, h, positions, cache_len=max_len)
            cache.append(c)
        h = apply_norm(h, self.final_norm, self.cfg.norm_type, self.cfg.norm_eps)
        return self._logits(h[:, -1]), cache
