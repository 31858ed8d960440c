"""Dense MLP variants (counterpart of `repro.models.mlp`). The top-k MoE
comes with a later slice of the port and raises here."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Params


def init_mlp(cfg: ModelConfig, dtype: torch.dtype) -> Params:
    if cfg.mlp_type == "moe":
        raise NotImplementedError("the MoE MLP comes with a later slice of the port")
    D, F_ = cfg.d_model, cfg.d_ff
    p = Params()
    if cfg.mlp_type in ("swiglu", "geglu"):
        p.add("w_gate", (D, F_), dtype)
    p.add("w_up", (D, F_), dtype)
    p.add("w_down", (F_, D), dtype)
    return p


def _act(h, kind: str):
    if kind == "swiglu":
        return F.silu(h)
    if kind in ("geglu", "gelu"):
        return F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    if kind == "squared_relu":
        r = F.relu(h)
        return r * r
    raise ValueError(kind)


def _dense_mlp(p, x, kind: str):
    if kind in ("swiglu", "geglu"):
        h = _act(x @ p["w_gate"], kind) * (x @ p["w_up"])
    else:
        h = _act(x @ p["w_up"], kind)
    return h @ p["w_down"]


def mlp_forward(p, x, cfg: ModelConfig):
    if cfg.mlp_type == "moe":
        raise NotImplementedError("the MoE MLP comes with a later slice of the port")
    return _dense_mlp(p, x, cfg.mlp_type)
