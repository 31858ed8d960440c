"""Model factory."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LM


def build_model(cfg: ModelConfig) -> LM:
    return LM(cfg)
