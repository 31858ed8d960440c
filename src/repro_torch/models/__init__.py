"""The port's LM tier: the dense attention and Mamba-2 blocks."""

from repro_torch.models.lm import LM
from repro_torch.models.registry import build_model

__all__ = ["LM", "build_model"]
