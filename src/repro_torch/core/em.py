"""The exponential mechanism (paper Def. 2.2 / Thm 2.3), counterpart of
`repro.core.em`: ``i ∝ exp(ε·u_i / (2Δ))`` through the Gumbel-Max trick."""

from __future__ import annotations

import torch

from repro_torch.core.gumbel import gumbel_max


def em_scores(utilities: torch.Tensor, eps: float, sensitivity: float) -> torch.Tensor:
    """Scale raw utilities into EM log-space scores ``ε·u/(2Δ)``."""
    return utilities * (eps / (2.0 * sensitivity))


def exact_em(gumbels: torch.Tensor, utilities: torch.Tensor, eps: float,
             sensitivity: float) -> torch.Tensor:
    """ε-DP exponential mechanism given one Gumbel per candidate.

    Θ(|R|) time — the baseline the paper's LazyEM beats. (B, n) utilities
    and Gumbels select one candidate a lane (the wave's exhaustive oracle).
    """
    return gumbel_max(gumbels, em_scores(utilities, eps, sensitivity))

