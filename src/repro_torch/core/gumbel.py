"""Gumbel machinery (paper §C, Lemma C.2/C.3), counterpart of
`repro.core.gumbel`.

The random numbers come from the caller (see `repro_torch.core.rng`):
these functions are the deterministic transforms applied to them, in
float32 and without catastrophic cancellation.
"""

from __future__ import annotations

import torch


def tail_prob(B: torch.Tensor) -> torch.Tensor:
    """P[Gumbel(0,1) > B] = 1 − exp(−exp(−B)), computed stably."""
    return -torch.expm1(-torch.exp(-B))


def truncated_gumbel(u: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``G ~ Gumbel(0,1)`` conditioned on ``G > B`` from uniforms ``u``.

    With ``q = P[G > B]``: ``W = −log1p(−q·(1 − u))``, ``G = −log(W)`` —
    stable for large ``B`` where ``−log(−log(U))`` is not (Lemma C.3).
    """
    q = tail_prob(B.to(torch.float32))
    w = -torch.log1p(-q * (1.0 - u))
    return -torch.log(w)


def gumbel_max(gumbels: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Gumbel-Max trick (Lemma C.2): argmax(scores + G) ~ softmax(scores).

    Ties go to the lowest index, as in `jnp.argmax`. Works along the last
    axis: (B, n) scores give one winner a lane."""
    return torch.argmax(scores + gumbels, dim=-1)
