"""Dense distributions and Bregman projections (paper §A), counterpart of
`repro.core.bregman`.

``Γ_s A`` projects a measure ``A`` onto the set of 1/s-dense distributions
(Def. A.2): ``(Γ_s A)_a = (1/s)·min(1, c·A_a)`` with ``c`` solving
``Σ_a min(1, c·A_a) = s``. The solution is found exactly: sorting ``A``
descending, the constraint is piecewise linear in ``c`` with breakpoints
``1/A_(i)``; the first valid piece is solved in closed form. It is a sort,
a suffix sum and an argmax — plain PyTorch, no kernel of its own.
"""

from __future__ import annotations

import torch


def _solve_c(a: torch.Tensor, s: float) -> torch.Tensor:
    """0-d ``c ≥ 0`` with ``Σ min(1, c·a_i) = s``."""
    n = a.shape[0]
    desc = torch.sort(a, descending=True, stable=True).values
    # With c in the piece where exactly the j largest entries are clipped
    # to 1: j + c · suffix_sum(j) = s  →  c = (s − j) / suffix_sum(j),
    # valid iff c·desc[j] ≤ 1 and c·desc[j−1] ≥ 1.
    zero = desc.new_zeros(1)
    suffix = torch.cat([torch.cumsum(desc.flip(0), 0).flip(0), zero])
    j = torch.arange(n + 1, dtype=a.dtype, device=a.device)
    c_cand = (s - j) / torch.clamp_min(suffix, 1e-38)
    thresh_hi = torch.cat([desc.new_full((1,), float("inf")), desc])
    thresh_lo = torch.cat([desc, zero])
    valid = ((c_cand * thresh_lo <= 1.0 + 1e-6)
             & (c_cand * thresh_hi >= 1.0 - 1e-6) & (c_cand >= 0))
    # The first valid piece is the solution; else the last piece.
    idx = torch.argmax(valid.to(torch.uint8))
    return torch.where(valid.any(), c_cand[idx], c_cand[-1])


def bregman_project_dense(a: torch.Tensor, s: float) -> torch.Tensor:
    """KL (Bregman) projection of the measure ``a`` (m,) onto the 1/s-dense
    simplex: ``y`` with ``‖y‖_∞ ≤ 1/s`` and ``Σy = 1`` minimizing
    ``KL(y ‖ a/Σa)`` (Def. A.2). For ``s ≤ 1`` this is normalization."""
    a = torch.clamp_min(a, 1e-38)
    if s <= 1.0:
        return a / torch.sum(a)
    c = _solve_c(a, float(s))
    y = torch.clamp_max(c * a, 1.0) / float(s)
    return y / torch.sum(y)  # guard tiny numeric drift
