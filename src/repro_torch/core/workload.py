"""Dense linear-query workloads, counterpart of `repro.core.workload`.

This slice ports `DenseWorkload` only; factored marginal workloads come
with their own slice. Complement augmentation is a sign convention, not a
row copy: augmented id ``j`` means query ``j % m`` with sign ``+1`` if
``j < m`` else ``−1`` (decoded in the `gather_score` kernel).
"""

from __future__ import annotations

import torch


class DenseWorkload:
    """An explicit ``(m, U)`` float32 query matrix on one device."""

    is_dense = True

    def __init__(self, Q: torch.Tensor):
        if Q.dim() != 2:
            raise ValueError(f"Q must be (m, U), got shape {tuple(Q.shape)}")
        self.Q = Q.to(torch.float32).contiguous()

    @property
    def m(self) -> int:
        return int(self.Q.shape[0])

    @property
    def U(self) -> int:
        return int(self.Q.shape[1])

    @property
    def device(self) -> torch.device:
        return self.Q.device

    def scores(self, v: torch.Tensor) -> torch.Tensor:
        """All m signed scores ``Q v`` (the exhaustive oracle); a (B, U)
        block of probes gives (B, m), one ``(B, U) @ (U, m)`` product."""
        if v.dim() == 2:
            return v @ self.Q.T
        return self.Q @ v

    def max_err(self, h: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """‖Q(p − h)‖_∞ (Eq. 1); (B, U) densities (and a shared (U,) or
        per-lane (B, U) ``h``) give one error a lane."""
        if p.dim() == 2:
            return torch.amax(torch.abs((p - h) @ self.Q.T), dim=-1)
        return torch.max(torch.abs(self.Q @ (p - h)))

    def __repr__(self):
        return f"DenseWorkload(m={self.m}, U={self.U})"


def as_workload(Q, device=None) -> DenseWorkload:
    """Coerce a dense array or tensor to a `DenseWorkload` on ``device``;
    pass workloads through."""
    if isinstance(Q, DenseWorkload):
        return Q
    return DenseWorkload(torch.as_tensor(Q, dtype=torch.float32, device=device))
