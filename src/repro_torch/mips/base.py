"""Index protocol + complement augmentation (paper §3.4), counterpart of
`repro.mips.base`."""

from __future__ import annotations

from typing import Protocol, Tuple, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class MIPSIndex(Protocol):
    """k-MIPS index protocol.

    Attributes:
      approx_margin: the retrieval approximation constant ``c`` of
        Def. 3.4 (0 for exact indices) — the (ε+2c) accounting of Thm F.2
        or the margin lowering of Alg. 6.
      failure_mass: γ, the probability mass of the index answering wrongly
        over a whole run (adds to δ, Thm 3.3).
      device: where the index's tables live; probes must live there too.
      supports_batch_probe: ``query_batch`` serves a whole wave, as
        `run_mwem_batch` requires.
    """

    approx_margin: float
    failure_mass: float
    device: torch.device
    supports_batch_probe: bool

    def query(self, v: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(augmented ids, raw scores) of the (approximate) top-k, both on
        the device, with no host round-trip."""
        ...

    def query_batch(self, V: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The same for a (B, dim) wave of probes: (B, k) ids and scores,
        lane b equal to ``query(V[b], k)`` up to the order of exact ties."""
        ...

    def query_cost(self, k: int) -> int:
        """Analytic count of candidate score evaluations per query."""
        ...


def augment_complement(Q) -> np.ndarray:
    """Close a query set under complements: rows ``[Q; 1 − Q]`` (§3.4).

    For probes with ``Σv = 0``, ``⟨1−q, v⟩ = −⟨q, v⟩``, so top-k over the
    augmented set retrieves the top absolute scores. Augmented id ``j`` ↦
    query ``j % m``, sign ``+1 if j < m else −1``.
    """
    Q = np.asarray(Q, np.float32)
    return np.concatenate([Q, 1.0 - Q], axis=0)
