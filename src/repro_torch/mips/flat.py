"""Flat (exact, linear-scan) MIPS indices — the Θ(m) baseline,
counterparts of `repro.mips.flat.FlatIndex` and `FlatAbsIndex`.

`FlatIndex` is the signed top-k over arbitrary rows that the LP solvers
probe (rows ``[A_i, b_i]`` for the scalar solver, ``N_j`` for the dual):
one streaming pass of the `mips_topk` kernel (K1) in ``plain`` mode.

`FlatAbsIndex`'s probe is one streaming pass of the `mips_topk` kernel
(K1) in ``aug`` mode: each row gives +⟨q_j, v⟩ as id j and −⟨q_j, v⟩ as
id j+m, so the top-k over the complement-augmented set comes out without
materializing ``[Q; 1 − Q]`` or the (m,) score vector. For k ≤ m each row contributes at
most its non-negative sign to the top, so this equals the reference's
top-k of |Q v| (up to the order of exact ties, which K1 documents).

Over a factored `MarginalWorkload` there are no explicit rows for K1 to
stream: the probe takes the workload's full score vector
(`MarginalWorkload.probe_scores`, segment sums past ``score_block``
queries) and a stable descending sort of |s|, as the reference's
`_flat_abs_workload_scores` does. Such an index has no ``query_batch``
(``supports_batch_probe`` is False, as in the reference); a factored wave
probes through `query_batch_with_scores` instead (``has_full_scores``):
the (B, m) scores of a (B, U) block, a stable sort a lane, and the scores
themselves, which the wave's tail and overflow redo look up.

A wave of B probes (`query_batch`) is the reference's
`_flat_abs_query_batch`: one (B × U) @ (U × m) product reads Q once for
all lanes — K1 once a lane would read it B times — then a stable
descending sort of |s| a lane (lower id first among ties).
"""

from __future__ import annotations

import torch

from repro_torch.core.workload import as_workload
from repro_torch.device import resolve_device
from repro_torch.kernels.mips_topk import mips_topk


def _abs_top_k(s: torch.Tensor, k: int):
    """Top-k of |s| along the last axis by a stable descending sort (the
    lower id first among ties) → ``(aug ids int32, |scores|)``: id j for
    +s_j, j + m for −s_j."""
    top_a, top_i = torch.sort(s.abs(), dim=-1, descending=True, stable=True)
    top_a, top_i = top_a[..., :k], top_i[..., :k]
    aug = torch.where(s.gather(-1, top_i) >= 0, top_i, top_i + s.shape[-1])
    return aug.to(torch.int32), top_a


class FlatIndex:
    """Exact signed top-k of ⟨V_j, v⟩ over the rows of ``vectors`` (n, dim):
    ``query`` returns row ids in [0, n) (int32) and their scores, ties to
    the lower id as `jax.lax.top_k`."""

    approx_margin = 0.0
    failure_mass = 0.0

    def __init__(self, vectors, device=None):
        self.device = resolve_device(device)
        self._v = torch.as_tensor(vectors, dtype=torch.float32).to(
            self.device).contiguous()
        self.n, self.dim = self._v.shape

    def query(self, v: torch.Tensor, k: int):
        return mips_topk(self._v, v, k, mode="plain")

    def query_cost(self, k: int) -> int:
        return self.n


class FlatAbsIndex:
    """Exact top-k of |⟨q_i, v⟩| as augmented ids (j < m ⇒ +⟨q_j, v⟩;
    j ≥ m ⇒ −⟨q_{j−m}, v⟩)."""

    approx_margin = 0.0
    failure_mass = 0.0

    def __init__(self, Q, device=None):
        """``Q``: a dense (m, U) array, tensor or `DenseWorkload`, placed
        on ``device`` (default ``cuda``) and sharing storage with a tensor
        already there; or a `MarginalWorkload`, which must live on
        ``device``."""
        dev = resolve_device(device)
        W = as_workload(Q, dev)
        if not W.is_dense and W.device != dev:
            raise ValueError(f"workload is on {W.device}, the index on {dev}")
        self._w = W
        self._q = W.Q if W.is_dense else None
        self.device = W.device
        self.m, self.dim = W.m, W.U
        self.n = 2 * self.m

    @property
    def supports_batch_probe(self) -> bool:
        return self._w.is_dense

    @property
    def has_full_scores(self) -> bool:
        """A factored workload's probe computes all m signed scores anyway:
        `query_batch_with_scores` hands them to the wave."""
        return not self._w.is_dense

    @property
    def workload(self):
        return self._w

    def query(self, v: torch.Tensor, k: int):
        if self._q is not None:
            return mips_topk(self._q, v, k, mode="aug")
        return _abs_top_k(self._w.probe_scores(v), k)

    def query_batch(self, V: torch.Tensor, k: int):
        """Top-k a lane of a (B, U) probe block → ``(aug ids int32 (B, k),
        |scores| (B, k))``; dense workloads only."""
        if self._q is None:
            raise ValueError("a factored workload's flat index probes one "
                             "lane at a time with query; a wave probes "
                             "through query_batch_with_scores")
        return _abs_top_k(V @ self._q.T, k)                 # (B, m) scores

    def query_batch_with_scores(self, V: torch.Tensor, k: int):
        """Top-k a lane of a (B, U) probe block over a factored workload →
        ``(aug ids int32 (B, k), |scores| (B, k), signed scores (B, m))``:
        `MarginalWorkload.probe_scores` of the block, then a stable
        descending sort of |s| a lane (the reference's
        `query_in_graph_with_scores`, vmapped)."""
        if self._q is not None:
            raise ValueError("a dense workload's flat index probes a wave "
                             "with query_batch")
        s = self._w.probe_scores(V)                          # (B, m)
        return (*_abs_top_k(s, k), s)

    def query_cost(self, k: int) -> int:
        return self.m
