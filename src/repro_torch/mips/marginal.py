"""Clique-structured k-MIPS index for factored marginal workloads,
counterpart of `repro.mips.marginal`.

`MarginalIVFIndex` is the IVF idea with the workload's own cliques as the
inverted cells: a probe computes the per-clique marginal tables of ``v``
(`MarginalWorkload.marginal_tables`, segment sums) and ranks cliques by
their exact best |cell| (`marginal_probe_topk_ref`). No (m, U) table, row
gather or k-means build exists anywhere on this path.

Exactness: the global top-k by |score| lies inside the top cliques by max
|cell|, so with ``nprobe`` cliques covering at least k cells the probe's
top-k is the exhaustive one (``approx_margin = failure_mass = 0``).

A wave probes through `query_batch_with_scores` (``has_full_scores``, as
in the reference; ``supports_batch_probe`` stays False): the tables of a
(B, U) block in one pass of segment sums, the probe a lane, and every
query's signed score read off the same tables for the wave's tail and
overflow redo.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.workload import MarginalWorkload
from repro_torch.device import resolve_device
from repro_torch.kernels.ivf_probe.ref import marginal_probe_topk_ref


class MarginalIVFIndex:
    """k-MIPS over a `MarginalWorkload` with cliques as inverted cells."""

    approx_margin = 0.0
    failure_mass = 0.0
    supports_batch_probe = False
    has_full_scores = True

    def __init__(self, workload: MarginalWorkload, nprobe: int | None = None,
                 device=None):
        """``workload`` must live on ``device`` (default ``cuda``);
        ``nprobe`` defaults to max(4, ⌈√n_cliques⌉)."""
        if not isinstance(workload, MarginalWorkload):
            raise TypeError(
                f"MarginalIVFIndex indexes MarginalWorkload, got "
                f"{type(workload).__name__}; dense workloads use the "
                "geometric families (flat/ivf)")
        dev = resolve_device(device)
        if workload.device != dev:
            raise ValueError(f"workload is on {workload.device}, the index "
                             f"on {dev}")
        self._w = workload
        self.m = workload.m
        self.dim = workload.U
        self.n = 2 * workload.m
        self.n_cliques = workload.n_cliques
        cells = workload.cl_cells.cpu().numpy()
        self._starts = torch.as_tensor(np.concatenate(
            [[0], np.cumsum(cells)[:-1]]).astype(np.int32)).to(dev)
        self._min_cells = int(cells.min())
        self.nprobe = min(self.n_cliques,
                          nprobe or max(4, math.ceil(math.sqrt(self.n_cliques))))

    @property
    def workload(self) -> MarginalWorkload:
        return self._w

    @property
    def device(self) -> torch.device:
        return self._w.device

    def _nprobe_for(self, k: int) -> int:
        """Probed cliques for a top-k call: at least enough valid cells to
        cover k candidates (what makes the probe's top-k exact)."""
        need = math.ceil(k / max(self._min_cells, 1))
        return min(self.n_cliques, max(self.nprobe, need))

    def query(self, v: torch.Tensor, k: int):
        """``(aug ids int32 (k,), |scores| (k,))`` of the top-k cells."""
        tabs = self._w.marginal_tables(v)
        aug, top_a, _ = marginal_probe_topk_ref(
            tabs, self._w.cl_cells, self._starts, self.m, k, self._nprobe_for(k))
        return aug, top_a

    def query_batch_with_scores(self, V: torch.Tensor, k: int):
        """Top-k a lane of a (B, U) probe block → ``(aug ids int32 (B, k),
        |scores| (B, k), signed scores (B, m))``: the block's tables, then
        `marginal_probe_topk_ref` a lane, the scores taken from the same
        tables (the reference's `query_in_graph_with_scores`, vmapped)."""
        tabs = self._w.marginal_tables(V)                    # (B, nc, mc)
        nprobe = self._nprobe_for(k)
        aug, top_a = zip(*(marginal_probe_topk_ref(
            t, self._w.cl_cells, self._starts, self.m, k, nprobe)[:2]
            for t in tabs))
        s = self._w.table_answers(tabs)
        return torch.stack(aug), torch.stack(top_a), s

    def query_cost(self, k: int) -> int:
        """Candidate evaluations per query: the clique-statistic pass plus
        the probed cells."""
        return self.n_cliques + self._nprobe_for(k) * self._w.max_cells
