"""Lazy Gumbel sampling — the paper's accelerated exponential mechanism
(Algorithms 4–6), counterpart of `repro.core.lazy_em`.

Same fixed-shape design as the reference: the binomial tail count ``C`` is
drawn exactly, the tail candidates live in a ``tail_cap``-sized buffer,
and ``C > tail_cap`` (or a buffer that ran out of distinct ids) raises the
``overflow`` flag — the driver then redoes the step with the exhaustive
mechanism on the fallback stream (`Draws.fallback_gumbel`, the
counterpart of `repro.core.lazy_em.fallback_key`). Every quantity stays a
device tensor; only the driver reads the overflow flag back.

Every function works along the last axis, so a wave of B lanes runs the
same code on (B, k) top-k sets with a `LaneDraws` source and gets (B,)
results: lane b's numbers are those of the single-lane call given lane b's
draws, as the reference's ``vmap`` gives.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.core.gumbel import tail_prob, truncated_gumbel
from repro_torch.core.rng import Draws


def default_tail_cap(n: int) -> int:
    """4√n-sized tail buffer, clamped to [64, n] (E[C] ≤ n/k ≈ √n)."""
    return min(n, max(64, 4 * math.ceil(math.sqrt(n))))


class LazyEMResult(NamedTuple):
    """One value a lane: 0-d for a single lane, (B,) for a wave."""

    index: torch.Tensor       # selected candidate id in [n] (int64)
    n_scored: torch.Tensor    # k + distinct tail candidates scored (int64)
    tail_count: torch.Tensor  # the raw binomial draw C (int64)
    margin: torch.Tensor      # the threshold B actually used (f32)
    overflow: torch.Tensor    # bool: the caller must redo exactly


def _complement_shift(sorted_s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Map complement-space ids ``u ∈ [0, n−k)`` to ``[n] \\ S``: with
    ``t_j = s_j − j`` (non-decreasing) the id is ``u + |{j : t_j ≤ u}|``."""
    t = sorted_s - torch.arange(sorted_s.shape[-1], device=sorted_s.device)
    return u + torch.searchsorted(t, u, right=True)


def draw_distinct_tail(draws: Draws, t: int, topk_idx: torch.Tensor, n: int,
                       tail_cap: int, C: torch.Tensor):
    """Draw ``C`` distinct uniform ids from ``[n] \\ S`` into a
    ``tail_cap`` buffer (Alg. 4 l.7, fixed-shape form).

    ``tail_cap`` i.i.d. complement-space draws are shifted around the
    sorted top-k set; duplicates are masked by a stable sort and the first
    ``C`` distinct ids are kept. Returns ``(tail_idx, active, overflow)``.
    """
    k = topk_idx.shape[-1]
    u = draws.tail_randint(t, tail_cap, max(n - k, 1), topk_idx.device)
    sorted_s = torch.sort(topk_idx.to(torch.int64), dim=-1).values
    tail_idx = _complement_shift(sorted_s, u)
    # first occurrence keeps the earliest slot
    su, order = torch.sort(u, dim=-1, stable=True)
    dup_sorted = torch.zeros_like(su, dtype=torch.bool)
    dup_sorted[..., 1:] = su[..., 1:] == su[..., :-1]
    first_occ = torch.empty_like(dup_sorted).scatter_(-1, order, ~dup_sorted)
    active = first_occ & (torch.cumsum(first_occ, -1) <= C.unsqueeze(-1))
    overflow = (C > tail_cap) | (active.sum(-1) < C)
    return tail_idx, active, overflow


def lazy_em_from_topk(draws: Draws, t: int, topk_idx: torch.Tensor,
                      topk_scores: torch.Tensor, n: int,
                      score_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                      tail_cap: int, margin_slack: float = 0.0) -> LazyEMResult:
    """Lazy Gumbel sampling given an (approximate) top-k set.

    Args:
      draws / t: the draw source and the iteration the draws belong to
        (a `LaneDraws` for a wave).
      topk_idx / topk_scores: (k,) candidate ids of S and their EM
        log-space scores ``ε·u/(2Δ)``; (B, k) for a wave.
      n: total number of candidates.
      score_fn: ``(ids, active) -> scores`` in EM log-space for the
        tail buffer, of the buffer's shape; slots where ``active`` is
        False may hold anything.
      margin_slack: the approximation constant c (Alg. 6 lowers B by c).
    """
    k = topk_idx.shape[-1]
    dev = topk_scores.device
    # Alg. 4 l.3-5: Gumbel-perturb S and set the margin B.
    pert_s = topk_scores + draws.topk_gumbel(t, k, dev)
    B = pert_s.amax(-1) - topk_scores.amin(-1) - margin_slack
    # l.6: how many tail Gumbels exceed B.
    C = draws.tail_count(t, n - k, tail_prob(B))
    # l.7: C distinct uniform ids from [n] \ S.
    tail_idx, active, overflow = draw_distinct_tail(draws, t, topk_idx, n,
                                                    tail_cap, C)
    # l.8: truncated Gumbels for the tail.
    g_t = truncated_gumbel(draws.tail_uniform(t, tail_cap, dev), B.unsqueeze(-1))
    pert_t = (score_fn(tail_idx, active) + g_t).masked_fill(~active, -math.inf)
    # l.9: argmax over S ∪ T (first maximum, as `jnp.argmax`).
    all_pert = torch.cat([pert_s, pert_t], -1)
    all_idx = torch.cat([topk_idx.to(torch.int64), tail_idx], -1)
    best = torch.argmax(all_pert, dim=-1, keepdim=True)
    winner = all_idx.gather(-1, best).squeeze(-1)
    return LazyEMResult(index=winner, n_scored=k + active.sum(-1),
                        tail_count=C, margin=B, overflow=overflow)


def lazy_em(draws: Draws, t: int, scores: torch.Tensor, k: int,
            tail_cap: int | None = None, margin_slack: float = 0.0) -> LazyEMResult:
    """Lazy EM over an explicit score vector (exact top-k, ties to the
    lower id) — the oracle for the index-backed paths."""
    n = scores.shape[0]
    if tail_cap is None:
        tail_cap = default_tail_cap(n)
    top_s, top_i = torch.sort(scores, descending=True, stable=True)
    return lazy_em_from_topk(draws, t, top_i[:k], top_s[:k], n,
                             score_fn=lambda idx, active: scores[idx],
                             tail_cap=tail_cap, margin_slack=margin_slack)
