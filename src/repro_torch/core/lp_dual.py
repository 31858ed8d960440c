"""Constraint-private LPs via dense MWU on the dual (paper §4.2, Thm 4.4),
counterpart of `repro.core.lp_dual`.

Packing/covering LPs ``max c^T x s.t. Ax ≤ b`` where neighboring databases
differ by one *constraint row*. The dual player keeps a 1/s-dense
distribution ``y`` over the m constraints (Bregman-projected after each
MWU step, Lemma A.3 bounds the sensitivity); the primal oracle picks the
vertex ``v_j = (OPT/c_j)·e_j`` of ``K_OPT`` minimizing expected violation,
i.e. maximizes ``⟨y, N_j⟩`` over the preprocessed vectors

    N_j = −(OPT/c_j) · A[:, j]  ∈ R^m,  j ∈ [d]

(`repro_torch.mips.lp_dual_rows`). LazyEM over a k-MIPS index on {N_j}
scores O(√d) vertices an iteration instead of d.

`solve_constraint_private_lp` is one Python loop over T with all state on
the device. Each iteration selects a vertex — the exhaustive Gumbel-max
over ``N y`` (``mode="exact"``), or the index's top-k for the probe ``y``
plus a lazily drawn tail scored by `gather_score` (K3) over the N rows
(``mode="fast"``), redone exhaustively on the fallback stream when the
tail buffer overflows — then forms the loss ``(b − A·v_j)/ρ``, runs the
dual player's step ``logY − η·loss`` with its max shift as one
`mwu_update` (K7) launch, and Bregman-projects ``exp(logY − max)``. The
one host synchronisation an iteration is the read of the overflow flag in
fast mode.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from repro_torch.core.accountant import PrivacyLedger
from repro_torch.core.bregman import bregman_project_dense
from repro_torch.core.gumbel import gumbel_max
from repro_torch.core.lazy_em import default_tail_cap, lazy_em_from_topk
from repro_torch.core.lp_scalar import (ScalarLPConfig, _check_lp_fast_index,
                                        _check_lp_index_device, _event_pair,
                                        _f32, _lp_run_ledger,
                                        scalar_lp_release_cost)
from repro_torch.core.rng import TorchDraws
from repro_torch.device import resolve_device
from repro_torch.kernels.mwem_step import gather_score
from repro_torch.kernels.mwu_update import mwu_update


@dataclass(frozen=True)
class DualLPConfig:
    eps: float = 1.0
    delta: float = 1e-3
    alpha: float = 0.5
    s: int = 16                  # density parameter: ≤ s−1 constraints may violate
    T: int = 200
    mode: str = "fast"           # "exact" | "fast"
    k: Optional[int] = None
    tail_cap: Optional[int] = None
    margin_slack: float = 0.0
    eta: Optional[float] = None


@dataclass
class DualLPResult:
    """Outcome of one `solve_constraint_private_lp`; ``iter_seconds`` as
    in `ScalarLPResult` (CUDA events on the card, empty on the CPU)."""

    x_bar: torch.Tensor
    violations: torch.Tensor
    n_violated: int              # constraints with A x̄ > b + α
    selected: list = field(default_factory=list)
    n_scored: list = field(default_factory=list)
    overflow_count: int = 0
    iter_seconds: list = field(default_factory=list)
    ledger: PrivacyLedger = field(default_factory=PrivacyLedger)


class _DualCalibration(NamedTuple):
    T: int
    eta: float
    rho: float
    eps_prime: float
    scale: float
    k: int
    tail_cap: int


def _dual_eps_prime(cfg: DualLPConfig) -> float:
    """Per-iteration budget ε′ = ε/√(2T ln 1/δ) — from cfg alone, so the
    cost bundle and the solver cannot drift apart."""
    return cfg.eps / math.sqrt(2.0 * cfg.T * math.log(1.0 / cfg.delta))


def _dual_calibrate(A, b, c, opt: float, cfg: DualLPConfig) -> _DualCalibration:
    """Per-iteration budget and scales — one point of truth shared by the
    solver and by `dual_lp_release_cost`."""
    m, d = A.shape
    c_min = float(torch.min(torch.as_tensor(c)))
    b_max = float(torch.max(torch.as_tensor(b)))
    rho = max(opt / c_min - b_max, 1e-6)   # §G width
    T = cfg.T
    eta = cfg.eta if cfg.eta is not None else min(0.5, math.sqrt(math.log(m) / T))
    eps_prime = _dual_eps_prime(cfg)
    sensitivity = 3.0 * opt / (c_min * cfg.s)  # §G: y moves ≤ 2/s, one row add
    return _DualCalibration(
        T=T,
        eta=float(eta),
        rho=float(rho),
        eps_prime=eps_prime,
        scale=float(eps_prime / (2.0 * sensitivity)),
        k=cfg.k or max(1, math.ceil(math.sqrt(d))),
        tail_cap=cfg.tail_cap or default_tail_cap(d),
    )


def dual_lp_release_cost(A, cfg: DualLPConfig, index=None
                         ) -> tuple[list, float, float]:
    """The exact privacy-cost bundle ``(events, γ, Σ2c)`` one
    `solve_constraint_private_lp` run records. ε′ depends on cfg alone and
    the failure mass defaults to 1/d, so ``A`` supplies its shape only."""
    d = tuple(A.shape)[1]
    c_idx = _check_lp_fast_index(cfg, index, "N_j rows")
    return _lp_run_ledger(cfg.mode, cfg.T, _dual_eps_prime(cfg), "dual_oracle",
                          c_idx, cfg.margin_slack,
                          getattr(index, "failure_mass", 1.0 / d)).bundle()


def lp_release_cost(cfg, A, index=None) -> tuple[list, float, float]:
    """Cost bundle for either LP solver, dispatched on the config type —
    the one admission-control entry point."""
    if isinstance(cfg, ScalarLPConfig):
        return scalar_lp_release_cost(A, cfg, index=index)
    if isinstance(cfg, DualLPConfig):
        return dual_lp_release_cost(A, cfg, index=index)
    raise TypeError(f"unknown LP config type {type(cfg).__name__}")


def _vertex(j: torch.Tensor, c: torch.Tensor, opt: torch.Tensor, d: int
            ) -> torch.Tensor:
    """The K_OPT vertex v_j = (OPT/c_j)·e_j, with ``j`` a 0-d id that stays
    on the device."""
    j = j.reshape(1)
    return torch.zeros(d, dtype=torch.float32, device=c.device).index_put(
        (j,), opt / c.index_select(0, j))


def solve_constraint_private_lp(A, b, c, opt: float, cfg: DualLPConfig, draws,
                                index=None,
                                ledger: Optional[PrivacyLedger] = None,
                                device=None) -> DualLPResult:
    """Dense-MWU dual solver.

    Args:
      A: (m, d) constraints, b: (m,) bounds, c: (d,) objective (arrays or
        tensors, moved to ``device``); opt: the objective level OPT.
      draws: a `Draws` implementation or a `torch.Generator` on ``device``.
      index: in fast mode a k-MIPS index over ``lp_dual_rows(A, c, opt)``
        (the (d, m) rows N_j) on ``device``.
      ledger: charged with the run's bundle (a new one if ``None``).
      device: ``None`` runs on ``cuda`` (raising if absent); pass
        ``"cpu"`` for the plain PyTorch path.
    """
    dev = resolve_device(device)
    A, b, c = _f32(A, dev), _f32(b, dev), _f32(c, dev)
    m, d = A.shape
    cal = _dual_calibrate(A, b, c, opt, cfg)
    c_idx = _check_lp_fast_index(cfg, index, "N_j rows")
    _check_lp_index_device(cfg, index, dev)
    if isinstance(draws, torch.Generator):
        draws = TorchDraws(draws)
    scale, timed = cal.scale, dev.type == "cuda"
    slack = cfg.margin_slack * scale if cfg.margin_slack else 0.0
    # 0-d device scalars keep the divisions true divisions on the card
    opt_t = torch.tensor(float(opt), dtype=torch.float32, device=dev)
    rho_t = torch.tensor(cal.rho, dtype=torch.float32, device=dev)
    N = (-(opt_t / c)[:, None] * A.T).contiguous()       # (d, m): N_j as rows

    res = DualLPResult(x_bar=None, violations=None, n_violated=-1)
    logY = torch.zeros(m, dtype=torch.float32, device=dev)
    y = torch.full((m,), 1.0 / m, dtype=torch.float32, device=dev)
    x_sum = torch.zeros(d, dtype=torch.float32, device=dev)
    sel_t = torch.empty(cal.T, dtype=torch.int64, device=dev)
    n_scored_t = torch.empty(cal.T, dtype=torch.int64, device=dev)
    marks = []

    def exact_select(gumbels, y):  # the oracle over all d vertices
        return gumbel_max(gumbels, (N @ y) * scale)

    for t in range(cal.T):
        if timed:
            marks.append(_event_pair())
        if cfg.mode == "exact":
            j = exact_select(draws.exhaustive_gumbel(t, d, dev), y)
            n_scored_t[t] = d
        else:
            idx, raw = index.query(y, cal.k)
            out = lazy_em_from_topk(
                draws, t, idx, raw * scale, d,
                score_fn=lambda ids, active: (
                    gather_score(N, y, ids, active) * scale),
                tail_cap=cal.tail_cap, margin_slack=slack)
            if bool(out.overflow):  # the iteration's one host sync
                j = exact_select(draws.fallback_gumbel(t, d, dev), y)
                res.overflow_count += 1
                n_scored_t[t] = d
            else:
                j = out.index
                n_scored_t[t] = out.n_scored
        sel_t[t] = j
        x_vertex = _vertex(j, c, opt_t, d)
        x_sum = x_sum + x_vertex
        loss = (b - A @ x_vertex) / rho_t
        lw, _, mx, _ = mwu_update(logY, loss, -cal.eta)        # K7
        logY = lw - mx
        y = bregman_project_dense(torch.exp(logY), float(cfg.s))
        if timed:
            marks[-1][1].record()

    res.ledger = _lp_run_ledger(cfg.mode, cal.T, cal.eps_prime, "dual_oracle",
                                c_idx, cfg.margin_slack,
                                getattr(index, "failure_mass", 1.0 / d), ledger)
    res.selected = sel_t.tolist()
    res.n_scored = n_scored_t.tolist()
    res.x_bar = x_sum / cal.T
    res.violations = A @ res.x_bar - b
    res.n_violated = int((res.violations > cfg.alpha).sum())
    if timed:
        marks[-1][1].synchronize()
        res.iter_seconds = [a.elapsed_time(e) / 1e3 for a, e in marks]
    return res
