"""Fast scalar-private LP solver (paper §4.1, Algorithm 3), counterpart of
`repro.core.lp_scalar`.

Feasibility LPs ``Ax ≤ b`` over the simplex ``x ∈ Δ([d])`` in the
scalar-private, low-sensitivity setting: neighboring databases only move
``b`` by ``‖b−b'‖_∞ ≤ Δ_∞`` (A public). Each iteration selects the
most-violated constraint privately; the EM score is the inner product

    Q_t(i) = A_i·x − b_i = ⟨[A_i, b_i], [x, −1]⟩

so LazyEM over a k-MIPS index on the rows ``[A_i, b_i]``
(`repro_torch.mips.lp_scalar_rows`) scores O(√m) constraints an iteration
instead of m.

One Python loop over T runs a wave of B lanes with all state on the device
as (B, d) tensors; a single solve (`solve_scalar_lp`) is the wave of one
lane, so lane b of `solve_lp_batch` equals `solve_scalar_lp` fed lane b's
draws. Each iteration selects — the exhaustive Gumbel-max over the m
scores (``mode="exact"``), or each lane's index probe with ``[x, −1]``,
the lanes' lazy EM in one pass and their tails scored by one
`gather_score_batch` (K3) launch over the ``[A | b]`` rows (``mode="fast"``),
with the lanes whose tail buffer overflowed redone exhaustively on their
fallback streams — then runs the primal player's multiplicative-weights
step as one `mwu_update` (K7) launch on a (B,) grid: ``logX − (η/ρ)·A[sel]``
with the winner's row picked on the device by its id, the max shift and
the softmax. The one host synchronisation an iteration is the read of the
overflow flags in fast mode.

The reference's ``driver`` choice (fused scan or host loop), its AOT
compile cache and its telemetry have no counterpart here: the port runs
this one loop (ROADMAP.md).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.accountant import PrivacyLedger, calibrate_eps0
from repro_torch.core.gumbel import gumbel_max
from repro_torch.core.lazy_em import default_tail_cap, lazy_em_from_topk
from repro_torch.core.rng import LaneDraws
from repro_torch.device import resolve_device
from repro_torch.kernels.mwem_step import gather_score_batch
from repro_torch.kernels.mwu_update import mwu_update


@dataclass(frozen=True)
class ScalarLPConfig:
    eps: float = 1.0
    delta: float = 1e-3
    alpha: float = 0.5
    delta_inf: float = 0.1        # Δ∞ sensitivity of b
    T: Optional[int] = None       # default 9ρ² log d / α²
    mode: str = "fast"            # "exact" | "fast"
    k: Optional[int] = None
    tail_cap: Optional[int] = None
    margin_slack: float = 0.0
    eta: Optional[float] = None


@dataclass
class ScalarLPResult:
    """Outcome of one `solve_scalar_lp`.

    ``iter_seconds`` holds each iteration's device time, from a pair of
    `torch.cuda.Event` records around it, on a CUDA run; it stays empty on
    the CPU, where the port keeps no clock.
    """

    x_bar: torch.Tensor
    violations: torch.Tensor       # A x̄ − b
    violated_frac: float           # fraction with A x̄ > b + α
    selected: list = field(default_factory=list)
    n_scored: list = field(default_factory=list)
    overflow_count: int = 0
    iter_seconds: list = field(default_factory=list)
    ledger: PrivacyLedger = field(default_factory=PrivacyLedger)


@dataclass
class ScalarLPBatchResult:
    """Stacked outputs of `solve_lp_batch` (leading axis = lane).

    ``total_seconds`` is the wave's device time from CUDA events around
    its iterations on a CUDA run, 0.0 on the CPU. ``ledger`` holds one
    run's events; ``ledgers`` the caller's per-lane ledgers, each charged
    with that bundle.
    """

    x_bar: torch.Tensor           # (B, d)
    violated_fracs: np.ndarray    # (B,)
    selected: np.ndarray          # (B, T)
    n_scored: np.ndarray          # (B, T)
    overflow_counts: np.ndarray   # (B,)
    total_seconds: float = 0.0
    ledger: PrivacyLedger = field(default_factory=PrivacyLedger)  # per run
    ledgers: Optional[list] = None


class _LPCalibration(NamedTuple):
    T: int
    eta: float
    rho: float
    eps0: float
    scale: float      # EM log-space factor ε₀/(2Δ∞)
    k: int
    tail_cap: int


def _scalar_calibrate(A, cfg: ScalarLPConfig) -> _LPCalibration:
    """Per-iteration budget, EM scale and buffer sizes — one point of truth
    shared by the solver and by `scalar_lp_release_cost`, so the cost
    bundle an admission controller previews is exactly what a run
    records."""
    A = torch.as_tensor(A)
    m, d = A.shape
    rho = float(torch.max(torch.abs(A)))
    T = cfg.T or max(1, math.ceil(9.0 * rho * rho * math.log(d) / (cfg.alpha ** 2)))
    eta = cfg.eta if cfg.eta is not None else math.sqrt(math.log(d) / T)
    eps0 = calibrate_eps0(cfg.eps, cfg.delta, T, scheme="lp")
    return _LPCalibration(
        T=T,
        eta=float(eta),
        rho=rho,
        eps0=eps0,
        scale=float(eps0 / (2.0 * cfg.delta_inf)),
        k=cfg.k or max(1, math.ceil(math.sqrt(m))),
        tail_cap=cfg.tail_cap or default_tail_cap(m),
    )


def _check_lp_fast_index(cfg, index, what: str) -> float:
    """Validate the (mode, index) pair; returns the index's approximation
    margin c ≥ 0 (0 in exact mode)."""
    if cfg.mode not in ("exact", "fast"):
        raise ValueError(f"unknown mode {cfg.mode!r}")
    if cfg.mode != "fast":
        return 0.0
    if index is None:
        raise ValueError(f"fast mode requires a k-MIPS index over {what}")
    return float(getattr(index, "approx_margin", 0.0))


def _check_lp_index_device(cfg, index, dev: torch.device) -> None:
    if cfg.mode == "fast" and getattr(index, "device", dev) != dev:
        raise ValueError(f"index is on {index.device}, the run on {dev}")


def _record_lp_iteration(ledger: PrivacyLedger, mode: str, eps0: float,
                         label: str, c_idx: float, margin_slack: float) -> None:
    """Ledger entries for one LP iteration — the reference's charging path,
    shared by both solvers and the cost-bundle builders."""
    ledger.record(eps0, 0.0, label)
    if mode == "fast" and c_idx > 0.0 and margin_slack == 0.0:
        ledger.record_approx_slack(c_idx)  # Thm F.2 runtime mode


def _lp_run_ledger(mode: str, T: int, eps0: float, label: str, c_idx: float,
                   margin_slack: float, failure_mass: float,
                   ledger: Optional[PrivacyLedger] = None) -> PrivacyLedger:
    """Charge one LP run's whole bundle: the index failure mass in fast
    mode, then T iterations through `_record_lp_iteration`."""
    ledger = ledger if ledger is not None else PrivacyLedger()
    if mode == "fast":
        ledger.record_index_failure(failure_mass)
    for _ in range(T):
        _record_lp_iteration(ledger, mode, eps0, label, c_idx, margin_slack)
    return ledger


def scalar_lp_release_cost(A, cfg: ScalarLPConfig, index=None
                           ) -> tuple[list, float, float]:
    """The exact privacy-cost bundle ``(events, γ, Σ2c)`` one
    `solve_scalar_lp` run records, built through the solver's own
    calibration and charging path, so ``PrivacyLedger().preview(*...)``
    equals the run's ``ledger.composed()``."""
    m = torch.as_tensor(A).shape[0]
    cal = _scalar_calibrate(A, cfg)
    c_idx = _check_lp_fast_index(cfg, index, "[A_i, b_i]")
    return _lp_run_ledger(cfg.mode, cal.T, cal.eps0, "lp_em", c_idx,
                          cfg.margin_slack,
                          getattr(index, "failure_mass", 1.0 / m)).bundle()


def _f32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(dev).contiguous()


def _event_pair() -> tuple:
    pair = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    pair[0].record()
    return pair


@dataclass
class LPPendingBatch:
    """A wave whose loop `launch_lp_batch` has enqueued: its device tensors
    and what `finish_lp_batch` needs to assemble the result."""

    A: torch.Tensor
    b: torch.Tensor               # (m,) shared or (B, m) per lane
    cfg: ScalarLPConfig
    cal: _LPCalibration
    c_idx: float
    index: object
    x_sum: torch.Tensor           # (B, d)
    selected: torch.Tensor        # (T, B) int64
    n_scored: torch.Tensor        # (T, B) int64
    overflow: torch.Tensor        # (T, B) bool
    marks: list                   # CUDA event pairs an iteration, on the card


def launch_lp_batch(A, b, cfg: ScalarLPConfig, draws, index=None,
                    device=None) -> LPPendingBatch:
    """Enqueue a wave of B LP solves — the launch half of `solve_lp_batch`.

    In fast mode each iteration reads the wave's (B,) overflow flags back
    to the host, so this returns once the last iteration is enqueued; its
    device work may still be running.
    """
    dev = resolve_device(device)
    A, b = _f32(A, dev), _f32(b, dev)
    m, d = A.shape
    if not isinstance(draws, LaneDraws):
        draws = LaneDraws(draws)
    B = len(draws)
    if b.dim() == 2:
        if cfg.mode == "fast":
            raise ValueError(
                "per-lane b instances require mode='exact': the k-MIPS index "
                "rows [A_i, b_i] embed a single b")
        if tuple(b.shape) != (B, m):
            raise ValueError(f"per-lane b must be ({B}, {m}), got {tuple(b.shape)}")
    elif tuple(b.shape) != (m,):
        raise ValueError(f"b must be ({m},) or ({B}, {m}), got {tuple(b.shape)}")
    cal = _scalar_calibrate(A, cfg)
    c_idx = _check_lp_fast_index(cfg, index, "[A_i, b_i]")
    _check_lp_index_device(cfg, index, dev)
    scale, timed = cal.scale, dev.type == "cuda"
    slack = cfg.margin_slack * scale if cfg.margin_slack else 0.0
    coef = -(cal.eta / cal.rho)

    logX = torch.zeros((B, d), dtype=torch.float32, device=dev)
    x = torch.full((B, d), 1.0 / d, dtype=torch.float32, device=dev)
    x_sum = torch.zeros((B, d), dtype=torch.float32, device=dev)
    sel_t = torch.empty((cal.T, B), dtype=torch.int64, device=dev)
    n_scored_t = torch.full((cal.T, B), m, dtype=torch.int64, device=dev)
    over_t = torch.zeros((cal.T, B), dtype=torch.bool, device=dev)
    marks = []
    if cfg.mode == "fast":
        Ab = torch.cat([A, b[:, None]], dim=1)   # the index's rows
        minus_one = torch.full((B, 1), -1.0, dtype=torch.float32, device=dev)

    def exact_select(gumbels, X, bb):  # Alg. 3 oracle over all m constraints
        return gumbel_max(gumbels, (X @ A.T - bb) * scale)

    for t in range(cal.T):
        if timed:
            marks.append(_event_pair())
        if cfg.mode == "exact":
            sel = exact_select(draws.exhaustive_gumbel(t, m, dev), x, b)
        else:
            xq = torch.cat([x, minus_one], dim=1)              # (B, d+1)
            probes = [index.query(xq[lane], cal.k) for lane in range(B)]
            idx = torch.stack([ids for ids, _ in probes])
            raw = torch.stack([s for _, s in probes])
            out = lazy_em_from_topk(
                draws, t, idx, raw * scale, m,
                score_fn=lambda ids, active: (
                    gather_score_batch(Ab, xq, ids, active) * scale),
                tail_cap=cal.tail_cap, margin_slack=slack)
            sel, n_scored = out.index, out.n_scored
            over_t[t] = out.overflow
            # the iteration's one host sync: which lanes overflowed
            redo = [lane for lane, o in enumerate(out.overflow.tolist()) if o]
            if redo:
                lanes = torch.tensor(redo, dtype=torch.int64, device=dev)
                fallback = exact_select(draws.fallback_gumbel(t, m, dev, redo),
                                        x.index_select(0, lanes), b)
                sel = sel.index_put((lanes,), fallback)
                n_scored = n_scored.index_fill(0, lanes, m)
            n_scored_t[t] = n_scored
        sel_t[t] = sel
        lw, x, mx, _ = mwu_update(logX, A, coef, rows=sel)    # K7
        logX = lw - mx.unsqueeze(-1)
        x_sum = x_sum + x
        if timed:
            marks[-1][1].record()
    return LPPendingBatch(A=A, b=b, cfg=cfg, cal=cal, c_idx=c_idx, index=index,
                          x_sum=x_sum, selected=sel_t, n_scored=n_scored_t,
                          overflow=over_t, marks=marks)


def _pending_ledger(pending: LPPendingBatch,
                    ledger: Optional[PrivacyLedger] = None) -> PrivacyLedger:
    cfg, m = pending.cfg, pending.A.shape[0]
    return _lp_run_ledger(cfg.mode, pending.cal.T, pending.cal.eps0, "lp_em",
                          pending.c_idx, cfg.margin_slack,
                          getattr(pending.index, "failure_mass", 1.0 / m),
                          ledger)


def finish_lp_batch(pending: LPPendingBatch,
                    ledgers: Optional[list] = None) -> ScalarLPBatchResult:
    """Wait for a launched wave and assemble its `ScalarLPBatchResult` —
    the finish half of `solve_lp_batch`. ``ledgers``: one `PrivacyLedger`
    a lane (``None`` skips a lane), each charged with the run's bundle."""
    B = pending.x_sum.shape[0]
    if ledgers is not None and len(ledgers) != B:
        raise ValueError(f"ledgers must have one entry per lane "
                         f"({len(ledgers)} != {B})")
    total = 0.0
    if pending.marks:
        pending.marks[-1][1].synchronize()
        total = pending.marks[0][0].elapsed_time(pending.marks[-1][1]) / 1e3
    x_bar = pending.x_sum / pending.cal.T
    viol = x_bar @ pending.A.T - pending.b                   # (B, m)
    ledger = _pending_ledger(pending)
    if ledgers is not None:
        for lane in ledgers:
            if lane is not None:
                lane.record_events(*ledger.bundle())
    return ScalarLPBatchResult(
        x_bar=x_bar,
        violated_fracs=(viol > pending.cfg.alpha).float().mean(1).cpu().numpy(),
        selected=pending.selected.T.cpu().numpy(),
        n_scored=pending.n_scored.T.cpu().numpy(),
        overflow_counts=pending.overflow.sum(0).cpu().numpy(),
        total_seconds=total,
        ledger=ledger,
        ledgers=list(ledgers) if ledgers is not None else None,
    )


def solve_lp_batch(A, b, cfg: ScalarLPConfig, draws, index=None,
                   ledgers: Optional[list] = None,
                   device=None) -> ScalarLPBatchResult:
    """Run a wave of B scalar-private LP solves together — the LP serving
    dispatch.

    Args:
      A: (m, d) constraint matrix; b: shared (m,) bounds, or (B, m)
        per-lane instances (exact mode only: the fast probe's rows
        ``[A_i, b_i]`` embed one ``b``).
      draws: a `LaneDraws`, or a sequence of B `Draws` or
        `torch.Generator`s — one source a lane; lane b equals
        `solve_scalar_lp` fed lane b's source.
      index: in fast mode a k-MIPS index over ``lp_scalar_rows(A, b)`` on
        the run's device, probed lane by lane.
      ledgers: optional B `PrivacyLedger`s, each charged with the run's
        `scalar_lp_release_cost` bundle (``None`` entries skip a lane).

    Exactly ``finish_lp_batch(launch_lp_batch(...), ledgers)``.
    """
    B = len(draws)
    if ledgers is not None and len(ledgers) != B:  # before the wave runs
        raise ValueError(f"ledgers must have one entry per lane "
                         f"({len(ledgers)} != {B})")
    return finish_lp_batch(
        launch_lp_batch(A, b, cfg, draws, index=index, device=device),
        ledgers=ledgers)


def solve_scalar_lp(A, b, cfg: ScalarLPConfig, draws, index=None,
                    ledger: Optional[PrivacyLedger] = None,
                    device=None) -> ScalarLPResult:
    """Algorithm 3 on one lane.

    Args:
      A: (m, d) constraints; b: (m,) bounds (arrays or tensors, moved to
        ``device``).
      cfg: solver configuration; ``mode="fast"`` requires ``index``.
      draws: the randomness — a `Draws` implementation, or a
        `torch.Generator` on ``device``.
      index: a k-MIPS index over ``lp_scalar_rows(A, b)`` on ``device``
        (`FlatIndex`, `IVFIndex`): ``query(v, k) -> (ids, signed scores)``.
      ledger: charged with the run's bundle (a new one if ``None``).
      device: ``None`` runs on ``cuda`` (raising if absent); pass
        ``"cpu"`` for the plain PyTorch path.
    """
    b = _f32(b, resolve_device(device))
    if b.dim() != 1:
        raise ValueError("solve_scalar_lp takes one (m,) b; per-lane b "
                         "instances run through solve_lp_batch")
    pending = launch_lp_batch(A, b, cfg, [draws], index=index, device=device)
    res = ScalarLPResult(x_bar=pending.x_sum[0] / pending.cal.T,
                         violations=None, violated_frac=float("nan"),
                         ledger=_pending_ledger(pending, ledger))
    res.selected = pending.selected[:, 0].tolist()
    res.n_scored = pending.n_scored[:, 0].tolist()
    res.overflow_count = int(pending.overflow.sum())
    res.violations = pending.A @ res.x_bar - pending.b
    res.violated_frac = float((res.violations > cfg.alpha).float().mean())
    if pending.marks:
        pending.marks[-1][1].synchronize()
        res.iter_seconds = [a.elapsed_time(e) / 1e3 for a, e in pending.marks]
    return res
