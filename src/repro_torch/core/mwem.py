"""MWEM (Alg. 1) and Fast-MWEM (Alg. 2) for private linear-query release,
counterpart of `repro.core.mwem` on one lane.

As in the reference, the only difference between classic MWEM and
Fast-MWEM is the private-selection oracle — the exhaustive EM, or LazyEM
over a k-MIPS index — and everything else (multiplicative weights,
accounting, output averaging) is shared.

`run_mwem` is one Python loop over T with all state on the device. Each
iteration forms the probe ``v = h − p``; selects a query — exhaustive
Gumbel-max over ``|Q v|`` (``mode="exact"``), or the index's top-k plus a
lazily drawn tail (``mode="fast"``), whose scores come from the
`gather_score` kernel over a dense workload and from the
`marginal_gather_score` kernel over a factored `MarginalWorkload`; on a
tail-buffer overflow it redoes the selection exhaustively on the fallback
stream; then the fused `mwem_step` kernel measures the winner, applies the
update, renormalizes and accumulates, carrying ``(log_w, p, p_sum)`` like
the reference's fused route (a factored winner's implicit row is first
materialized as a (1, U) table, the reference's `mwu_apply` route). The
one host synchronisation per iteration is the read of the overflow flag
in fast mode. The full (m, U) matrix products of the exhaustive oracle and
the error evaluation are left to `torch.matmul`, as the reference leaves
them to XLA; over a factored workload they are the workload's implicit-row
products and segment sums, and no (m, U) table is built.

Every ε and δ goes to the `PrivacyLedger` through `_record_iteration`, the
reference's charging path, so `release_cost` previews exactly what a run
spends.

`run_mwem_batch` runs a wave of B lanes — the counterpart of the
reference's `run_mwem_batch` (its waved scan core, and the vmapped core in
exact mode) — carrying ``(log_w, p, p_sum)`` as (B, U) tensors: one
``index.query_batch`` probe for all lanes (K5 over IVF, a (B, U) @ (U, m)
product over the flat index), the lanes' lazy EM in one pass, all tails
scored by one `gather_score_batch` launch, and `mwem_step_batch` (K2 on a
(B,) grid). The overflow flags of the wave are read back once an
iteration, and only the lanes that overflowed redo the selection
exhaustively, each on its own fallback stream.

A wave over a factored `MarginalWorkload` takes the reference's route for
indices with full scores (its vmapped core with
``query_in_graph_with_scores``): the index's `query_batch_with_scores`
gives each lane's top-k and all m signed scores, read off one pass of the
workload's segment sums (or implicit-row product) over the (B, U) block;
the tail and the overflow redo look those scores up, so no tail kernel
runs (the single-lane path scores its tail with K6). The B winners' rows
are materialized as a (B, U) table for `mwem_step_batch`. In exact mode
the oracle is the workload's implicit-row product over the block.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.accountant import PrivacyLedger, calibrate_eps0
from repro_torch.core.em import exact_em
from repro_torch.core.lazy_em import default_tail_cap, lazy_em_from_topk
from repro_torch.core.queries import max_error
from repro_torch.core.rng import Draws, LaneDraws, TorchDraws
from repro_torch.core.workload import as_workload, aug_decompose
from repro_torch.device import resolve_device
from repro_torch.kernels.mwem_step import (gather_score, gather_score_batch,
                                           marginal_gather_score, mwem_step,
                                           mwem_step_batch)


@dataclass(frozen=True)
class MWEMConfig:
    eps: float = 1.0
    delta: float = 1e-3
    T: int = 100
    update_rule: str = "hardt"   # "paper" | "signed" | "hardt"
    mode: str = "fast"           # "exact" | "fast"
    k: Optional[int] = None      # top-k size; default ceil(√m)
    tail_cap: Optional[int] = None
    margin_slack: float = 0.0    # c ≥ 0 → Alg. 6 privacy-preserving approx mode
    eta: Optional[float] = None  # default √(ln U / T)
    measure_frac: float = 0.5    # ε₀ fraction spent on the Laplace measurement
    eval_every: int = 0          # 0 → only final error
    n_records: Optional[int] = None  # dataset size n → sensitivity Δu = 1/n


class MWEMState(NamedTuple):
    """The carried state: (U,) for one lane, (B, U) for a wave."""

    log_w: torch.Tensor   # log weights, max-shifted to 0
    p_sum: torch.Tensor   # running sum of iterates for the averaged output


@dataclass
class MWEMResult:
    """Outcome of one `run_mwem`.

    ``iter_seconds`` holds each iteration's device time, from a pair of
    `torch.cuda.Event` records around it, on a CUDA run; it stays empty on
    the CPU, where the port keeps no clock.
    """

    p_hat: torch.Tensor
    final_error: float
    errors: list = field(default_factory=list)        # (t, ‖Q(p−h)‖_∞) pairs
    selected: list = field(default_factory=list)      # chosen query index per t
    n_scored: list = field(default_factory=list)      # score evaluations per t
    overflow_count: int = 0
    iter_seconds: list = field(default_factory=list)
    ledger: PrivacyLedger = field(default_factory=PrivacyLedger)


@dataclass
class MWEMBatchResult:
    """Stacked outputs of `run_mwem_batch` (leading axis = lane).

    ``total_seconds`` is the wave's device time from CUDA events around
    the whole loop on a CUDA run, 0.0 on the CPU, where the port keeps no
    clock. ``ledger`` holds one run's events; ``ledgers`` the caller's
    per-lane ledgers, each charged with that bundle.
    """

    p_hat: torch.Tensor          # (B, U)
    final_errors: np.ndarray     # (B,)
    selected: np.ndarray         # (B, T)
    n_scored: np.ndarray         # (B, T)
    overflow_counts: np.ndarray  # (B,)
    errors: Optional[np.ndarray] = None  # (B, n_evals) when eval_every set
    eval_every: int = 0
    total_seconds: float = 0.0
    ledger: PrivacyLedger = field(default_factory=PrivacyLedger)  # per run
    ledgers: Optional[list] = None  # per-lane ledgers when the caller passed them

    def unbatch(self) -> list:
        """One `MWEMResult` a lane. Each carries its own ledger when the
        caller passed per-lane ledgers, else the shared per-run ledger.
        The lanes run together, so no lane has a per-iteration time of its
        own: ``iter_seconds`` stays empty."""
        B, T = self.selected.shape
        out = []
        for b in range(B):
            errors = []
            if self.errors is not None:
                errors = [(t, float(e)) for t, e in
                          zip(range(self.eval_every, T + 1, self.eval_every),
                              self.errors[b])]
            out.append(MWEMResult(
                p_hat=self.p_hat[b],
                final_error=float(self.final_errors[b]),
                errors=errors,
                selected=[int(s) for s in self.selected[b]],
                n_scored=[int(s) for s in self.n_scored[b]],
                overflow_count=int(self.overflow_counts[b]),
                iter_seconds=[],
                ledger=self.ledgers[b] if self.ledgers is not None else self.ledger,
            ))
        return out


class _Calibration(NamedTuple):
    eps_em: float
    eps_meas: float
    sensitivity: float  # Δu = 1/n
    scale: float      # EM log-space factor ε₀/(2Δu)
    lap_scale: float  # Laplace measurement noise scale
    eta: float
    k: int
    tail_cap: int


def _calibrate(cfg: MWEMConfig, m: int, U: int) -> _Calibration:
    """Per-iteration budgets, noise scales and buffer sizes from the config."""
    eps0 = calibrate_eps0(cfg.eps, cfg.delta, cfg.T, scheme="mwem")
    if cfg.update_rule == "paper":
        eps_em, eps_meas = eps0, 0.0
    else:
        eps_em = eps0 * (1.0 - cfg.measure_frac)
        eps_meas = eps0 * cfg.measure_frac
    # Δu = 1/n: one record moves one histogram cell by 1/n, so each
    # |⟨q, h−p⟩| utility moves by at most 1/n (q ∈ [0,1]^U).
    if cfg.n_records is None:
        raise ValueError("MWEMConfig.n_records (dataset size n) is required")
    sensitivity = 1.0 / cfg.n_records
    return _Calibration(
        eps_em=eps_em,
        eps_meas=eps_meas,
        sensitivity=sensitivity,
        scale=float(eps_em / (2.0 * sensitivity)),
        lap_scale=float(sensitivity / max(eps_meas, 1e-12)),
        eta=float(cfg.eta if cfg.eta is not None else math.sqrt(math.log(U) / cfg.T)),
        k=cfg.k or max(1, math.ceil(math.sqrt(m))),
        tail_cap=cfg.tail_cap or default_tail_cap(2 * m),
    )


def _record_iteration(ledger: PrivacyLedger, mode: str, rule: str,
                      cal: _Calibration, c_idx: float, margin_slack: float) -> None:
    """Ledger entries for one iteration — the reference's charging path."""
    if mode == "exact":
        ledger.record(cal.eps_em, 0.0, "em")
    else:
        ledger.record(cal.eps_em, 0.0, "lazy_em")
        if c_idx > 0.0 and margin_slack == 0.0:
            ledger.record_approx_slack(c_idx)  # Thm F.2 runtime mode
    if rule != "paper":
        ledger.record(cal.eps_meas, 0.0, "laplace")


def _check_fast_index(cfg: MWEMConfig, index) -> float:
    if cfg.mode not in ("exact", "fast"):
        raise ValueError(f"unknown mode {cfg.mode!r}")
    if cfg.mode != "fast":
        return 0.0
    if index is None:
        raise ValueError("fast mode requires a k-MIPS index")
    return float(getattr(index, "approx_margin", 0.0))


def release_cost(cfg: MWEMConfig, m: int, U: int, index=None
                 ) -> tuple[list, float, float]:
    """The exact privacy-cost bundle ``(events, γ, Σ2c)`` one `run_mwem`
    records, built through the same `_calibrate`/`_record_iteration` path,
    so ``PrivacyLedger().preview(*release_cost(...))`` equals the run's
    ``ledger.composed()``."""
    tmp = _run_ledger(cfg, _calibrate(cfg, m, U), _check_fast_index(cfg, index),
                      index, m)
    return list(tmp.events), tmp.index_failure_mass, tmp.approx_slack


def _run_ledger(cfg: MWEMConfig, cal: _Calibration, c_idx: float, index, m: int,
                ledger: Optional[PrivacyLedger] = None) -> PrivacyLedger:
    """Charge one run's whole bundle: the index failure mass in fast mode,
    then T iterations through `_record_iteration`."""
    ledger = ledger if ledger is not None else PrivacyLedger()
    if cfg.mode == "fast":
        ledger.record_index_failure(getattr(index, "failure_mass", 1.0 / m))
    for _ in range(cfg.T):
        _record_iteration(ledger, cfg.mode, cfg.update_rule, cal, c_idx,
                          cfg.margin_slack)
    return ledger


def _measure_noise(draws: Draws, t: int, rule: str, lap_scale: float,
                   device, lanes: tuple = ()) -> torch.Tensor:
    """Realized Laplace measurement noise, of shape ``lanes`` (one draw a
    lane of a `LaneDraws`); ``rule="paper"`` measures nothing and draws
    nothing."""
    if rule == "paper":
        return torch.zeros(lanes, dtype=torch.float32, device=device)
    return lap_scale * draws.laplace(t, device)


def _run_device(W, index, cfg: MWEMConfig, dev: torch.device) -> None:
    if W.device != dev:
        raise ValueError(f"Q is on {W.device}, the run on {dev}")
    if cfg.mode == "fast" and index.device != dev:
        raise ValueError(f"index is on {index.device}, the run on {dev}")


def run_mwem(Q, h, cfg: MWEMConfig, draws, index=None,
             ledger: Optional[PrivacyLedger] = None, device=None) -> MWEMResult:
    """Run (Fast-)MWEM for ``cfg.T`` iterations on one lane.

    Args:
      Q: (m, U) query matrix with entries in [0, 1] (array, tensor or
        `DenseWorkload`), moved to ``device`` if it is not there; or a
        factored `MarginalWorkload` on ``device``.
      h: (U,) true normalized histogram.
      cfg: engine configuration; ``mode="fast"`` requires ``index``.
      draws: the randomness — a `Draws` implementation, or a
        `torch.Generator` on ``device`` (wrapped in `TorchDraws`).
      index: a k-MIPS index over the complement-augmented queries on the
        same device (`repro_torch.mips`; over a `MarginalWorkload` the
        `FlatAbsIndex` or `MarginalIVFIndex` of it): ``query(v, k) ->
        (aug ids, raw scores)`` plus ``approx_margin`` and
        ``failure_mass``.
      device: ``None`` runs on ``cuda`` (raising if absent); pass
        ``"cpu"`` for the plain PyTorch path.
    """
    dev = resolve_device(device)
    W = as_workload(Q, dev)
    h = torch.as_tensor(h, dtype=torch.float32, device=dev)
    m, U = W.m, W.U
    cal = _calibrate(cfg, m, U)
    c_idx = _check_fast_index(cfg, index)
    _run_device(W, index, cfg, dev)
    if isinstance(draws, torch.Generator):
        draws = TorchDraws(draws)

    res = MWEMResult(p_hat=None, final_error=float("nan"))
    slack = cfg.margin_slack * cal.scale if cfg.margin_slack else 0.0
    timed = dev.type == "cuda"
    marks = []

    log_w = torch.zeros(U, dtype=torch.float32, device=dev)
    p = torch.softmax(log_w, dim=0)
    p_sum = torch.zeros(U, dtype=torch.float32, device=dev)
    sel_t = torch.empty(cfg.T, dtype=torch.int64, device=dev)
    n_scored_t = torch.empty(cfg.T, dtype=torch.int64, device=dev)

    def tail_scores(v):  # K3 over the rows, or K6 over the factored cells
        if W.is_dense:
            return lambda idx, active: (gather_score(W.Q, v, idx, active)
                                        * cal.scale)
        return lambda idx, active: (marginal_gather_score(W, v, idx, active)
                                    * cal.scale)

    def exact_select(gumbels, v):  # Alg. 1 oracle: score all m queries
        return exact_em(gumbels, W.scores(v).abs(), cal.eps_em, cal.sensitivity)

    for t in range(cfg.T):
        if timed:
            marks.append((torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)))
            marks[-1][0].record()
        v = h - p
        if cfg.mode == "exact":
            sel = exact_select(draws.exhaustive_gumbel(t, m, dev), v)
            n_scored_t[t] = m
        else:
            aug_idx, raw = index.query(v, cal.k)
            out = lazy_em_from_topk(draws, t, aug_idx, raw * cal.scale, 2 * m,
                                    score_fn=tail_scores(v),
                                    tail_cap=cal.tail_cap, margin_slack=slack)
            if bool(out.overflow):  # the iteration's one host sync
                sel = exact_select(draws.fallback_gumbel(t, m, dev), v)
                res.overflow_count += 1
                n_scored_t[t] = m
            else:
                sel = torch.remainder(out.index, m)
                n_scored_t[t] = out.n_scored
        sel_t[t] = sel
        noise = _measure_noise(draws, t, cfg.update_rule, cal.lap_scale, dev)
        rows, row = W.winner_table(sel)
        log_w, p, p_sum = mwem_step(log_w, p, p_sum, rows, row, h, noise,
                                    rule=cfg.update_rule, eta=cal.eta)
        if timed:
            marks[-1][1].record()
        if cfg.eval_every and (t + 1) % cfg.eval_every == 0:
            res.errors.append((t + 1, float(max_error(W, h, p_sum / (t + 1)))))

    res.ledger = _run_ledger(cfg, cal, c_idx, index, m, ledger)
    res.selected = sel_t.tolist()
    res.n_scored = n_scored_t.tolist()
    res.p_hat = p_sum / cfg.T
    res.final_error = float(max_error(W, h, res.p_hat))
    if timed:
        torch.cuda.synchronize(dev)
        res.iter_seconds = [a.elapsed_time(b) / 1e3 for a, b in marks]
    return res


@dataclass
class MWEMPendingBatch:
    """A wave whose loop `launch_mwem_batch` has enqueued: its device
    tensors and what `finish_mwem_batch` needs to assemble the result."""

    W: object
    h: torch.Tensor              # (U,) shared or (B, U) per lane
    cfg: MWEMConfig
    cal: _Calibration
    c_idx: float
    index: object
    p_sum: torch.Tensor          # (B, U)
    selected: torch.Tensor       # (T, B) int64
    n_scored: torch.Tensor       # (T, B) int64
    overflow: torch.Tensor       # (T, B) bool
    errors: list                 # (B,) error tensors at the eval steps
    marks: Optional[tuple]       # CUDA events around the loop, on the card


def _check_wave_index(W, index) -> None:
    """A fast wave's index must probe a whole wave of ``W``: `query_batch`
    over a dense workload, `query_batch_with_scores` over a factored one
    (and be built over that very workload)."""
    name = type(index).__name__
    if W.is_dense:
        if not getattr(index, "supports_batch_probe", False):
            raise ValueError(f"{name} cannot probe a wave: the batch needs an "
                             "index with query_batch")
        return
    if not getattr(index, "has_full_scores", False):
        raise ValueError(f"{name} has no factored wave probe: a wave over a "
                         "MarginalWorkload needs its FlatAbsIndex or "
                         "MarginalIVFIndex (query_batch_with_scores)")
    if index.workload is not W:
        raise ValueError(f"{name} was built over another workload than the "
                         "wave's")


def launch_mwem_batch(Q, h, cfg: MWEMConfig, draws, index=None,
                      device=None) -> MWEMPendingBatch:
    """Enqueue a wave of B lanes — the launch half of `run_mwem_batch`.

    In fast mode each iteration reads the wave's (B,) overflow flags back
    to the host (one sync a wave, not one a lane) to decide which lanes
    redo the selection, so this returns only after the last iteration has
    been enqueued; its device work may still be running. Overlapping one
    wave with the next comes with an on-device loop.
    """
    dev = resolve_device(device)
    W = as_workload(Q, dev)
    h = torch.as_tensor(h, dtype=torch.float32, device=dev)
    m, U = W.m, W.U
    cal = _calibrate(cfg, m, U)
    c_idx = _check_fast_index(cfg, index)
    _run_device(W, index, cfg, dev)
    if cfg.mode == "fast":
        _check_wave_index(W, index)
    if not isinstance(draws, LaneDraws):
        draws = LaneDraws(draws)
    B = len(draws)
    if h.dim() == 2 and tuple(h.shape) != (B, U):
        raise ValueError(f"per-lane h must be ({B}, {U}), got {tuple(h.shape)}")
    slack = cfg.margin_slack * cal.scale if cfg.margin_slack else 0.0
    marks = None
    if dev.type == "cuda":
        marks = (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
        marks[0].record()

    log_w = torch.zeros((B, U), dtype=torch.float32, device=dev)
    p = torch.softmax(log_w, dim=-1)
    p_sum = torch.zeros((B, U), dtype=torch.float32, device=dev)
    sel_t = torch.empty((cfg.T, B), dtype=torch.int64, device=dev)
    n_scored_t = torch.full((cfg.T, B), m, dtype=torch.int64, device=dev)
    over_t = torch.zeros((cfg.T, B), dtype=torch.bool, device=dev)
    errors = []

    def exact_select(gumbels, V):  # Alg. 1 oracle for a block of lanes
        return exact_em(gumbels, W.scores(V).abs(), cal.eps_em, cal.sensitivity)

    for t in range(cfg.T):
        v = h - p                                          # (B, U)
        if cfg.mode == "exact":
            sel = exact_select(draws.exhaustive_gumbel(t, m, dev), v)
        else:
            if W.is_dense:
                aug_idx, raw = index.query_batch(v, cal.k)     # (B, k) each
                S = None

                def score_fn(idx, active):
                    return gather_score_batch(W.Q, v, idx, active) * cal.scale
            else:  # the probe's (B, m) signed scores serve tail and redo
                aug_idx, raw, S = index.query_batch_with_scores(v, cal.k)

                def score_fn(idx, active):
                    base, sign = aug_decompose(idx, m)
                    return S.gather(1, base) * sign * cal.scale
            out = lazy_em_from_topk(draws, t, aug_idx, raw * cal.scale, 2 * m,
                                    score_fn=score_fn, tail_cap=cal.tail_cap,
                                    margin_slack=slack)
            sel = torch.remainder(out.index, m)
            n_scored = out.n_scored
            over_t[t] = out.overflow
            # the iteration's one host sync: which lanes overflowed
            redo = [b for b, o in enumerate(out.overflow.tolist()) if o]
            if redo:
                lanes = torch.tensor(redo, dtype=torch.int64, device=dev)
                gumbels = draws.fallback_gumbel(t, m, dev, redo)
                if S is None:
                    fallback = exact_select(gumbels, v.index_select(0, lanes))
                else:
                    fallback = exact_em(gumbels, S.index_select(0, lanes).abs(),
                                        cal.eps_em, cal.sensitivity)
                sel = sel.index_put((lanes,), fallback)
                n_scored = n_scored.index_fill(0, lanes, m)
            n_scored_t[t] = n_scored
        sel_t[t] = sel
        noise = _measure_noise(draws, t, cfg.update_rule, cal.lap_scale, dev,
                               (B,))
        rows, row_ids = W.winner_table(sel)
        log_w, p, p_sum = mwem_step_batch(log_w, p, p_sum, rows, row_ids, h,
                                          noise, rule=cfg.update_rule,
                                          eta=cal.eta)
        if cfg.eval_every and (t + 1) % cfg.eval_every == 0:
            errors.append(max_error(W, h, p_sum / (t + 1)))
    if marks is not None:
        marks[1].record()
    return MWEMPendingBatch(W=W, h=h, cfg=cfg, cal=cal, c_idx=c_idx,
                            index=index, p_sum=p_sum, selected=sel_t,
                            n_scored=n_scored_t, overflow=over_t,
                            errors=errors, marks=marks)


def finish_mwem_batch(pending: MWEMPendingBatch,
                      ledgers: Optional[list] = None) -> MWEMBatchResult:
    """Wait for a launched wave and assemble its `MWEMBatchResult` — the
    finish half of `run_mwem_batch`. ``ledgers``: one `PrivacyLedger` a
    lane (``None`` skips a lane), each charged with the run's bundle."""
    cfg, W = pending.cfg, pending.W
    B = pending.p_sum.shape[0]
    if ledgers is not None and len(ledgers) != B:
        raise ValueError(f"ledgers must have one entry per lane "
                         f"({len(ledgers)} != {B})")
    total = 0.0
    if pending.marks is not None:
        pending.marks[1].synchronize()
        total = pending.marks[0].elapsed_time(pending.marks[1]) / 1e3
    p_hat = pending.p_sum / cfg.T
    final_errors = max_error(W, pending.h, p_hat)
    ledger = _run_ledger(cfg, pending.cal, pending.c_idx, pending.index, W.m)
    if ledgers is not None:
        for lane in ledgers:
            if lane is not None:
                lane.record_events(ledger.events, ledger.index_failure_mass,
                                   ledger.approx_slack)
    errors = None
    if cfg.eval_every:
        errors = torch.stack(pending.errors, dim=1).cpu().numpy()
    return MWEMBatchResult(
        p_hat=p_hat,
        final_errors=final_errors.cpu().numpy(),
        selected=pending.selected.T.cpu().numpy(),
        n_scored=pending.n_scored.T.cpu().numpy(),
        overflow_counts=pending.overflow.sum(0).cpu().numpy(),
        errors=errors,
        eval_every=cfg.eval_every,
        total_seconds=total,
        ledger=ledger,
        ledgers=list(ledgers) if ledgers is not None else None,
    )


def run_mwem_batch(Q, h, cfg: MWEMConfig, draws, index=None,
                   ledgers: Optional[list] = None,
                   device=None) -> MWEMBatchResult:
    """Run a wave of B (Fast-)MWEM releases together.

    Args:
      Q: (m, U) query matrix (array, tensor or `DenseWorkload`), or a
        factored `MarginalWorkload` on the run's device.
      h: shared (U,) histogram, or (B, U) with one histogram a lane.
      cfg: engine configuration, the same for every lane.
      draws: a `LaneDraws`, or a sequence of B `Draws` or
        `torch.Generator`s — one source a lane. Lane b makes exactly the
        draws a single-lane `run_mwem` fed lane b's source makes, so it
        selects the same queries (the IVF wave probe ranks exact score
        ties in slot order, see `repro_torch.kernels.ivf_probe.ref`; a
        factored lane looks its tail up in the probe's scores where the
        single lane scores it with K6, so a near tie may go either way).
      index: in fast mode, an index with ``query_batch(V, k)``
        (`FlatAbsIndex`, `IVFIndex`) on the run's device; over a
        `MarginalWorkload`, its `FlatAbsIndex` or `MarginalIVFIndex`
        (``query_batch_with_scores``).
      ledgers: optional list of B `PrivacyLedger`s, one a lane, each
        charged with that lane's `release_cost` bundle (``None`` entries
        skip a lane). The result's ``ledger`` is one run's.
      device: ``None`` runs on ``cuda`` (raising if absent); ``"cpu"``
        runs the plain PyTorch path.

    Exactly ``finish_mwem_batch(launch_mwem_batch(...), ledgers)``.
    """
    B = len(draws)
    if ledgers is not None and len(ledgers) != B:  # before the wave runs
        raise ValueError(f"ledgers must have one entry per lane "
                         f"({len(ledgers)} != {B})")
    return finish_mwem_batch(
        launch_mwem_batch(Q, h, cfg, draws, index=index, device=device),
        ledgers=ledgers)
