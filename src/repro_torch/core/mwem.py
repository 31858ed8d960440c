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
`gather_score` kernel; on a tail-buffer overflow it redoes the selection
exhaustively on the fallback stream; then the fused `mwem_step` kernel
measures the winner, applies the update, renormalizes and accumulates,
carrying ``(log_w, p, p_sum)`` like the reference's fused route. The one
host synchronisation per iteration is the read of the overflow flag in
fast mode. The full (m, U) matrix products of the exhaustive oracle and
the error evaluation are left to `torch.matmul`, as the reference leaves
them to XLA.

Every ε and δ goes to the `PrivacyLedger` through `_record_iteration`, the
reference's charging path, so `release_cost` previews exactly what a run
spends.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from repro_torch.core.accountant import PrivacyLedger, calibrate_eps0
from repro_torch.core.em import exact_em
from repro_torch.core.lazy_em import default_tail_cap, lazy_em_from_topk
from repro_torch.core.queries import max_error
from repro_torch.core.rng import Draws, TorchDraws
from repro_torch.core.workload import as_workload
from repro_torch.device import resolve_device
from repro_torch.kernels.mwem_step import gather_score, mwem_step


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
    log_w: torch.Tensor   # (U,) log weights, max-shifted to 0
    p_sum: torch.Tensor   # (U,) running sum of iterates for the averaged output


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
    cal = _calibrate(cfg, m, U)
    c_idx = _check_fast_index(cfg, index)
    tmp = PrivacyLedger()
    if cfg.mode == "fast":
        tmp.record_index_failure(getattr(index, "failure_mass", 1.0 / m))
    for _ in range(cfg.T):
        _record_iteration(tmp, cfg.mode, cfg.update_rule, cal, c_idx,
                          cfg.margin_slack)
    return list(tmp.events), tmp.index_failure_mass, tmp.approx_slack


def _measure_noise(draws: Draws, t: int, rule: str, lap_scale: float,
                   device) -> torch.Tensor:
    """Realized Laplace measurement noise; ``rule="paper"`` measures
    nothing and draws nothing."""
    if rule == "paper":
        return torch.zeros((), dtype=torch.float32, device=device)
    return lap_scale * draws.laplace(t, device)


def run_mwem(Q, h, cfg: MWEMConfig, draws, index=None,
             ledger: Optional[PrivacyLedger] = None, device=None) -> MWEMResult:
    """Run (Fast-)MWEM for ``cfg.T`` iterations on one lane.

    Args:
      Q: (m, U) query matrix with entries in [0, 1] (array, tensor or
        `DenseWorkload`); moved to ``device`` if it is not there.
      h: (U,) true normalized histogram.
      cfg: engine configuration; ``mode="fast"`` requires ``index``.
      draws: the randomness — a `Draws` implementation, or a
        `torch.Generator` on ``device`` (wrapped in `TorchDraws`).
      index: a k-MIPS index over the complement-augmented queries on the
        same device (`repro_torch.mips`): ``query(v, k) -> (aug ids, raw
        scores)`` plus ``approx_margin`` and ``failure_mass``.
      device: ``None`` runs on ``cuda`` (raising if absent); pass
        ``"cpu"`` for the plain PyTorch path.
    """
    dev = resolve_device(device)
    W = as_workload(Q, dev)
    if W.device != dev:
        raise ValueError(f"Q is on {W.device}, the run on {dev}")
    h = torch.as_tensor(h, dtype=torch.float32, device=dev)
    m, U = W.m, W.U
    cal = _calibrate(cfg, m, U)
    c_idx = _check_fast_index(cfg, index)
    if cfg.mode == "fast" and index.device != dev:
        raise ValueError(f"index is on {index.device}, the run on {dev}")
    if isinstance(draws, torch.Generator):
        draws = TorchDraws(draws)

    res = MWEMResult(p_hat=None, final_error=float("nan"),
                     ledger=ledger if ledger is not None else PrivacyLedger())
    if cfg.mode == "fast":
        res.ledger.record_index_failure(getattr(index, "failure_mass", 1.0 / m))
    slack = cfg.margin_slack * cal.scale if cfg.margin_slack else 0.0
    timed = dev.type == "cuda"
    marks = []

    log_w = torch.zeros(U, dtype=torch.float32, device=dev)
    p = torch.softmax(log_w, dim=0)
    p_sum = torch.zeros(U, dtype=torch.float32, device=dev)
    sel_t = torch.empty(cfg.T, dtype=torch.int64, device=dev)
    n_scored_t = torch.empty(cfg.T, dtype=torch.int64, device=dev)

    def tail_scores(v):
        return lambda idx, active: gather_score(W.Q, v, idx, active) * cal.scale

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
        log_w, p, p_sum = mwem_step(log_w, p, p_sum, W.Q, sel, h, noise,
                                    rule=cfg.update_rule, eta=cal.eta)
        if timed:
            marks[-1][1].record()
        if cfg.eval_every and (t + 1) % cfg.eval_every == 0:
            res.errors.append((t + 1, float(max_error(W, h, p_sum / (t + 1)))))

    for _ in range(cfg.T):
        _record_iteration(res.ledger, cfg.mode, cfg.update_rule, cal, c_idx,
                          cfg.margin_slack)
    res.selected = sel_t.tolist()
    res.n_scored = n_scored_t.tolist()
    res.p_hat = p_sum / cfg.T
    res.final_error = float(max_error(W, h, res.p_hat))
    if timed:
        torch.cuda.synchronize(dev)
        res.iter_seconds = [a.elapsed_time(b) / 1e3 for a, b in marks]
    return res
