"""Adaptive marginal release: worst-approximated-marginal MWEM over a
factored workload, counterpart of `repro.core.adaptive`.

Each round privately selects the worst-approximated marginal (lazy EM
over the per-clique utilities ``u_c = max |marg_c(h − p)|``),
Laplace-measures that marginal's whole table, and updates the synthetic
histogram against every cell of it at once — one gather a domain point,
since a clique's cells partition the domain.

Privacy per round (sequential composition, `PrivacyLedger`):
  * selection: EM with Δu = 1/n at ``eps_em`` (log-space scale
    ``eps_em/(2Δu)``), charged as ``adaptive_em``;
  * measurement: one record moves two cells of a marginal by 1/n each, so
    the whole table has L1 sensitivity 2/n and per-cell Laplace noise
    ``2/(n·eps_meas)``, charged as ``adaptive_measure``.

Everything goes through `MarginalWorkload`'s factored primitives
(`clique_abs_err`, `cell_maps`, segment sums); no (m, U) table exists.
The loop runs on the workload's device; the draws come through the
`Draws` protocol (round ``t``'s selection draws and its vector Laplace
draw), so a test can feed it the reference's key chain.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch.core.accountant import PrivacyLedger, calibrate_eps0
from repro_torch.core.lazy_em import LazyEMResult, default_tail_cap, lazy_em
from repro_torch.core.queries import max_error
from repro_torch.core.rng import Draws, TorchDraws
from repro_torch.core.workload import MarginalWorkload
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class AdaptiveConfig:
    eps: float = 1.0
    delta: float = 1e-3
    T: int = 10
    n_records: Optional[int] = None   # dataset size n → sensitivities 1/n, 2/n
    measure_frac: float = 0.5         # ε₀ fraction spent on the measurement
    eta: Optional[float] = None       # MW step size; default √(ln U / T)
    k: Optional[int] = None           # lazy-EM top-k; default ⌈√n_cliques⌉
    tail_cap: Optional[int] = None


class AdaptiveResult(NamedTuple):
    p_hat: torch.Tensor          # (U,) released synthetic histogram
    selected: torch.Tensor       # (T,) chosen clique ids
    final_error: torch.Tensor    # max over the workload's queries
    clique_errors: torch.Tensor  # (T,) pre-update worst-clique |error|
    n_scored: int                # candidates the lazy oracle touched in all
    eps_spent: float
    delta_spent: float


def select_worst_marginal(draws: Draws, t: int, utilities: torch.Tensor,
                          scale: float, k: Optional[int] = None,
                          tail_cap: Optional[int] = None) -> LazyEMResult:
    """Lazy Gumbel EM over cliques with utilities ``u_c`` (the
    `MarginalWorkload.clique_abs_err` of the probe); ``scale`` is the EM
    log-space factor ``eps_em/(2Δu)``."""
    nc = utilities.shape[0]
    k = k or max(1, math.ceil(math.sqrt(nc)))
    return lazy_em(draws, t, utilities * scale, k=min(k, nc),
                   tail_cap=tail_cap or default_tail_cap(nc))


def _measure_marginal(W: MarginalWorkload, h: torch.Tensor, cm: torch.Tensor,
                      noise: torch.Tensor) -> torch.Tensor:
    """Noisy release of the selected clique's whole table, from its (U,)
    cell map ``cm`` and the realized (max_cells,) Laplace noise (pad cells
    noisy too — they multiply nothing downstream)."""
    tab = torch.zeros(W.max_cells, dtype=torch.float32, device=h.device)
    return tab.scatter_add_(0, cm, h) + noise


def _adaptive_update(log_w: torch.Tensor, cm: torch.Tensor,
                     meas: torch.Tensor, eta: float) -> torch.Tensor:
    """MW update of every cell of the selected clique in one pass:
    ``log_w += η·(meas − cur)[cm]`` with ``cur`` the clique's marginal of
    ``softmax(log_w)``, then renormalized by logsumexp."""
    p = torch.softmax(log_w, dim=0)
    cur = torch.zeros_like(meas).scatter_add_(0, cm, p)
    log_w = log_w + eta * (meas - cur)[cm]
    return log_w - torch.logsumexp(log_w, dim=0)


def run_adaptive_marginals(W: MarginalWorkload, h, cfg: AdaptiveConfig,
                           draws, ledger: Optional[PrivacyLedger] = None,
                           device=None) -> AdaptiveResult:
    """Worst-approximated-marginal MWEM over a factored workload: a host
    loop of ``cfg.T`` rounds, one marginal a round.

    Args:
      W: the `MarginalWorkload`, on ``device``.
      h: (U,) true normalized histogram.
      draws: a `Draws` implementation, or a `torch.Generator` on
        ``device`` (wrapped in `TorchDraws`).
      ledger: charged with two events a round (created if ``None``).
      device: ``None`` runs on ``cuda`` (raising if absent); ``"cpu"``
        runs the plain PyTorch path.
    """
    if not isinstance(W, MarginalWorkload):
        raise TypeError(f"run_adaptive_marginals needs a MarginalWorkload, "
                        f"got {type(W).__name__}")
    if cfg.n_records is None:
        raise ValueError("AdaptiveConfig.n_records (dataset size n) is required")
    dev = resolve_device(device)
    if W.device != dev:
        raise ValueError(f"workload is on {W.device}, the run on {dev}")
    if isinstance(draws, torch.Generator):
        draws = TorchDraws(draws)
    n = cfg.n_records
    eps0 = calibrate_eps0(cfg.eps, cfg.delta, cfg.T, scheme="mwem")
    eps_em = eps0 * (1.0 - cfg.measure_frac)
    eps_meas = eps0 * cfg.measure_frac
    scale = float(eps_em * n / 2.0)                    # eps_em / (2·(1/n))
    lap_scale = float((2.0 / n) / max(eps_meas, 1e-12))
    eta = float(cfg.eta if cfg.eta is not None
                else math.sqrt(math.log(W.U) / cfg.T))
    ledger = ledger if ledger is not None else PrivacyLedger()

    h = torch.as_tensor(h, dtype=torch.float32, device=dev)
    log_w = torch.full((W.U,), -math.log(W.U), dtype=torch.float32, device=dev)
    selected, cerrs, scored = [], [], 0
    for t in range(cfg.T):
        v = h - torch.softmax(log_w, dim=0)
        util = W.clique_abs_err(v)
        res = select_worst_marginal(draws, t, util, scale, k=cfg.k,
                                    tail_cap=cfg.tail_cap)
        sel = res.index
        cm = W.cell_maps(sel.reshape(1))[0].to(torch.int64)
        noise = lap_scale * draws.laplace_vector(t, W.max_cells, dev)
        meas = _measure_marginal(W, h, cm, noise)
        log_w = _adaptive_update(log_w, cm, meas, eta)
        ledger.record(eps_em, 0.0, "adaptive_em")
        ledger.record(eps_meas, 0.0, "adaptive_measure")
        selected.append(sel)
        cerrs.append(util[sel])
        scored += int(res.n_scored)

    p_hat = torch.softmax(log_w, dim=0)
    eps_spent, delta_spent = ledger.composed()
    return AdaptiveResult(
        p_hat=p_hat,
        selected=torch.stack(selected),
        final_error=max_error(W, h, p_hat),
        clique_errors=torch.stack(cerrs),
        n_scored=scored,
        eps_spent=float(eps_spent),
        delta_spent=float(delta_spent),
    )
