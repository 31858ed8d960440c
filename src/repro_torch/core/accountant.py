"""Privacy accounting (paper §B, Thm B.1) and budget calibration.

The ledger tracks every mechanism invocation and the extra failure mass the
index contributes (Thm 3.3 adds ``γ = 1/m`` to δ when the k-MIPS structure
may fail). Composition is reported three ways:

* basic:      (Σ ε_i, Σ δ_i)
* paper B.1:  ε̃ = ε√(2k ln 1/δ′) + 2kε²        (as printed in the paper)
* tight B.1:  ε̃ = ε√(2k ln 1/δ′) + kε(e^ε − 1)  (Dwork-Rothblum-Vadhan)

and the calibration helpers invert the paper's per-iteration formulas
(Alg. 1: ε₀ = ε/√(T ln 1/δ); Alg. 3: ε₀ = ε/√(8T log 1/δ)).

Pure Python, kept as the port's own copy of `repro.core.accountant` so the
port never imports the JAX package. It leaves out the fault-injection site
on `commit`: fault injection arrives with the serving slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


def advanced_composition(
    eps0: float, delta0: float, k: int, delta_prime: float, tight: bool = False
) -> tuple[float, float]:
    """Compose k adaptive (ε₀, δ₀)-DP mechanisms (Thm B.1)."""
    if k == 0:
        return 0.0, 0.0
    head = eps0 * math.sqrt(2.0 * k * math.log(1.0 / delta_prime))
    tail = k * eps0 * (math.expm1(eps0)) if tight else 2.0 * k * eps0 * eps0
    return head + tail, k * delta0 + delta_prime


def calibrate_eps0(eps: float, delta: float, T: int, scheme: str = "mwem") -> float:
    """Per-iteration budget from a global (ε, δ) target.

    ``scheme="mwem"`` follows Alg. 1/2: ε₀ = ε / √(T ln(1/δ)).
    ``scheme="lp"`` follows Alg. 3:     ε₀ = ε / √(8 T log(1/δ)).
    """
    if scheme == "mwem":
        return eps / math.sqrt(T * math.log(1.0 / delta))
    if scheme == "lp":
        return eps / math.sqrt(8.0 * T * math.log(1.0 / delta))
    raise ValueError(f"unknown scheme {scheme!r}")


@dataclass
class PrivacyLedger:
    """Append-only record of privacy events for one end-to-end run.

    Two-phase budget commit (DESIGN.md §10): a serving tier that charges
    budget *at dispatch* cannot survive a crash — an exception between the
    charge and the answer either leaks ε (charged, nothing released) or
    invites a double charge on retry. `reserve` holds a release's exact
    cost bundle against the ledger without touching the composed state;
    `commit` applies it through the very same `record_events` path a direct
    charge would take (bitwise-equal ledger state in both composition
    modes), and `abort` refunds it. Outstanding reservations are visible to
    admission via `reserved_bundle` so queued-but-unexecuted requests still
    count against the budget — but they survive any crash of the code that
    queued them, because they live here, not in a transient queue.
    """

    target_delta_prime: float = 1e-9
    events: list = field(default_factory=list)
    index_failure_mass: float = 0.0  # γ: P[k-MIPS structure answers wrongly]
    approx_slack: float = 0.0        # Σ 2c from runtime-preserving approx top-k (Thm F.2)
    # observers called with (self) after every mutating record — the obs
    # layer hangs per-tenant ε/δ-spent gauges here. Excluded from repr/eq
    # so ledgers still compare by their privacy state alone.
    hooks: list = field(default_factory=list, repr=False, compare=False)
    # rid -> (events, gamma, slack) bundles reserved but not yet committed.
    # Excluded from eq: a recovered ledger has resolved every reservation,
    # and equality means "same composed privacy state".
    reservations: dict = field(default_factory=dict, repr=False, compare=False)
    _next_rid: int = field(default=0, repr=False, compare=False)

    def add_hook(self, fn) -> None:
        """Register ``fn(ledger)`` to fire after every mutating record."""
        self.hooks.append(fn)

    def _notify(self) -> None:
        for fn in self.hooks:
            fn(self)

    # ------------------------------------------------- two-phase commit
    @property
    def next_rid(self) -> int:
        """The id the next `reserve` will hand out. Journal recovery needs
        it: rids key WAL records, so a recovered ledger must never re-issue
        an id the pre-crash process already journaled."""
        return self._next_rid

    def advance_rid(self, next_rid: int) -> None:
        """Fast-forward the reservation-id counter to at least ``next_rid``
        (never backward). Called by `journal.recover`/`ReleaseService.adopt`
        so post-recovery reservations cannot collide with a pre-crash rid
        still referenced by the WAL — a reused rid would let a later
        ``committed``/``aborted`` record resolve the *wrong* reservation on
        the next replay."""
        self._next_rid = max(self._next_rid, int(next_rid))

    def reserve(self, events, gamma: float = 0.0, slack: float = 0.0) -> int:
        """Phase one: hold a cost bundle against this ledger.

        Nothing is spent — `composed()` is unchanged and hooks do NOT fire
        (the budget gauges report committed spend only). Returns a
        reservation id for `commit`/`abort`.
        """
        rid = self._next_rid
        self._next_rid += 1
        self.reservations[rid] = (
            [(e0, d0, label) for e0, d0, label in events],
            float(gamma), float(slack))
        return rid

    def commit(self, rid: int) -> None:
        """Phase two: apply a reserved bundle to the ledger.

        Routes through `record_events`, so reserve→commit leaves the ledger
        bitwise equal to a direct `record_events` of the same bundle (and
        hooks fire here, exactly once)."""
        try:
            bundle = self.reservations.pop(rid)
        except KeyError:
            raise KeyError(f"unknown or already-resolved reservation {rid}")
        self.record_events(*bundle)

    def abort(self, rid: int) -> None:
        """Drop a reservation — the refund path (expired deadline, failed
        wave, shed load). A no-op on the composed state; hooks don't fire."""
        try:
            del self.reservations[rid]
        except KeyError:
            raise KeyError(f"unknown or already-resolved reservation {rid}")

    def reserved_bundle(self) -> tuple[list, float, float]:
        """Aggregate ``(events, γ, Σ2c)`` over all outstanding reservations
        — the admission controller's ``reserved=`` input, so queued
        requests count against the budget until committed or aborted."""
        events: list = []
        gamma = slack = 0.0
        for ev, g, s in self.reservations.values():
            events.extend(ev)
            gamma += g
            slack += s
        return events, gamma, slack

    def record(self, eps0: float, delta0: float = 0.0, label: str = "") -> None:
        self.events.append((eps0, delta0, label))
        self._notify()

    def record_index_failure(self, gamma: float) -> None:
        """Thm 3.3: an imperfect index adds γ to the δ of the whole run."""
        self.index_failure_mass += gamma
        self._notify()

    def record_approx_slack(self, c: float) -> None:
        """Thm F.2: a c-approximate top-k costs +2c in ε for that invocation."""
        self.approx_slack += 2.0 * c
        self._notify()

    def record_events(self, events, gamma: float = 0.0, slack: float = 0.0) -> None:
        """Append a pre-computed cost bundle (the admitted counterpart of
        `preview`): raw events, index failure mass γ, and *already-doubled*
        approx slack Σ2c."""
        self.events.extend((e0, d0, label) for e0, d0, label in events)
        self.index_failure_mass += gamma
        self.approx_slack += slack
        self._notify()

    def bundle(self) -> tuple[list, float, float]:
        """Snapshot of the ledger's raw cost state ``(events, γ, Σ2c)`` —
        the triple `record_events`/`preview` consume, so a bundle taken
        here can be replayed into a scratch ledger (marginal-cost
        accounting) or held as a reservation (admission control)."""
        return list(self.events), self.index_failure_mass, self.approx_slack

    def composed(self, tight: bool = False) -> tuple[float, float]:
        """Total (ε, δ) over all events, plus index failure mass and slack.

        Events are grouped by their ε₀ (homogeneous composition within each
        group, basic composition across groups — a safe upper bound).
        """
        return self.preview(tight=tight)

    def preview(
        self,
        events=(),
        gamma: float = 0.0,
        slack: float = 0.0,
        tight: bool = False,
    ) -> tuple[float, float]:
        """Composed (ε, δ) if ``events`` (plus ``gamma`` failure mass and
        ``slack`` approx-ε) were appended — without mutating the ledger.

        This is the admission-control primitive: a release's cost is a list
        of (ε₀, δ₀, label) events (see `repro_torch.core.mwem.release_cost`), and
        the service asks "what would this ledger compose to with them?"
        before spending anything.
        """
        groups: dict[tuple[float, float], int] = {}
        for e0, d0, _ in list(self.events) + list(events):
            groups[(e0, d0)] = groups.get((e0, d0), 0) + 1
        eps_total, delta_total = 0.0, 0.0
        for (e0, d0), k in groups.items():
            e, d = advanced_composition(e0, d0, k, self.target_delta_prime, tight)
            eps_total += e
            delta_total += d
        return (eps_total + self.approx_slack + slack,
                delta_total + self.index_failure_mass + gamma)

    def remaining(
        self, eps_target: float, delta_target: float, tight: bool = False
    ) -> tuple[float, float]:
        """Unspent (ε, δ) against a global budget: target − composed().

        Negative components mean the ledger has already overshot the budget
        (possible because advanced composition is superadditive across
        heterogeneous event groups).
        """
        eps, delta = self.composed(tight=tight)
        return eps_target - eps, delta_target - delta

    def would_exceed(
        self,
        eps_target: float,
        delta_target: float,
        events=(),
        gamma: float = 0.0,
        slack: float = 0.0,
        tight: bool = False,
    ) -> bool:
        """True iff appending ``events``/``gamma``/``slack`` would push the
        composed totals past (eps_target, delta_target)."""
        eps, delta = self.preview(events, gamma, slack, tight=tight)
        return eps > eps_target or delta > delta_target

    def basic(self) -> tuple[float, float]:
        eps = sum(e for e, _, _ in self.events) + self.approx_slack
        delta = sum(d for _, d, _ in self.events) + self.index_failure_mass
        return eps, delta
