"""The private LP slice as a whole: the port's `solve_scalar_lp`,
`solve_lp_batch` and `solve_constraint_private_lp` against `repro`'s on
the same A, b, c and key chains (the port draws through
`JaxDraws.lp_chain`), in exact mode, fast mode over a flat and an IVF
index, with a margin slack, with a one-slot tail buffer that overflows,
and with an index that charges failure mass and approximation slack.

Each port run is held to both of the reference's drivers (its host loop
and its fused scan). Tolerances: selections, n_scored, overflow counts and
violation counts must be equal (at these sizes no winner is within float
noise of its runner-up); ``x_bar`` agrees to atol 1e-5; the ledgers are
equal event for event and equal the `lp_release_cost` preview. The port's
K7 update and Bregman projection are held on their own in
`test_torch_mwu.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_core import JaxDraws

import repro.core as ref_core
from repro.core.queries import random_feasible_lp as ref_feasible_lp
from repro.core.queries import random_packing_lp as ref_packing_lp
from repro.mips import FlatIndex as RefFlat
from repro.mips import IVFIndex as RefIVF
from repro.mips import lp_dual_rows as ref_dual_rows
from repro.mips import lp_scalar_rows as ref_scalar_rows

from repro_torch import convert
from repro_torch.core import (DualLPConfig, LaneDraws, PrivacyLedger,
                              ScalarLPConfig, finish_lp_batch,
                              launch_lp_batch, lp_release_cost,
                              solve_constraint_private_lp, solve_lp_batch,
                              solve_scalar_lp)
from repro_torch.core.queries import random_feasible_lp, random_packing_lp
from repro_torch.kernels.mwu_update import mwu_update
from repro_torch.mips import FlatIndex, lp_dual_rows, lp_scalar_rows

CPU = torch.device("cpu")
M, D, T = 512, 20, 30           # scalar LP
M2, D2 = 40, 64                 # dual LP: constraints, vertices
DUAL_S = 10


@pytest.fixture(scope="module", autouse=True)
def no_tf32():
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


@pytest.fixture(scope="module")
def scalar_lp():
    A, b, _ = ref_feasible_lp(jax.random.PRNGKey(0), m=M, d=D)
    A, b = np.asarray(A), np.asarray(b)
    return A, b, ref_scalar_rows(A, b)


def dual_opt(b, c) -> float:
    """An OPT level whose width ρ = OPT/c_min − b_max is b_max.

    The reference's tests and benchmark take OPT = ½·mean(c), under which
    ρ falls to its 1e-6 floor: the loss is ~1e6, ``exp(logY − max)``
    underflows, the projection's 1e-38 floor (a subnormal) is flushed to 0
    by XLA on the CPU and the reference's y turns NaN, after which it picks
    vertex 0 every step (ROADMAP.md, Queue 3). The port is compared where
    neither side is degenerate."""
    return 2.0 * float(np.min(c)) * float(np.max(b))


@pytest.fixture(scope="module")
def dual_lp():
    A, b, c = ref_packing_lp(jax.random.PRNGKey(4), m=M2, d=D2)
    A, b, c = np.asarray(A), np.asarray(b), np.asarray(c)
    opt = dual_opt(b, c)
    return A, b, c, opt, ref_dual_rows(A, c, opt)


def _index_pair(kind, rows, **ivf_kw):
    """(reference index, port index) over the same rows; the IVF build is
    carried across with `convert.ivf_index` (`from_tables`)."""
    if kind is None:
        return None, None
    if kind == "flat":
        return RefFlat(rows, use_pallas="never"), FlatIndex(rows, device=CPU)
    ref = RefIVF(rows, seed=0, train_iters=3, use_pallas="never", **ivf_kw)
    mine = convert.ivf_index(np.asarray(ref._v), np.asarray(ref._cents),
                             np.asarray(ref._cells), nprobe=ref.nprobe,
                             device=CPU, **ivf_kw)
    return ref, mine


def _assert_same_ledger(mine, ref, preview_of):
    assert mine.events == ref.events
    assert mine.index_failure_mass == ref.index_failure_mass
    assert mine.approx_slack == ref.approx_slack
    for tight in (False, True):
        assert mine.composed(tight) == ref.composed(tight)
        assert mine.composed(tight) == PrivacyLedger().preview(*preview_of,
                                                               tight=tight)


def _assert_same_run(mine, ref):
    assert mine.selected == [int(s) for s in ref.selected]
    assert mine.n_scored == [int(s) for s in ref.n_scored]
    assert mine.overflow_count == ref.overflow_count
    np.testing.assert_allclose(mine.x_bar.numpy(), np.asarray(ref.x_bar),
                               atol=1e-5)
    np.testing.assert_allclose(mine.violations.numpy(),
                               np.asarray(ref.violations), atol=1e-5)
    assert mine.iter_seconds == []  # no clock on the CPU


SCALAR_CASES = [  # (mode, index kind, margin_slack, tail_cap)
    ("exact", None, 0.0, None), ("fast", "flat", 0.0, None),
    ("fast", "flat", 0.05, None), ("fast", "ivf", 0.0, None),
    ("fast", "ivf", 0.05, None), ("fast", "flat", 0.0, 1),
    ("fast", "ivf", 0.0, 1),
]


class TestScalar:
    @pytest.mark.parametrize("mode,kind,slack,cap", SCALAR_CASES)
    def test_matches_both_reference_drivers(self, scalar_lp, mode, kind, slack,
                                            cap):
        A, b, rows = scalar_lp
        ref_index, index = _index_pair(kind, rows)
        kw = dict(T=T, mode=mode, margin_slack=slack, tail_cap=cap)
        mine = solve_scalar_lp(A, b, ScalarLPConfig(**kw),
                               JaxDraws.lp_chain(jax.random.PRNGKey(1), T),
                               index=index, device=CPU)
        if cap == 1:
            assert mine.overflow_count > T // 2
        for driver in ("host", "fused"):
            ref = ref_core.solve_scalar_lp(
                A, b, ref_core.ScalarLPConfig(driver=driver, **kw),
                jax.random.PRNGKey(1), index=ref_index)
            _assert_same_run(mine, ref)
            assert mine.violated_frac == ref.violated_frac
            _assert_same_ledger(mine.ledger, ref.ledger, lp_release_cost(
                ScalarLPConfig(**kw), A, index))

    def test_index_failure_and_slack_are_charged(self, scalar_lp):
        """An index that may fail (γ) and is c-approximate charges γ once
        and 2c an iteration, as the reference's ledger does."""
        A, b, rows = scalar_lp
        ref_index, index = _index_pair("ivf", rows, approx_margin=0.05,
                                       failure_mass=1e-4)
        mine = solve_scalar_lp(A, b, ScalarLPConfig(T=T),
                               JaxDraws.lp_chain(jax.random.PRNGKey(7), T),
                               index=index, device=CPU)
        ref = ref_core.solve_scalar_lp(A, b, ref_core.ScalarLPConfig(T=T),
                                       jax.random.PRNGKey(7), index=ref_index)
        _assert_same_run(mine, ref)
        assert mine.ledger.index_failure_mass == 1e-4
        assert mine.ledger.approx_slack == pytest.approx(2 * 0.05 * T)
        _assert_same_ledger(mine.ledger, ref.ledger, lp_release_cost(
            ScalarLPConfig(T=T), A, index))

    def test_caller_ledger_is_charged(self, scalar_lp):
        A, b, rows = scalar_lp
        led = PrivacyLedger()
        res = solve_scalar_lp(A, b, ScalarLPConfig(T=5, mode="exact"),
                              JaxDraws.lp_chain(jax.random.PRNGKey(8), 5),
                              ledger=led, device=CPU)
        assert res.ledger is led and len(led.events) == 5

    def test_fast_is_sublinear(self, scalar_lp):
        A, b, rows = scalar_lp
        res = solve_scalar_lp(A, b, ScalarLPConfig(T=T),
                              JaxDraws.lp_chain(jax.random.PRNGKey(2), T),
                              index=FlatIndex(rows, device=CPU), device=CPU)
        assert res.overflow_count == 0
        assert np.mean(res.n_scored) < M * 0.9

    def test_errors(self, scalar_lp):
        A, b, rows = scalar_lp
        draws = JaxDraws.lp_chain(jax.random.PRNGKey(0), 3)
        with pytest.raises(ValueError, match="index"):
            solve_scalar_lp(A, b, ScalarLPConfig(T=3), draws, device=CPU)
        with pytest.raises(ValueError, match="mode"):
            solve_scalar_lp(A, b, ScalarLPConfig(T=3, mode="greedy"), draws,
                            device=CPU)
        with pytest.raises(ValueError, match="per-lane"):
            solve_scalar_lp(A, np.stack([b, b]), ScalarLPConfig(T=3), draws,
                            device=CPU)


DUAL_CASES = [  # (mode, index kind, margin_slack, tail_cap)
    ("exact", None, 0.0, None), ("fast", "flat", 0.0, None),
    ("fast", "flat", 0.05, None), ("fast", "ivf", 0.0, None),
    ("fast", "ivf", 0.05, None), ("fast", "flat", 0.0, 1),
]


class TestDual:
    @pytest.mark.parametrize("mode,kind,slack,cap", DUAL_CASES)
    def test_matches_both_reference_drivers(self, dual_lp, mode, kind, slack,
                                            cap):
        A, b, c, opt, rows = dual_lp
        ref_index, index = _index_pair(kind, rows)
        kw = dict(T=T, s=DUAL_S, mode=mode, margin_slack=slack, tail_cap=cap)
        mine = solve_constraint_private_lp(
            A, b, c, opt, DualLPConfig(**kw),
            JaxDraws.lp_chain(jax.random.PRNGKey(5), T), index=index,
            device=CPU)
        if cap == 1:
            assert mine.overflow_count > 0
        for driver in ("host", "fused"):
            ref = ref_core.solve_constraint_private_lp(
                *map(jnp.asarray, (A, b, c)), opt,
                ref_core.DualLPConfig(driver=driver, **kw),
                jax.random.PRNGKey(5), index=ref_index)
            _assert_same_run(mine, ref)
            assert mine.n_violated == ref.n_violated
            _assert_same_ledger(mine.ledger, ref.ledger, lp_release_cost(
                DualLPConfig(**kw), A, index))

    def test_solution_in_k_opt(self, dual_lp):
        """Every iterate is a K_OPT vertex: c^T x̄ = OPT."""
        A, b, c, opt, rows = dual_lp
        res = solve_constraint_private_lp(
            A, b, c, opt, DualLPConfig(T=T, s=DUAL_S),
            JaxDraws.lp_chain(jax.random.PRNGKey(6), T),
            index=FlatIndex(rows, device=CPU), device=CPU)
        assert float(res.x_bar @ torch.from_numpy(c)) == pytest.approx(opt,
                                                                      rel=1e-5)

    def test_index_failure_is_charged(self, dual_lp):
        A, b, c, opt, rows = dual_lp
        ref_index, index = _index_pair("ivf", rows, approx_margin=0.02,
                                       failure_mass=1e-3)
        cfg = DualLPConfig(T=T, s=DUAL_S)
        mine = solve_constraint_private_lp(
            A, b, c, opt, cfg, JaxDraws.lp_chain(jax.random.PRNGKey(9), T),
            index=index, device=CPU)
        ref = ref_core.solve_constraint_private_lp(
            *map(jnp.asarray, (A, b, c)), opt,
            ref_core.DualLPConfig(T=T, s=DUAL_S),
            jax.random.PRNGKey(9), index=ref_index)
        _assert_same_run(mine, ref)
        _assert_same_ledger(mine.ledger, ref.ledger,
                            lp_release_cost(cfg, A, index))
        assert mine.ledger.index_failure_mass == 1e-3


B = 3


def _lane_keys(seed):
    return [jax.random.PRNGKey(seed + i) for i in range(B)]


class TestBatch:
    @pytest.mark.parametrize("mode,kind", [("exact", None), ("fast", "flat"),
                                           ("fast", "ivf")])
    def test_lanes_match_single_and_reference(self, scalar_lp, mode, kind):
        A, b, rows = scalar_lp
        ref_index, index = _index_pair(kind, rows)
        cfg = ScalarLPConfig(T=T, mode=mode)
        keys = _lane_keys(20)
        ledgers = [PrivacyLedger() for _ in range(B)]
        wave = solve_lp_batch(A, b, cfg,
                              [JaxDraws.lp_chain(k, T) for k in keys],
                              index=index, ledgers=ledgers, device=CPU)
        ref = ref_core.solve_lp_batch(A, b, ref_core.ScalarLPConfig(
            T=T, mode=mode), jnp.stack(keys), index=ref_index)
        np.testing.assert_array_equal(wave.selected, np.asarray(ref.selected))
        np.testing.assert_array_equal(wave.n_scored, np.asarray(ref.n_scored))
        np.testing.assert_array_equal(wave.overflow_counts,
                                      np.asarray(ref.overflow_counts))
        np.testing.assert_allclose(wave.x_bar.numpy(), np.asarray(ref.x_bar),
                                   atol=1e-5)
        np.testing.assert_array_equal(wave.violated_fracs,
                                      np.asarray(ref.violated_fracs))
        assert wave.total_seconds == 0.0
        preview = lp_release_cost(cfg, A, index)
        _assert_same_ledger(wave.ledger, ref.ledger, preview)
        for led in ledgers:
            assert led.composed() == PrivacyLedger().preview(*preview)
        for lane, key in enumerate(keys):
            one = solve_scalar_lp(A, b, cfg, JaxDraws.lp_chain(key, T),
                                  index=index, device=CPU)
            assert one.selected == wave.selected[lane].tolist()
            assert one.n_scored == wave.n_scored[lane].tolist()
            torch.testing.assert_close(one.x_bar, wave.x_bar[lane], rtol=0,
                                       atol=1e-6)

    def test_per_lane_b_exact(self, scalar_lp):
        A, b, _ = scalar_lp
        rng = np.random.default_rng(3)
        bb = np.stack([b + 0.05 * rng.standard_normal(M).astype(np.float32)
                       for _ in range(B)])
        cfg = ScalarLPConfig(T=T, mode="exact")
        keys = _lane_keys(40)
        wave = solve_lp_batch(A, bb, cfg,
                              [JaxDraws.lp_chain(k, T) for k in keys],
                              device=CPU)
        ref = ref_core.solve_lp_batch(A, bb, ref_core.ScalarLPConfig(
            T=T, mode="exact"), jnp.stack(keys))
        np.testing.assert_array_equal(wave.selected, np.asarray(ref.selected))
        np.testing.assert_allclose(wave.x_bar.numpy(), np.asarray(ref.x_bar),
                                   atol=1e-5)
        np.testing.assert_array_equal(wave.violated_fracs,
                                      np.asarray(ref.violated_fracs))
        for lane, key in enumerate(keys):
            one = solve_scalar_lp(A, bb[lane], cfg, JaxDraws.lp_chain(key, T),
                                  device=CPU)
            assert one.selected == wave.selected[lane].tolist()

    def test_per_lane_b_fast_raises(self, scalar_lp):
        A, b, rows = scalar_lp
        draws = [JaxDraws.lp_chain(k, 3) for k in _lane_keys(0)]
        with pytest.raises(ValueError, match="mode='exact'"):
            solve_lp_batch(A, np.stack([b] * B), ScalarLPConfig(T=3), draws,
                           index=FlatIndex(rows, device=CPU), device=CPU)
        with pytest.raises(ValueError, match="ledgers"):
            solve_lp_batch(A, b, ScalarLPConfig(T=3, mode="exact"), draws,
                           ledgers=[PrivacyLedger()], device=CPU)

    def test_launch_finish_split_and_k7_count(self, scalar_lp):
        """`solve_lp_batch` is `finish(launch(...))`; on the CPU the plain
        version runs and K7's launch count stays put."""
        A, b, _ = scalar_lp
        before = mwu_update.launches
        cfg = ScalarLPConfig(T=5, mode="exact")
        keys = _lane_keys(60)
        pending = launch_lp_batch(A, b, cfg,
                                  LaneDraws([JaxDraws.lp_chain(k, 5)
                                             for k in keys]), device=CPU)
        res = finish_lp_batch(pending)
        whole = solve_lp_batch(A, b, cfg, [JaxDraws.lp_chain(k, 5)
                                           for k in keys], device=CPU)
        np.testing.assert_array_equal(res.selected, whole.selected)
        assert torch.equal(res.x_bar, whole.x_bar)
        assert mwu_update.launches == before


class TestPieces:
    def test_rows_match_reference(self, scalar_lp, dual_lp):
        A, b, rows = scalar_lp
        np.testing.assert_array_equal(lp_scalar_rows(A, b), np.asarray(rows))
        A2, _, c, opt, rows2 = dual_lp
        np.testing.assert_array_equal(lp_dual_rows(A2, c, opt),
                                      np.asarray(rows2))

    @pytest.mark.parametrize("k", [1, 7, 23])
    def test_flat_index_matches_reference(self, scalar_lp, k):
        _, _, rows = scalar_lp
        rng = np.random.default_rng(k)
        v = rng.standard_normal(D + 1).astype(np.float32)
        ids, s = FlatIndex(rows, device=CPU).query(torch.from_numpy(v), k)
        ref_ids, ref_s = RefFlat(rows, use_pallas="never").query(v, k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
        np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=1e-6,
                                   atol=1e-6)
        index = FlatIndex(rows, device=CPU)
        assert (index.approx_margin, index.failure_mass) == (0.0, 0.0)
        assert index.query_cost(k) == M

    def test_instance_makers(self):
        rng = np.random.default_rng(0)
        A, b, x_star = random_feasible_lp(rng, 64, 8)
        assert A.shape == (64, 8) and b.shape == (64,) and A.dtype == np.float32
        assert x_star.sum() == pytest.approx(1.0, abs=1e-5)
        assert (A @ x_star <= b + 1e-6).all()
        A, b, c = random_packing_lp(rng, 30, 12)
        assert A.shape == (30, 12) and c.shape == (12,) and b.shape == (30,)
        assert (A > 0).all() and (b > 0).all() and (c > 0).all()

    def test_release_cost_dispatch(self, scalar_lp, dual_lp):
        A, *_ = scalar_lp
        for cfg, ref_cfg, AA in (
                (ScalarLPConfig(T=7, mode="exact"),
                 ref_core.ScalarLPConfig(T=7, mode="exact"), A),
                (DualLPConfig(T=7, mode="exact"),
                 ref_core.DualLPConfig(T=7, mode="exact"), dual_lp[0])):
            assert lp_release_cost(cfg, AA) == ref_core.lp_release_cost(
                ref_cfg, AA)
        with pytest.raises(TypeError):
            lp_release_cost(object(), A)
