"""The port's core (accounting, Gumbel math, EM, lazy EM, queries) held to
`repro` on the same inputs, plus the package boundary.

`JaxDraws` — the draw protocol walked along the reference's key chain —
lives here, in the tests, and never in the package: with it the port makes
the very draws `repro` makes, and is compared result for result.
"""

import ast
import importlib
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mwem import split_chain
from repro.core.queries import max_error as ref_max_error

from repro_torch.core import accountant as acc
from repro_torch.core import em, gumbel, lazy_em
from repro_torch.core.queries import (gaussian_histogram, max_error,
                                      random_binary_queries)
from repro_torch.core.rng import TorchDraws

# `repro.core` re-exports functions under these modules' names
ref_acc = importlib.import_module("repro.core.accountant")
ref_em = importlib.import_module("repro.core.em")
ref_gumbel = importlib.import_module("repro.core.gumbel")
ref_lazy = importlib.import_module("repro.core.lazy_em")

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


class JaxDraws:
    """`repro_torch.core.rng.Draws` from `repro`'s key chain.

    Iteration ``t`` uses ``sel_keys[t]`` exactly as the reference does:
    the 4-way split of `lazy_em_from_topk` (top-k Gumbels, binomial, tail
    randint, tail uniforms), the key itself for the exhaustive Gumbels,
    `lazy_em.fallback_key` of it for the overflow redo, and
    ``meas_keys[t]`` for the Laplace draw — a scalar for `run_mwem`, a
    ``(size,)`` vector for the table measurement of
    `run_adaptive_marginals`, whose rounds walk the same
    ``key → (key, k_sel, k_meas)`` chain. The binomial is drawn from the
    port's own ``p``.
    """

    def __init__(self, sel_keys, meas_keys=None):
        self.sel_keys = sel_keys
        self.meas_keys = meas_keys

    @classmethod
    def chain(cls, key, T: int) -> "JaxDraws":
        sel, meas = split_chain(key, T)
        return cls(sel, meas)

    def _split(self, t):
        return jax.random.split(self.sel_keys[t], 4)

    def topk_gumbel(self, t, k, device):
        return _t(jax.random.gumbel(self._split(t)[0], (k,))).to(device)

    def tail_count(self, t, trials, p):
        c = jax.random.binomial(self._split(t)[1], trials,
                                jnp.float32(float(p)))
        return torch.tensor(int(c), dtype=torch.int64, device=p.device)

    def tail_randint(self, t, size, high, device):
        u = jax.random.randint(self._split(t)[2], (size,), 0, high)
        return _t(u, torch.int64).to(device)

    def tail_uniform(self, t, size, device):
        return _t(jax.random.uniform(self._split(t)[3], (size,),
                                     jnp.float32)).to(device)

    def exhaustive_gumbel(self, t, n, device):
        return _t(jax.random.gumbel(self.sel_keys[t], (n,))).to(device)

    def fallback_gumbel(self, t, n, device):
        key = ref_lazy.fallback_key(self.sel_keys[t])
        return _t(jax.random.gumbel(key, (n,))).to(device)

    def laplace(self, t, device):
        return _t(jax.random.laplace(self.meas_keys[t])).to(device)

    def laplace_vector(self, t, size, device):
        return _t(jax.random.laplace(self.meas_keys[t], (size,))).to(device)


# --------------------------------------------------------------- accountant

EVENT_LISTS = [
    [],
    [(0.01, 0.0, "em")] * 50,
    [(0.01, 0.0, "lazy_em"), (0.02, 1e-6, "laplace")] * 30,
    [(0.1, 0.0, "a"), (0.1, 0.0, "b"), (0.3, 1e-5, "c")],
]


class TestAccountant:
    @pytest.mark.parametrize("events", EVENT_LISTS)
    @pytest.mark.parametrize("tight", [False, True])
    def test_composed_matches_reference(self, events, tight):
        mine, ref = acc.PrivacyLedger(), ref_acc.PrivacyLedger()
        for led in (mine, ref):
            for e in events:
                led.record(*e)
            led.record_index_failure(1e-4)
            led.record_approx_slack(0.05)
        assert mine.composed(tight=tight) == ref.composed(tight=tight)
        assert mine.basic() == ref.basic()
        extra = [(0.5, 1e-7, "x")]
        assert (mine.preview(extra, 1e-3, 0.1, tight=tight)
                == ref.preview(extra, 1e-3, 0.1, tight=tight))

    @pytest.mark.parametrize("scheme", ["mwem", "lp"])
    def test_calibration_matches_reference(self, scheme):
        for eps, delta, T in [(1.0, 1e-3, 100), (0.5, 1e-6, 1000)]:
            assert (acc.calibrate_eps0(eps, delta, T, scheme)
                    == ref_acc.calibrate_eps0(eps, delta, T, scheme))
        for tight in (False, True):
            assert (acc.advanced_composition(0.01, 1e-6, 300, 1e-9, tight)
                    == ref_acc.advanced_composition(0.01, 1e-6, 300, 1e-9, tight))

    def test_reserve_commit_abort(self):
        mine, ref = acc.PrivacyLedger(), ref_acc.PrivacyLedger()
        bundle = ([(0.02, 0.0, "em")] * 5, 1e-4, 0.01)
        for led in (mine, ref):
            rid = led.reserve(*bundle)
            led.abort(led.reserve(*bundle))
            led.commit(rid)
        assert mine.events == ref.events
        assert mine.composed() == ref.composed()
        assert mine.reservations == {}
        with pytest.raises(KeyError):
            mine.commit(0)


# ------------------------------------------------------------ gumbel and EM

class TestGumbel:
    def test_tail_prob_matches_reference(self):
        B = np.array([-5.0, -1.0, 0.0, 0.5, 3.0, 20.0, 80.0, np.inf],
                     np.float32)
        np.testing.assert_allclose(
            gumbel.tail_prob(_t(B)).numpy(),
            np.asarray(ref_gumbel.tail_prob(jnp.asarray(B))), rtol=1e-6)

    def test_truncated_gumbel_matches_reference(self):
        key = jax.random.PRNGKey(3)
        for B in (-2.0, 0.0, 4.0, 30.0):
            ref = ref_gumbel.truncated_gumbel(key, (64,), jnp.float32(B))
            u = jax.random.uniform(key, (64,), jnp.float32)
            mine = gumbel.truncated_gumbel(_t(u), torch.tensor(B))
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-6)
            assert bool((mine > B).all())

    def test_exact_em_matches_reference(self):
        rng = np.random.default_rng(0)
        for seed in range(5):
            u = rng.standard_normal(300).astype(np.float32)
            key = jax.random.PRNGKey(seed)
            ref = int(ref_em.exact_em(key, jnp.asarray(u), 2.0, 0.01))
            g = jax.random.gumbel(key, (300,))
            assert int(em.exact_em(_t(g), _t(u), 2.0, 0.01)) == ref


# ------------------------------------------------------------------ lazy EM

class TestLazyEM:
    def test_default_tail_cap(self):
        for n in (10, 100, 5000, 2**17):
            assert lazy_em.default_tail_cap(n) == ref_lazy.default_tail_cap(n)

    @pytest.mark.parametrize("seed", range(6))
    def test_draw_distinct_tail_matches_reference(self, seed):
        rng = np.random.default_rng(seed)
        n, k, cap = 200, 14, 60
        topk = rng.choice(n, k, replace=False).astype(np.int32)
        C = int(rng.integers(0, 70))
        key = jax.random.PRNGKey(seed)
        r_idx, r_act, r_over = ref_lazy.draw_distinct_tail(
            key, jnp.asarray(topk), n, cap, jnp.int32(C))
        draws = JaxDraws(sel_keys=None)
        draws.tail_randint = lambda t, size, high, device: _t(
            jax.random.randint(key, (size,), 0, high), torch.int64)
        idx, act, over = lazy_em.draw_distinct_tail(
            draws, 0, _t(topk), n, cap, torch.tensor(C))
        assert np.array_equal(idx.numpy(), np.asarray(r_idx))
        assert np.array_equal(act.numpy(), np.asarray(r_act))
        assert bool(over) == bool(r_over)
        assert not np.isin(idx.numpy()[act.numpy()], topk).any()

    @pytest.mark.parametrize("seed", range(10))
    @pytest.mark.parametrize("slack", [0.0, 0.5])
    def test_matches_reference_draw_for_draw(self, seed, slack):
        """Given the reference's draws the port returns the same index,
        n_scored, tail_count, margin and overflow."""
        rng = np.random.default_rng(100 + seed)
        n, k = 400, 20
        scores = (rng.standard_normal(n) * 1.5).astype(np.float32)
        key = jax.random.PRNGKey(seed)
        cap = 16 if seed % 3 == 0 else 80  # small buffers overflow
        ref = ref_lazy.lazy_em(key, jnp.asarray(scores), k, tail_cap=cap,
                               margin_slack=slack)
        mine = lazy_em.lazy_em(JaxDraws(sel_keys=[key]), 0, _t(scores), k,
                               tail_cap=cap, margin_slack=slack)
        assert int(mine.index) == int(ref.index)
        assert int(mine.n_scored) == int(ref.n_scored)
        assert int(mine.tail_count) == int(ref.tail_count)
        assert bool(mine.overflow) == bool(ref.overflow)
        np.testing.assert_allclose(float(mine.margin), float(ref.margin),
                                   rtol=1e-6)

    def test_production_draws_follow_softmax(self):
        """χ² selection frequencies of lazy EM on `TorchDraws` against the
        EM's softmax law (the reference's statistical test, on the port's
        own Philox stream)."""
        rng = np.random.default_rng(7)
        n, k, trials = 40, 7, 4000
        scores = torch.as_tensor(rng.standard_normal(n).astype(np.float32))
        draws = TorchDraws.seeded(11, CPU)
        counts = np.zeros(n)
        for t in range(trials):
            out = lazy_em.lazy_em(draws, t, scores, k, tail_cap=n)
            assert not bool(out.overflow)
            counts[int(out.index)] += 1
        p = torch.softmax(scores.double(), 0).numpy()
        expected = trials * p
        keep = expected >= 5
        chi2 = (((counts - expected) ** 2 / expected)[keep].sum()
                + (counts[~keep].sum() - expected[~keep].sum()) ** 2
                / max(expected[~keep].sum(), 1e-9))
        dof = int(keep.sum())
        # 99.9% quantile of χ²(dof) by the Wilson–Hilferty approximation
        z = 3.09
        limit = dof * (1 - 2 / (9 * dof) + z * math.sqrt(2 / (9 * dof))) ** 3
        assert chi2 < limit, (chi2, limit)

    def test_torch_draws_shapes(self):
        d = TorchDraws.seeded(0, CPU)
        assert d.topk_gumbel(0, 5, CPU).shape == (5,)
        c = d.tail_count(0, 1000, torch.tensor(0.01))
        assert c.dtype == torch.int64 and 0 <= int(c) <= 1000
        r = d.tail_randint(0, 50, 7, CPU)
        assert r.dtype == torch.int64 and int(r.min()) >= 0 and int(r.max()) < 7
        u = d.tail_uniform(0, 50, CPU)
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
        lap = torch.stack([d.laplace(0, CPU) for _ in range(4000)])
        assert torch.isfinite(lap).all()
        assert abs(float(lap.mean())) < 0.1 and abs(float(lap.var()) - 2) < 0.3
        lap = d.laplace_vector(0, 4000, CPU)
        assert lap.shape == (4000,) and torch.isfinite(lap).all()
        assert abs(float(lap.mean())) < 0.1 and abs(float(lap.var()) - 2) < 0.3


# ------------------------------------------------------------------ queries

class TestQueries:
    def test_max_error_matches_reference(self):
        rng = np.random.default_rng(1)
        Q = (rng.random((50, 32)) < 0.3).astype(np.float32)
        h = rng.dirichlet(np.ones(32)).astype(np.float32)
        p = rng.dirichlet(np.ones(32)).astype(np.float32)
        ref = float(ref_max_error(jnp.asarray(Q), jnp.asarray(h), jnp.asarray(p)))
        assert float(max_error(_t(Q), _t(h), _t(p))) == pytest.approx(ref, rel=1e-6)

    def test_generators_follow_section_5_1(self):
        rng = np.random.default_rng(2)
        h = gaussian_histogram(rng, 5000, 300)
        assert h.shape == (300,) and h.dtype == np.float32
        assert abs(float(h.sum()) - 1.0) < 1e-5
        mean = float((np.arange(300) * h).sum())
        assert abs(mean - 100.0) < 2.0  # N(U/3, U/15)
        Q = random_binary_queries(rng, 64, 400)
        assert Q.shape == (64, 400) and set(np.unique(Q)) <= {0.0, 1.0}
        assert (Q.sum(1) <= 100).all() and (Q.sum(1) > 50).all()


# ----------------------------------------------------------------- boundary

def _imports(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            mods.add(node.module.split(".")[0])
    return mods


class TestBoundary:
    def test_package_imports_no_jax_repro_or_time(self):
        files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
        assert files
        for path in files:
            bad = _imports(path) & {"jax", "jaxlib", "repro", "time"}
            assert not bad, f"{path.relative_to(REPO)} imports {bad}"

    def test_chip_smoke_imports_no_jax_or_repro(self):
        assert not _imports(REPO / "chip_smoke.py") & {"jax", "jaxlib", "repro"}

    def test_timing_lint_is_clean(self):
        out = subprocess.run([sys.executable,
                              str(REPO / "tools" / "check_timing_lint.py")],
                             capture_output=True, text=True)
        assert out.returncode == 0, out.stdout + out.stderr

    def test_package_imports_without_jax(self):
        code = ("import sys; sys.modules['jax'] = None; "
                "import repro_torch.core, repro_torch.mips, repro_torch.convert, "
                "repro_torch.core.adaptive, repro_torch.core.workload, "
                "repro_torch.mips.marginal, "
                "repro_torch.kernels.mips_topk, repro_torch.kernels.ivf_probe, "
                "repro_torch.kernels.mwem_step; "
                "assert not any(m == 'repro' or m.startswith('repro.') "
                "for m in sys.modules)")
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, env=env)
        assert out.returncode == 0, out.stderr

    def test_default_device_is_cuda(self):
        from repro_torch.device import resolve_device

        assert resolve_device("cpu") == CPU
        if torch.cuda.is_available():
            assert resolve_device().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                resolve_device()
