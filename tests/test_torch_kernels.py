"""The plain PyTorch versions of the port's four kernels held to `repro`'s
references on the same inputs, and the wrappers' dispatch rules.

The CUDA kernels themselves run only on the card: `chip_smoke.py` builds
them and holds each against these plain versions there. Tolerances: scores
and states are f32 sums taken in another order than XLA's, so they agree to
a few ulps (rtol 1e-5, atol 1e-6); ids are compared exactly where scores do
not tie.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.workload import DenseWorkload as RefDenseWorkload
from repro.kernels.ivf_probe.ref import ivf_probe_topk_ref
from repro.kernels.mips_topk.ops import mips_abs_topk
from repro.kernels.mips_topk.ref import mips_topk_ref as ref_mips_topk
from repro.kernels.mwem_step.ref import mwem_step_ref as ref_mwem_step

from repro_torch.kernels import _build
from repro_torch.kernels.ivf_probe import (ivf_probe_stream,
                                           ivf_probe_stream_ref, ivf_probe_topk)
from repro_torch.kernels.mips_topk import mips_topk, mips_topk_ref
from repro_torch.kernels.mwem_step import (UPDATE_RULES, gather_score,
                                           gather_score_ref, mwem_step,
                                           mwem_step_ref)

ref_mwem = importlib.import_module("repro.core.mwem")

RTOL, ATOL = 1e-5, 1e-6


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


# ---------------------------------------------------------------- K1 mips_topk

class TestMipsTopkRef:
    @pytest.mark.parametrize("n,d,k,seed", [(50, 16, 5, 0), (300, 70, 16, 1),
                                            (129, 33, 1, 2), (64, 8, 64, 3)])
    def test_plain_matches_reference(self, n, d, k, seed):
        rng = np.random.default_rng(seed)
        V = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal(d).astype(np.float32)
        i_r, s_r = ref_mips_topk(jnp.asarray(V), jnp.asarray(q), k)
        i_m, s_m = mips_topk_ref(_t(V), _t(q), k, "plain")
        np.testing.assert_array_equal(i_m.numpy(), np.asarray(i_r))
        np.testing.assert_allclose(s_m.numpy(), np.asarray(s_r), RTOL, ATOL)

    def test_abs_matches_reference(self):
        rng = np.random.default_rng(4)
        V = rng.standard_normal((90, 12)).astype(np.float32)
        q = rng.standard_normal(12).astype(np.float32)
        s = V @ q
        top_s, top_i = jax.lax.top_k(jnp.abs(jnp.asarray(s)), 9)
        i_m, s_m = mips_topk_ref(_t(V), _t(q), 9, "abs")
        np.testing.assert_array_equal(i_m.numpy(), np.asarray(top_i))
        np.testing.assert_allclose(s_m.numpy(), np.asarray(top_s), RTOL, ATOL)

    @pytest.mark.parametrize("n,d,k,seed", [(40, 16, 5, 0), (72, 24, 12, 1)])
    def test_aug_matches_reference_kernel(self, n, d, k, seed):
        """Against `repro`'s `mips_abs_topk` (its Pallas kernel in
        interpret mode), at tiny shapes."""
        rng = np.random.default_rng(seed)
        V = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal(d).astype(np.float32)
        i_r, s_r = mips_abs_topk(jnp.asarray(V), jnp.asarray(q), k,
                                 block_n=16, block_d=8)
        i_m, s_m = mips_topk_ref(_t(V), _t(q), k, "aug")
        np.testing.assert_array_equal(i_m.numpy(), np.asarray(i_r))
        np.testing.assert_allclose(s_m.numpy(), np.asarray(s_r), RTOL, ATOL)

    def test_plain_ties_go_to_lower_id(self):
        """Integer rows make equal scores the norm: the plain version must
        pick the ids `jax.lax.top_k` picks, in its order."""
        rng = np.random.default_rng(5)
        V = rng.integers(-2, 3, size=(200, 6)).astype(np.float32)
        q = rng.integers(-2, 3, size=6).astype(np.float32)
        for mode, score in (("plain", V @ q), ("abs", np.abs(V @ q))):
            _, top_i = jax.lax.top_k(jnp.asarray(score), 25)
            i_m, _ = mips_topk_ref(_t(V), _t(q), 25, mode)
            np.testing.assert_array_equal(i_m.numpy(), np.asarray(top_i))

    def test_aug_tie_order(self):
        """``aug`` ties: lower row first; +id j before −id j+n in one row.
        Held to the reference kernel up to the order among ties at the
        k-th score (its order there depends on its tile size)."""
        V = np.array([[1, 0], [0, 1], [1, 0], [0, 0], [2, 0]], np.float32)
        q = np.array([1.0, 0.0], np.float32)
        i_m, s_m = mips_topk_ref(_t(V), _t(q), 6, "aug")
        # scores +: [1, 0, 1, 0, 2]; −: [−1, −0, −1, −0, −2]
        assert i_m.tolist() == [4, 0, 2, 1, 6, 3]
        np.testing.assert_array_equal(s_m.numpy(), [2, 1, 1, 0, 0, 0])
        i_r, s_r = mips_abs_topk(jnp.asarray(V), jnp.asarray(q), 6,
                                 block_n=8, block_d=8)
        np.testing.assert_array_equal(s_m.numpy(), np.asarray(s_r))
        kth = float(s_m[-1])
        above = s_m.numpy() > kth
        assert set(i_m.numpy()[above]) == set(np.asarray(i_r)[above])

    def test_cpu_dispatch_runs_plain_version(self):
        rng = np.random.default_rng(6)
        V = _t(rng.standard_normal((30, 8)).astype(np.float32))
        q = _t(rng.standard_normal(8).astype(np.float32))
        before = mips_topk.launches
        for mode in ("plain", "abs", "aug"):
            got = mips_topk(V, q, 4, mode)
            want = mips_topk_ref(V, q, 4, mode)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert mips_topk.launches == before  # no kernel launched on the CPU

    def test_bad_arguments_raise(self):
        V, q = torch.zeros(10, 4), torch.zeros(4)
        with pytest.raises(ValueError):
            mips_topk(V, q, 11, "plain")
        with pytest.raises(ValueError):
            mips_topk(V, q, 3, "signed")
        with pytest.raises(ValueError):
            mips_topk(V.to("meta"), q.to("meta"), 3)


# ---------------------------------------------------------------- K4 ivf_probe

def _ivf_structure(n, dim, nlist, cap, seed, integer=False, fill=1.0):
    """Rows dealt round-robin into −1-padded cells (``fill`` of each
    cell's capacity used), member-mean centroids, cell-grouped rows."""
    rng = np.random.default_rng(seed)
    if integer:
        V = rng.integers(-4, 5, size=(n, dim)).astype(np.float32)
    else:
        V = rng.standard_normal((n, dim)).astype(np.float32)
    cells = np.full((nlist, cap), -1, np.int32)
    used = max(1, int(cap * fill))
    for j, idx in enumerate(rng.permutation(n)):
        c, s = j % nlist, j // nlist
        if s < used:
            cells[c, s] = idx
    cents = np.zeros((nlist, dim), np.float32)
    for c in range(nlist):
        members = cells[c][cells[c] >= 0]
        if len(members):
            cents[c] = V[members].mean(0)
    cell_rows = V[np.clip(cells, 0, None)] * (cells >= 0)[..., None]
    return V, cents, cells, cell_rows


class TestIVFProbeRef:
    @pytest.mark.parametrize("n,d,nlist,cap,k,nprobe,seed,integer,fill", [
        (200, 16, 10, 24, 12, 3, 0, False, 1.0),
        (300, 40, 17, 20, 30, 5, 1, False, 1.0),
        (200, 16, 10, 24, 12, 5, 7, True, 1.0),    # exact ties
        (120, 8, 12, 16, 20, 2, 2, False, 0.5),    # fewer valid than k
    ])
    def test_matches_reference(self, n, d, nlist, cap, k, nprobe, seed,
                               integer, fill):
        V, cents, cells, cell_rows = _ivf_structure(n, d, nlist, cap, seed,
                                                    integer, fill)
        rng = np.random.default_rng(seed + 1)
        q = (rng.integers(-3, 4, size=d) if integer
             else rng.standard_normal(d)).astype(np.float32)
        i_r, s_r, n_r = ivf_probe_topk_ref(jnp.asarray(cents), jnp.asarray(cells),
                                           jnp.asarray(V), jnp.asarray(q), k,
                                           nprobe)
        i_m, s_m, n_m = ivf_probe_topk(_t(cents), _t(cell_rows), _t(cells),
                                       _t(q), k, nprobe)
        np.testing.assert_array_equal(i_m.numpy(), np.asarray(i_r))
        np.testing.assert_allclose(s_m.numpy(), np.asarray(s_r), RTOL, ATOL)
        assert int(n_m) == int(n_r)
        if fill < 1.0:
            assert (i_m.numpy() == -1).any() and np.isneginf(s_m.numpy()).any()

    def test_padded_cap_is_neutral(self):
        """Padding cap to a multiple of 8 (pad ids −1, rows 0) changes
        nothing — the layout the index keeps on the card."""
        V, cents, cells, cell_rows = _ivf_structure(150, 12, 9, 19, 3)
        q = np.random.default_rng(4).standard_normal(12).astype(np.float32)
        cells8 = np.pad(cells, ((0, 0), (0, 5)), constant_values=-1)
        rows8 = np.pad(cell_rows, ((0, 0), (0, 5), (0, 0)))
        probe, _ = mips_topk_ref(_t(cents), _t(q), 4)
        a = ivf_probe_stream_ref(probe, _t(cell_rows), _t(cells), _t(q), 20)
        b = ivf_probe_stream(probe, _t(rows8), _t(cells8), _t(q), 20)
        for x, y in zip(a, b):
            assert torch.equal(x, y)

    def test_more_k_than_candidates_pads(self):
        V, cents, cells, cell_rows = _ivf_structure(30, 4, 6, 5, 0)
        probe = torch.tensor([0, 1], dtype=torch.int32)
        ids, scores, n_valid = ivf_probe_stream(probe, _t(cell_rows), _t(cells),
                                                torch.ones(4), 16)
        assert ids.shape == (16,) and int(n_valid) == 10
        assert (ids[10:] == -1).all() and torch.isneginf(scores[10:]).all()


# ------------------------------------------------------- K2 mwem_step, K3

def _state(U, seed):
    rng = np.random.default_rng(seed)
    lw = rng.standard_normal(U).astype(np.float32)
    lw -= lw.max()
    p = np.exp(lw) / np.exp(lw).sum()
    ps = rng.random(U).astype(np.float32)
    Q = (rng.random((20, U)) < 0.3).astype(np.float32)
    h = rng.dirichlet(np.ones(U)).astype(np.float32)
    return lw, p.astype(np.float32), ps, Q, h


class TestMwemStepRef:
    @pytest.mark.parametrize("rule", UPDATE_RULES)
    @pytest.mark.parametrize("U,sel,seed", [(64, 3, 0), (200, 19, 1), (256, 0, 2)])
    def test_matches_reference(self, rule, U, sel, seed):
        lw, p, ps, Q, h = _state(U, seed)
        noise = np.float32(0.013 * (seed - 1))
        ref = ref_mwem_step(jnp.asarray(lw), jnp.asarray(p), jnp.asarray(ps),
                            jnp.asarray(Q[sel]), jnp.asarray(h),
                            jnp.float32(noise), rule=rule, eta=0.37)
        mine = mwem_step(_t(lw), _t(p), _t(ps), _t(Q), torch.tensor(sel),
                         _t(h), torch.tensor(noise), rule=rule, eta=0.37)
        for a, b in zip(mine, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), RTOL, ATOL)
        assert float(mine[0].max()) == 0.0
        assert abs(float(mine[1].sum()) - 1.0) < 1e-5

    def test_bad_rule_raises(self):
        lw, p, ps, Q, h = _state(16, 0)
        with pytest.raises(ValueError):
            mwem_step(_t(lw), _t(p), _t(ps), _t(Q), torch.tensor(0), _t(h),
                      torch.tensor(0.0), rule="exp", eta=0.1)

    def test_cpu_dispatch_counts_no_launch(self):
        lw, p, ps, Q, h = _state(32, 1)
        before = (mwem_step.launches, gather_score.launches)
        mwem_step(_t(lw), _t(p), _t(ps), _t(Q), torch.tensor(2), _t(h),
                  torch.tensor(0.0), rule="hardt", eta=0.1)
        gather_score(_t(Q), _t(h), torch.tensor([1, 30]))
        assert (mwem_step.launches, gather_score.launches) == before


class TestGatherScoreRef:
    @pytest.mark.parametrize("m,U,C,seed", [(20, 64, 9, 0), (50, 100, 40, 1)])
    def test_matches_reference_aug_score(self, m, U, C, seed):
        rng = np.random.default_rng(seed)
        Q = (rng.random((m, U)) < 0.4).astype(np.float32)
        v = rng.standard_normal(U).astype(np.float32)
        aug = rng.integers(0, 2 * m, size=C)
        ref = ref_mwem._aug_score(RefDenseWorkload(jnp.asarray(Q)),
                                  jnp.asarray(v), jnp.asarray(aug, jnp.int32))
        mine = gather_score(_t(Q), _t(v), _t(aug, torch.int64))
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), RTOL, ATOL)

    def test_inactive_slots_score_zero(self):
        rng = np.random.default_rng(2)
        Q = _t(rng.random((10, 16)).astype(np.float32))
        v = _t(rng.standard_normal(16).astype(np.float32))
        aug = torch.tensor([0, 3, 12, 19])
        active = torch.tensor([True, False, True, False])
        out = gather_score_ref(Q, v, aug, active)
        full = gather_score_ref(Q, v, aug)
        assert out[1] == 0 and out[3] == 0
        assert torch.equal(out[active], full[active])


# -------------------------------------------------------------------- build

class TestBuild:
    def test_missing_nvcc_raises_instead_of_falling_back(self, monkeypatch,
                                                         tmp_path):
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        monkeypatch.setattr(_build.os.path, "exists",
                            lambda p: False if "nvcc" in str(p) else True)
        monkeypatch.setattr(_build, "_LIBS", {})
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load("mips_topk")

    def test_every_source_has_a_library_name(self):
        stems = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
        assert stems == ["flash_attention", "ivf_probe", "mips_topk",
                         "mwem_step", "mwu_update", "ssd_scan"]
        names = {_build._lib_path(p).name for p in _build.CSRC.glob("*.cu")}
        assert len(names) == 6

    def test_require_rejects_cpu_tensors(self):
        with pytest.raises(ValueError, match="CUDA"):
            _build.require("x", torch.zeros(3), torch.float32)
