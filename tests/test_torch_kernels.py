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
from repro.kernels.ivf_probe.ref import (ivf_probe_topk_batch_ref,
                                        ivf_probe_topk_ref)
from repro.kernels.mips_topk.ops import mips_abs_topk
from repro.kernels.mips_topk.ref import mips_topk_ref as ref_mips_topk
from repro.kernels.mwem_step.ref import mwem_step_ref as ref_mwem_step

from repro_torch.kernels import _build
from repro_torch.kernels.ivf_probe import (batch_probe_slots, ivf_probe_stream,
                                           ivf_probe_stream_batch,
                                           ivf_probe_stream_batch_ref,
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


def _edge_rows(case, n, d, rng):
    """(V, q) of one K1 edge case: ``random``, ``equal`` (all rows alike,
    integer-valued), ``zeros`` (rows of +0.0 and −0.0 among positive
    integer rows; q > 0) or ``d21`` (random rows of the LP's width)."""
    if case == "d21":
        d = 21
    V = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal(d).astype(np.float32)
    if case == "equal":
        V = np.tile(rng.integers(-3, 4, size=d), (n, 1)).astype(np.float32)
        q = rng.integers(1, 4, size=d).astype(np.float32)
    elif case == "zeros":
        V = np.zeros((n, d), np.float32)
        V[1::3] = -0.0
        V[2::3] = rng.integers(1, 4, size=(len(range(2, n, 3)), d))
        q = rng.integers(1, 4, size=d).astype(np.float32)
    return V, q


def _assert_same_up_to_zero_sign(i_m, s_m, i_r, s_r):
    """Scores equal; ids equal where the score is not 0; the ids that score
    ±0 are the same set, and the port's come in ascending id (it folds −0
    onto +0 and ranks the tie by id; `jax.lax.top_k` puts +0 first)."""
    s_m, s_r = np.asarray(s_m), np.asarray(s_r)
    np.testing.assert_array_equal(s_m, s_r)
    zero = s_m == 0
    np.testing.assert_array_equal(np.asarray(i_m)[~zero], np.asarray(i_r)[~zero])
    assert set(np.asarray(i_m)[zero]) == set(np.asarray(i_r)[zero])
    assert list(np.asarray(i_m)[zero]) == sorted(np.asarray(i_m)[zero])


class TestMipsTopkEdgeCases:
    """The plain version against `repro` at the edge cases the select of
    the CUDA kernel must also meet: all-equal rows (ties decide every
    place), ±0 scores, k = n and the LP's width d = 21."""

    @pytest.mark.parametrize("case", ["random", "equal", "zeros", "d21"])
    @pytest.mark.parametrize("k_of_n", ["one", "half", "all"])
    def test_plain_and_abs_match_reference(self, case, k_of_n):
        rng = np.random.default_rng(11)
        V, q = _edge_rows(case, 60, 12, rng)
        n = V.shape[0]
        k = {"one": 1, "half": n // 2, "all": n}[k_of_n]
        s = jnp.asarray(V) @ jnp.asarray(q)
        for mode, score in (("plain", s), ("abs", jnp.abs(s))):
            top_s, top_i = jax.lax.top_k(score, k)
            i_m, s_m = mips_topk_ref(_t(V), _t(q), k, mode)
            if case == "zeros":
                if k_of_n == "half":  # cut inside the ±0 group: compare all
                    i_m, s_m = mips_topk_ref(_t(V), _t(q), n, mode)
                    top_s, top_i = jax.lax.top_k(score, n)
                _assert_same_up_to_zero_sign(i_m.numpy(), s_m.numpy(), top_i, top_s)
            else:
                np.testing.assert_array_equal(i_m.numpy(), np.asarray(top_i))
                np.testing.assert_allclose(s_m.numpy(), np.asarray(top_s), RTOL, ATOL)

    @pytest.mark.parametrize("case", ["random", "equal", "zeros", "d21"])
    def test_aug_matches_reference_kernel(self, case):
        """All 2n candidates against the reference's Pallas kernel in
        interpret mode: the same scores and, per score, the same ids (its
        order among exact ties depends on its tile size)."""
        rng = np.random.default_rng(12)
        V, q = _edge_rows(case, 24, 8, rng)
        n = V.shape[0]
        i_r, s_r = mips_abs_topk(jnp.asarray(V), jnp.asarray(q), 2 * n,
                                 block_n=8, block_d=8)
        i_m, s_m = mips_topk_ref(_t(V), _t(q), 2 * n, "aug")
        np.testing.assert_allclose(s_m.numpy(), np.asarray(s_r), RTOL, ATOL)
        for val in np.unique(s_m.numpy()):
            at = np.isclose(s_m.numpy(), val, rtol=RTOL, atol=ATOL)
            assert set(i_m.numpy()[at]) == set(np.asarray(i_r)[at])


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


class TestWaveProbeEdgeCases:
    """K5's plain version against `repro`'s batch reference at the edge
    cases its kernel's select must also meet: all-equal rows, ±0 scores,
    k = every candidate slot of the wave (the tail −1 / −inf) and the LP's
    width d = 21."""

    @pytest.mark.parametrize("case", ["equal", "zeros", "all", "d21"])
    @pytest.mark.parametrize("lanes", [1, 3])
    def test_matches_reference(self, case, lanes):
        d = 21 if case == "d21" else 8
        V, cents, cells, cell_rows = _ivf_structure(
            150, d, 10, 20, seed=lanes, integer=case in ("equal", "zeros"),
            fill=0.75)
        rng = np.random.default_rng(lanes + 20)
        Vb = rng.standard_normal((lanes, d)).astype(np.float32)
        if case == "equal":
            V[:] = V[0]
        elif case == "zeros":
            V[::3] = -0.0
            V[1::3] = 0.0
            V[2::3] = np.abs(V[2::3]) + 1
            Vb = np.abs(np.round(Vb)) + 1
        cell_rows = V[np.clip(cells, 0, None)] * (cells >= 0)[..., None]
        nprobe = 3
        k = nprobe * lanes * cells.shape[1] if case == "all" else 12
        i_r, s_r, n_r = ivf_probe_topk_batch_ref(
            *map(jnp.asarray, (cents, cells, V, Vb)), k, nprobe)
        slots, member, _ = batch_probe_slots(_t(cents), _t(Vb), nprobe)
        i_m, s_m, n_m = ivf_probe_stream_batch_ref(slots, member, _t(cell_rows),
                                                   _t(cells), _t(Vb), k)
        np.testing.assert_array_equal(n_m.numpy(), np.asarray(n_r))
        for b in range(lanes):
            if case == "zeros":
                _assert_same_up_to_zero_sign(i_m[b].numpy(), s_m[b].numpy(),
                                             np.asarray(i_r[b]), np.asarray(s_r[b]))
            else:
                np.testing.assert_array_equal(i_m[b].numpy(), np.asarray(i_r[b]))
                np.testing.assert_allclose(s_m[b].numpy(), np.asarray(s_r[b]),
                                           RTOL, ATOL)
        if case == "all":
            assert (i_m == -1).any() and bool(torch.isneginf(s_m[i_m == -1]).all())


class TestWrapperArguments:
    """What the wrappers refuse before any device work, on any device."""

    @pytest.mark.parametrize("k,mode", [(0, "plain"), (11, "plain"),
                                        (21, "aug"), (9000, "aug"),
                                        (3, "signed")])
    def test_mips_topk_rejects(self, k, mode):
        V, q = torch.zeros(10, 4), torch.zeros(4)
        with pytest.raises(ValueError):
            mips_topk(V, q, k, mode)

    def test_mips_topk_rejects_mixed_devices(self):
        with pytest.raises(ValueError, match="several devices"):
            mips_topk(torch.zeros(10, 4), torch.zeros(4, device="meta"), 3)

    @pytest.mark.parametrize("k", [0, 8193])
    def test_ivf_probes_reject_k(self, k):
        _, cents, cells, cell_rows = _ivf_structure(60, 4, 6, 10, 0)
        Vb = torch.ones(2, 4)
        slots, member, _ = batch_probe_slots(_t(cents), Vb, 2)
        with pytest.raises(ValueError, match="k="):
            ivf_probe_stream(torch.tensor([0, 1], dtype=torch.int32),
                             _t(cell_rows), _t(cells), Vb[0], k)
        with pytest.raises(ValueError, match="k="):
            ivf_probe_stream_batch(slots, member, _t(cell_rows), _t(cells), Vb, k)

    def test_ivf_probe_batch_rejects_mixed_devices(self):
        _, cents, cells, cell_rows = _ivf_structure(60, 4, 6, 10, 0)
        Vb = torch.ones(2, 4)
        slots, member, _ = batch_probe_slots(_t(cents), Vb, 2)
        with pytest.raises(ValueError, match="several devices"):
            ivf_probe_stream_batch(slots, member, _t(cell_rows), _t(cells),
                                   Vb.to("meta"), 4)


# ----------------------------------------- the CUDA select, emulated on numpy

def _keys(scores, ties):
    """`rt::make_key` of common.cuh on numpy: order-preserving score bits
    (−0 folded onto +0) over 0xFFFFFFFF − tie."""
    x = np.where(scores == 0, np.float32(0), scores).astype(np.float32)
    u = x.view(np.uint32)
    o = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return ((o.astype(np.uint64) << np.uint64(32))
            | (np.uint64(0xFFFFFFFF) - ties.astype(np.uint64)))


def _block_select(keys, k):
    """`sel::block_select` of topk_select.cuh: 8-bit digits from the top,
    a histogram of the keys matching the prefix, stop when the bucket of
    the need-th largest is taken whole."""
    if len(keys) <= k:
        return keys
    prefix = mask = np.uint64(0)
    need = k
    for shift in range(56, -1, -8):
        digits = (keys[(keys & mask) == prefix] >> np.uint64(shift)) & np.uint64(255)
        hist = np.bincount(digits.astype(np.int64), minlength=256)
        run = 0
        for digit in range(255, -1, -1):
            if run + hist[digit] >= need:
                break
            run += hist[digit]
        need -= run
        prefix |= np.uint64(digit) << np.uint64(shift)
        mask |= np.uint64(255) << np.uint64(shift)
        if hist[digit] == need or shift == 0:
            break
    return keys[(keys & mask) >= prefix]


def _top_digit_filter(keys, k):
    """`sel::topk_filter_kernel`: keep the keys whose top 12 bits are at or
    above the bucket of the k-th largest (all of them if there are <= k)."""
    top = (keys >> np.uint64(52)).astype(np.int64)
    from_top = np.cumsum(np.bincount(top, minlength=4096)[::-1])
    digit = 4095 - int(np.argmax(from_top >= k)) if from_top[-1] >= k else 0
    return keys[top >= digit]


class TestSelectEmulation:
    """The radix select of ``csrc/topk_select.cuh`` (its CUDA runs only on
    the card, where `chip_smoke.py` holds it to the plain versions) replayed
    on numpy: filter then select keeps exactly the top k keys of a stable
    descending sort, on spread, clustered, tied, ±0 and ±inf scores."""

    @pytest.mark.parametrize("case", ["normal", "clustered", "equal", "zeros",
                                      "inf", "integer", "tiny"])
    @pytest.mark.parametrize("k", [1, 37, 512, 5000])
    def test_keeps_the_stable_top_k(self, case, k):
        rng = np.random.default_rng(k)
        n = 3 if case == "tiny" else 4000
        s = rng.standard_normal(n).astype(np.float32)
        if case == "clustered":
            s = (1.0 + 1e-6 * s).astype(np.float32)
        elif case == "equal":
            s[:] = 2.5
        elif case == "zeros":
            s[::3], s[1::3] = 0.0, -0.0
        elif case == "inf":
            s[::5], s[2::5] = np.inf, -np.inf
        elif case == "integer":
            s = rng.integers(-3, 4, n).astype(np.float32)
        keys = _keys(s, np.arange(n))
        kept = _block_select(_top_digit_filter(keys, k), k)
        assert len(kept) == min(k, n)
        order = np.sort(kept)[::-1]
        ids = (np.uint64(0xFFFFFFFF) - (order & np.uint64(0xFFFFFFFF))).astype(np.int64)
        want = torch.sort(torch.as_tensor(s), descending=True, stable=True)
        np.testing.assert_array_equal(ids, want.indices[:k].numpy())


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
