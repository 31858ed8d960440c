"""The wave batch: the port's `run_mwem_batch` and its kernels' plain
versions held to `repro` on the same inputs and the same key chains.

Each lane draws through `JaxDraws.chain(key_b, T)`, so lane b of the port
makes the draws lane b of `repro.run_mwem_batch` makes. Tolerances:
selections, n_scored and overflow counts must be equal (at these sizes no
winner is within float noise of its runner-up); ``p_hat``, errors and the
plain kernels' states agree to f32 accumulation-order noise (rtol 1e-5,
atol 1e-7; the fused step's states at rtol 1e-4, atol 1e-7, as in the
slice-1 tests); probe ids are equal, exactly so with integer-data ties.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_core import JaxDraws

from repro.core.mwem import MWEMConfig as RefConfig
from repro.core.mwem import run_mwem_batch as ref_run_mwem_batch
from repro.core.workload import as_workload as ref_as_workload
from repro.kernels.ivf_probe.ops import \
    ivf_probe_topk_batch as ref_ivf_probe_topk_batch
from repro.kernels.ivf_probe.ref import batch_probe_slots as ref_slots
from repro.kernels.ivf_probe.ref import ivf_probe_topk_batch_ref
from repro.kernels.mwem_step.ops import mwem_step_batch as ref_step_batch
from repro.mips import FlatAbsIndex as RefFlat
from repro.mips import IVFIndex as RefIVF

from repro_torch import convert
from repro_torch.core import (LaneDraws, MWEMBatchResult, MWEMConfig,
                              PrivacyLedger, TorchDraws, finish_mwem_batch,
                              launch_mwem_batch, release_cost, run_mwem,
                              run_mwem_batch)
from repro_torch.core import lazy_em
from repro_torch.core.queries import gaussian_histogram, random_binary_queries
from repro_torch.kernels.ivf_probe import (batch_probe_slots,
                                           ivf_probe_stream_batch,
                                           ivf_probe_stream_batch_ref,
                                           ivf_probe_topk_batch)
from repro_torch.kernels.ivf_probe import ops as ivf_ops
from repro_torch.kernels.mwem_step import (gather_score_batch,
                                           gather_score_batch_ref,
                                           gather_score_ref, mwem_step_batch,
                                           mwem_step_batch_ref, mwem_step_ref)
from repro_torch.mips import FlatAbsIndex, augment_complement

ref_mwem = importlib.import_module("repro.core.mwem")

CPU = torch.device("cpu")
M, U, N, T = 96, 64, 500, 20
B = 3


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(2026)
    Q = random_binary_queries(rng, M, U)
    h = gaussian_histogram(rng, N, U)
    hb = np.stack([gaussian_histogram(rng, N, U, mean=U / (3 + b))
                   for b in range(B)])
    return Q, h, hb


@pytest.fixture(scope="module")
def ivf_pair(data):
    Q = data[0]
    ref = RefIVF(augment_complement(Q), seed=0, use_pallas="never")
    mine = convert.ivf_index(np.asarray(ref._v), np.asarray(ref._cents),
                             np.asarray(ref._cells), nprobe=ref.nprobe,
                             device=CPU)
    return ref, mine


def _indices(kind, data, ivf_pair):
    if kind == "exact":
        return None, None
    if kind == "flat":
        return RefFlat(data[0], use_pallas="never"), FlatAbsIndex(data[0], device=CPU)
    return ivf_pair


def _keys(seed, lanes=B):
    return [jax.random.PRNGKey(seed + b) for b in range(lanes)]


def _lane_draws(keys, steps=T):
    return LaneDraws([JaxDraws.chain(key, steps) for key in keys])


def _both(kind, data, ivf_pair, seed=1, per_lane_h=False, lanes=B, **cfg):
    Q, h, hb = data
    hh = hb[:lanes] if per_lane_h else h
    ref_index, index = _indices(kind, data, ivf_pair)
    mode = "exact" if kind == "exact" else "fast"
    keys = _keys(seed, lanes)
    ref = ref_run_mwem_batch(Q, hh, RefConfig(T=T, mode=mode, n_records=N, **cfg),
                             jnp.stack(keys), index=ref_index)
    mine = run_mwem_batch(convert.tensor(Q, CPU), convert.tensor(hh, CPU),
                          MWEMConfig(T=T, mode=mode, n_records=N, **cfg),
                          _lane_draws(keys), index=index, device=CPU)
    return ref, mine


def _assert_same_batch(ref, mine):
    np.testing.assert_array_equal(mine.selected, np.asarray(ref.selected))
    np.testing.assert_array_equal(mine.n_scored, np.asarray(ref.n_scored))
    np.testing.assert_array_equal(mine.overflow_counts,
                                  np.asarray(ref.overflow_counts))
    np.testing.assert_allclose(mine.p_hat.numpy(), np.asarray(ref.p_hat),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(mine.final_errors, np.asarray(ref.final_errors),
                               rtol=1e-5)
    assert mine.ledger.events == ref.ledger.events
    assert mine.ledger.index_failure_mass == ref.ledger.index_failure_mass
    assert mine.ledger.composed() == ref.ledger.composed()
    assert mine.total_seconds == 0.0  # no clock on the CPU


# ------------------------------------------------------ K5 and its planning

def _ivf_structure(n, dim, nlist, cap, seed, integer=False):
    """Rows dealt round-robin into −1-padded cells, centroids = member
    means, and the cell-grouped copy (the layout of tests/test_kernels.py);
    integer data makes exact score ties the norm."""
    rng = np.random.default_rng(seed)
    if integer:
        V = rng.integers(-4, 5, size=(n, dim)).astype(np.float32)
    else:
        V = rng.standard_normal((n, dim)).astype(np.float32)
    cells = np.full((nlist, cap), -1, np.int32)
    for j, idx in enumerate(rng.permutation(n)):
        if j // nlist < cap:
            cells[j % nlist, j // nlist] = idx
    cents = np.zeros((nlist, dim), np.float32)
    for c in range(nlist):
        members = cells[c][cells[c] >= 0]
        if len(members):
            cents[c] = V[members].mean(0)
    cell_rows = V[np.clip(cells, 0, None)] * (cells >= 0)[..., None]
    return V, cents, cells, cell_rows


class TestBatchProbe:
    @pytest.mark.parametrize("lanes", [1, 3, 8])
    @pytest.mark.parametrize("nprobe", [1, 4])
    def test_slots_match_reference(self, lanes, nprobe):
        V, cents, cells, _ = _ivf_structure(240, 20, 12, 24, seed=lanes)
        Vb = np.random.default_rng(nprobe).standard_normal(
            (lanes, 20)).astype(np.float32)
        ref = ref_slots(jnp.asarray(cents), jnp.asarray(cells), jnp.asarray(Vb),
                        nprobe)
        mine = batch_probe_slots(_t(cents), _t(Vb), nprobe)
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert mine[0].dtype == torch.int32 and mine[1].dtype == torch.float32

    @pytest.mark.parametrize("lanes,k,nprobe", [(1, 5, 3), (3, 12, 4),
                                                (8, 40, 2), (3, 90, 3)])
    def test_plain_matches_reference(self, lanes, k, nprobe):
        """Float data; k=90 exceeds a lane's 3·≈20 valid rows, so the tail
        of each lane is −1 / −inf."""
        V, cents, cells, cell_rows = _ivf_structure(240, 20, 12, 24, seed=k)
        Vb = np.random.default_rng(k + 1).standard_normal(
            (lanes, 20)).astype(np.float32)
        i_r, s_r, n_r = ivf_probe_topk_batch_ref(
            *map(jnp.asarray, (cents, cells, V, Vb)), k, nprobe)
        i_m, s_m, n_m = ivf_probe_topk_batch(_t(cents), _t(cell_rows),
                                             _t(cells), _t(Vb), k, nprobe)
        np.testing.assert_array_equal(i_m.numpy(), np.asarray(i_r))
        np.testing.assert_allclose(s_m.numpy(), np.asarray(s_r), 1e-5, 1e-6)
        np.testing.assert_array_equal(n_m.numpy(), np.asarray(n_r))
        if k == 90:
            assert (i_m == -1).any() and bool((n_m < k).all())
            assert bool(torch.isneginf(s_m[i_m == -1]).all())

    @pytest.mark.parametrize("lanes", [1, 4])
    def test_integer_ties_match_reference(self, lanes):
        """Exact ties: ids follow the wave's slot order exactly."""
        V, cents, cells, cell_rows = _ivf_structure(200, 16, 10, 24, seed=7,
                                                    integer=True)
        Vb = np.random.default_rng(3).integers(
            -3, 4, size=(lanes, 16)).astype(np.float32)
        i_r, s_r, n_r = ivf_probe_topk_batch_ref(
            *map(jnp.asarray, (cents, cells, V, Vb)), 30, 5)
        i_m, s_m, n_m = ivf_probe_topk_batch(_t(cents), _t(cell_rows),
                                             _t(cells), _t(Vb), 30, 5)
        np.testing.assert_array_equal(i_m.numpy(), np.asarray(i_r))
        np.testing.assert_array_equal(s_m.numpy(), np.asarray(s_r))
        np.testing.assert_array_equal(n_m.numpy(), np.asarray(n_r))

    def test_matches_reference_kernel_in_interpret_mode(self):
        """The reference's own batch kernel, run in interpret mode on the
        CPU, gives the same wave probe (tiny shape, integer ties)."""
        V, cents, cells, cell_rows = _ivf_structure(60, 8, 6, 10, seed=2,
                                                    integer=True)
        Vb = np.random.default_rng(5).integers(-2, 3, size=(2, 8)).astype(
            np.float32)
        i_k, s_k, n_k = ref_ivf_probe_topk_batch(
            *map(jnp.asarray, (cents, cell_rows, cells, Vb)), 7, 2,
            interpret=True)
        i_m, s_m, n_m = ivf_probe_topk_batch(_t(cents), _t(cell_rows),
                                             _t(cells), _t(Vb), 7, 2)
        np.testing.assert_array_equal(i_m.numpy(), np.asarray(i_k))
        np.testing.assert_array_equal(s_m.numpy(), np.asarray(s_k))
        np.testing.assert_array_equal(n_m.numpy(), np.asarray(n_k))

    def test_lanes_match_single_probes_away_from_ties(self, ivf_pair):
        """Float data: a wave lane retrieves what a single-lane probe does."""
        _, mine = ivf_pair
        rng = np.random.default_rng(9)
        Vb = torch.as_tensor((rng.dirichlet(np.ones(U), 5)
                              - rng.dirichlet(np.ones(U), 5)).astype(np.float32))
        ib, sb = mine.query_batch(Vb, 10)
        for b in range(5):
            i1, s1 = mine.query(Vb[b], 10)
            np.testing.assert_array_equal(ib[b].numpy(), i1.numpy())
            np.testing.assert_allclose(sb[b].numpy(), s1.numpy(), 1e-5, 1e-7)

    def test_wrapper_dispatches_cpu_to_plain_version(self):
        V, cents, cells, cell_rows = _ivf_structure(100, 8, 6, 20, seed=1)
        Vb = _t(np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32))
        slots, member, _ = batch_probe_slots(_t(cents), Vb, 2)
        before = ivf_probe_stream_batch.launches
        got = ivf_probe_stream_batch(slots, member, _t(cell_rows), _t(cells), Vb, 9)
        want = ivf_probe_stream_batch_ref(slots, member, _t(cell_rows),
                                          _t(cells), Vb, 9)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert ivf_probe_stream_batch.launches == before  # no kernel launched
        with pytest.raises(ValueError, match="k="):
            ivf_probe_stream_batch(slots, member, _t(cell_rows), _t(cells), Vb, 0)


class TestLaneGroups:
    """A wave wider than one K5 launch is probed in groups of lanes, each
    group with its own plan; forcing groups of 4 shows that a B = 9 wave
    equals the unsplit one lane for lane (the card's launches take 16)."""

    @pytest.mark.parametrize("integer", [False, True])
    def test_split_probe_equals_unsplit(self, monkeypatch, integer):
        V, cents, cells, cell_rows = _ivf_structure(200, 8, 12, 24, seed=4,
                                                    integer=integer)
        rng = np.random.default_rng(6)
        Vb = (rng.integers(-2, 3, size=(9, 8)) if integer
              else rng.standard_normal((9, 8))).astype(np.float32)
        args = (_t(cents), _t(cell_rows), _t(cells), _t(Vb), 15, 3)
        whole = ivf_probe_topk_batch(*args)
        monkeypatch.setattr(ivf_ops, "MAX_LANES", 4)
        before = ivf_probe_stream_batch.launches  # CPU: counts stay put
        split = ivf_probe_topk_batch(*args)
        assert ivf_probe_stream_batch.launches == before
        assert torch.equal(split[0], whole[0]) and torch.equal(split[2], whole[2])
        if integer:  # exact sums: the scores too are equal
            assert torch.equal(split[1], whole[1])
        else:  # the plain product's blocking follows the group's shape
            np.testing.assert_allclose(split[1].numpy(), whole[1].numpy(),
                                       rtol=1e-6, atol=1e-6)

    def test_split_wave_run_equals_unsplit(self, monkeypatch, data, ivf_pair):
        Q, h, _ = data
        _, index = ivf_pair
        cfg = MWEMConfig(T=T, mode="fast", n_records=N)

        def run():
            return run_mwem_batch(convert.tensor(Q, CPU), convert.tensor(h, CPU),
                                  cfg, LaneDraws.seeded(range(40, 49), CPU),
                                  index=index, device=CPU)

        whole = run()
        monkeypatch.setattr(ivf_ops, "MAX_LANES", 4)
        split = run()
        np.testing.assert_array_equal(split.selected, whole.selected)
        np.testing.assert_array_equal(split.n_scored, whole.n_scored)
        assert torch.equal(split.p_hat, whole.p_hat)


# ----------------------------------------------------- K2 and K3 on lanes

def _lane_state(rng, lanes, u):
    lw = rng.standard_normal((lanes, u)).astype(np.float32)
    lw -= lw.max(1, keepdims=True)
    p = np.exp(lw) / np.exp(lw).sum(1, keepdims=True)
    ps = rng.random((lanes, u)).astype(np.float32)
    return lw, p.astype(np.float32), ps


class TestStepBatch:
    @pytest.mark.parametrize("rule", ["paper", "signed", "hardt"])
    @pytest.mark.parametrize("per_lane_h", [False, True])
    @pytest.mark.parametrize("u", [64, 128])
    def test_matches_reference(self, rule, per_lane_h, u):
        rng = np.random.default_rng(u)
        lanes = 4
        lw, p, ps = _lane_state(rng, lanes, u)
        Q = (rng.random((9, u)) < 0.3).astype(np.float32)
        h = rng.dirichlet(np.ones(u), lanes if per_lane_h else None).astype(
            np.float32)
        sel = np.array([3, 0, 8, 3])
        noise = (rng.standard_normal(lanes) * 1e-3).astype(np.float32)
        ref = ref_step_batch(*map(jnp.asarray, (lw, p, ps, Q, sel, h, noise)),
                             rule=rule, eta=0.3)
        mine = mwem_step_batch(*map(_t, (lw, p, ps, Q)), _t(sel, torch.int64),
                               _t(h), _t(noise), rule=rule, eta=0.3)
        for a, b in zip(mine, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-7)

    def test_lane_equals_single_lane_step(self):
        rng = np.random.default_rng(5)
        lw, p, ps = _lane_state(rng, 3, 50)
        Q = _t((rng.random((6, 50)) < 0.4).astype(np.float32))
        h = _t(rng.dirichlet(np.ones(50), 3).astype(np.float32))
        sel, noise = torch.tensor([1, 5, 1]), torch.tensor([0.01, -0.02, 0.0])
        out = mwem_step_batch(_t(lw), _t(p), _t(ps), Q, sel, h, noise,
                              rule="hardt", eta=0.2)
        for b in range(3):
            one = mwem_step_ref(_t(lw[b]), _t(p[b]), _t(ps[b]), Q, sel[b], h[b],
                                noise[b], rule="hardt", eta=0.2)
            for a, c in zip(out, one):
                assert torch.equal(a[b], c)

    def test_gather_score_batch_matches_aug_score(self, data):
        """Row b of the batched tail scorer equals the reference's
        `_aug_score` of lane b's probe; inactive slots score 0."""
        Q = data[0]
        rng = np.random.default_rng(1)
        V = (rng.standard_normal((4, U)) * 1e-2).astype(np.float32)
        aug = rng.integers(0, 2 * M, (4, 30))
        active = rng.random((4, 30)) < 0.6
        W = ref_as_workload(jnp.asarray(Q))
        mine = gather_score_batch(_t(Q), _t(V), _t(aug, torch.int64),
                                  _t(active))
        for b in range(4):
            ref = np.asarray(ref_mwem._aug_score(W, jnp.asarray(V[b]),
                                                 jnp.asarray(aug[b])))
            np.testing.assert_allclose(mine[b].numpy()[active[b]],
                                       ref[active[b]], 1e-5, 1e-7)
            assert float(mine[b][~_t(active[b])].abs().sum()) == 0.0
            assert torch.equal(mine[b], gather_score_ref(
                _t(Q), _t(V[b]), _t(aug[b], torch.int64), _t(active[b])))

    def test_wrappers_dispatch_cpu_to_plain_versions(self, data):
        Q = _t(data[0])
        rng = np.random.default_rng(2)
        lw, p, ps = _lane_state(rng, 2, U)
        args = (_t(lw), _t(p), _t(ps), Q, torch.tensor([4, 7]),
                _t(data[1]), torch.tensor([1e-3, 0.0]))
        steps = mwem_step_batch.launches
        got = mwem_step_batch(*args, rule="hardt", eta=0.2)
        want = mwem_step_batch_ref(*args, rule="hardt", eta=0.2)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        V = _t(rng.standard_normal((2, U)).astype(np.float32))
        aug = torch.tensor([[0, 100, 5], [191, 3, 96]])
        scores = gather_score_batch.launches
        assert torch.equal(gather_score_batch(Q, V, aug),
                           gather_score_batch_ref(Q, V, aug))
        assert (mwem_step_batch.launches, gather_score_batch.launches) == (
            steps, scores)  # the plain versions launch nothing
        with pytest.raises(ValueError, match="update rule"):
            mwem_step_batch(*args, rule="nope", eta=0.2)

    def test_batch_state_conversion_steps_like_reference(self, data):
        """A reference (B, U) state and per-lane h carried across take the
        same batched step."""
        Q, _, hb = data
        rng = np.random.default_rng(8)
        lw, p, ps = _lane_state(rng, B, U)
        state = convert.mwem_state(lw, ps, CPU)
        assert state.log_w.shape == (B, U) and state.p_sum.shape == (B, U)
        sel, noise = np.array([2, 90, 41]), np.array([0.0, 1e-3, -1e-3], np.float32)
        ref = ref_step_batch(*map(jnp.asarray, (lw, p, ps, Q, sel, hb, noise)),
                             rule="signed", eta=0.25)
        mine = mwem_step_batch(state.log_w, _t(p), state.p_sum,
                               convert.tensor(Q, CPU), _t(sel, torch.int64),
                               convert.tensor(hb, CPU), _t(noise),
                               rule="signed", eta=0.25)
        for a, b in zip(mine, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), 1e-4, 1e-7)


# ------------------------------------------------------------ batched lazy EM

class TestLazyEMLanes:
    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("slack", [0.0, 0.5])
    def test_lane_equals_single_lane(self, seed, slack):
        """(B, k) top-k sets through one call: lane b's index, n_scored,
        tail count, margin and overflow equal the single-lane call fed
        lane b's draws (small buffers overflow on some lanes)."""
        rng = np.random.default_rng(seed)
        n, k, lanes = 400, 20, 4
        scores = (rng.standard_normal((lanes, n)) * 1.5).astype(np.float32)
        cap = 16 if seed % 2 else 80
        top_s, top_i = torch.sort(_t(scores), dim=1, descending=True, stable=True)
        top_s, top_i = top_s[:, :k], top_i[:, :k]
        keys = _keys(100 * seed, lanes)
        wave = lazy_em.lazy_em_from_topk(
            LaneDraws([JaxDraws(sel_keys=[key]) for key in keys]), 0, top_i,
            top_s, n, score_fn=lambda idx, act: _t(scores).gather(1, idx),
            tail_cap=cap, margin_slack=slack)
        for b in range(lanes):
            one = lazy_em.lazy_em_from_topk(
                JaxDraws(sel_keys=[keys[b]]), 0, top_i[b], top_s[b], n,
                score_fn=lambda idx, act: _t(scores[b])[idx], tail_cap=cap,
                margin_slack=slack)
            for field in one._fields:
                assert torch.equal(getattr(wave, field)[b], getattr(one, field)), field


# ------------------------------------------------------------- whole waves

@pytest.mark.parametrize("rule", ["paper", "signed", "hardt"])
@pytest.mark.parametrize("kind", ["exact", "flat", "ivf"])
def test_batch_matches_reference(kind, rule, data, ivf_pair):
    ref, mine = _both(kind, data, ivf_pair, update_rule=rule)
    _assert_same_batch(ref, mine)


@pytest.mark.parametrize("kind", ["exact", "flat", "ivf"])
def test_per_lane_histograms_match_reference(kind, data, ivf_pair):
    ref, mine = _both(kind, data, ivf_pair, seed=5, per_lane_h=True)
    _assert_same_batch(ref, mine)
    assert len({tuple(r) for r in mine.selected}) > 1


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_forced_overflow_matches_reference(kind, data, ivf_pair):
    """``tail_cap=1`` overflows most steps, on some lanes and not others
    in the same step: only those lanes redo, each on its own fallback
    stream."""
    ref, mine = _both(kind, data, ivf_pair, seed=3, tail_cap=1)
    _assert_same_batch(ref, mine)
    redo = mine.n_scored == M
    assert int(redo.sum()) == int(mine.overflow_counts.sum()) > B * T // 2
    assert (redo.any(0) & ~redo.all(0)).any()  # a step with a partial redo


def test_eval_every_matches_reference(data, ivf_pair):
    ref, mine = _both("ivf", data, ivf_pair, seed=4, eval_every=5)
    _assert_same_batch(ref, mine)
    assert mine.errors.shape == (B, T // 5)
    np.testing.assert_allclose(mine.errors, np.asarray(ref.errors), rtol=1e-5)
    lane = mine.unbatch()[1].errors
    assert [t for t, _ in lane] == [5, 10, 15, 20]


@pytest.mark.parametrize("kind", ["exact", "flat", "ivf"])
def test_lane_equals_single_lane_run(kind, data, ivf_pair):
    """Lane b of a wave is the port's own `run_mwem` fed lane b's draws."""
    Q, h, _ = data
    index = _indices(kind, data, ivf_pair)[1]
    cfg = MWEMConfig(T=T, mode="exact" if kind == "exact" else "fast",
                     n_records=N, update_rule="signed", tail_cap=8)
    keys = _keys(11)
    wave = run_mwem_batch(Q, h, cfg, _lane_draws(keys), index=index, device=CPU)
    for b, res in enumerate(wave.unbatch()):
        one = run_mwem(Q, h, cfg, JaxDraws.chain(keys[b], T), index=index,
                       device=CPU)
        assert res.selected == one.selected
        assert res.n_scored == one.n_scored
        assert res.overflow_count == one.overflow_count
        np.testing.assert_allclose(res.p_hat.numpy(), one.p_hat.numpy(),
                                   rtol=1e-5, atol=1e-7)
        assert res.final_error == pytest.approx(one.final_error, rel=1e-5)


@pytest.mark.parametrize("kind", ["exact", "flat", "ivf"])
def test_unbatch_and_per_lane_ledgers(kind, data, ivf_pair):
    Q, h, hb = data
    index = _indices(kind, data, ivf_pair)[1]
    cfg = MWEMConfig(T=T, mode="exact" if kind == "exact" else "fast",
                     n_records=N)
    lanes = [PrivacyLedger(), None, PrivacyLedger()]
    wave = run_mwem_batch(Q, hb, cfg, LaneDraws.seeded([0, 1, 2], CPU),
                          index=index, ledgers=lanes, device=CPU)
    assert isinstance(wave, MWEMBatchResult)
    assert wave.p_hat.shape == (B, U) and wave.selected.shape == (B, T)
    events, gamma, slack = release_cost(cfg, M, U, index)
    for lane in (lanes[0], lanes[2]):
        assert lane.events == events
        assert lane.index_failure_mass == gamma and lane.approx_slack == slack
        assert lane.composed() == PrivacyLedger().preview(events, gamma, slack)
    results = wave.unbatch()
    assert [r.ledger for r in results] == lanes
    for b, res in enumerate(results):
        assert res.selected == wave.selected[b].tolist()
        assert res.n_scored == wave.n_scored[b].tolist()
        assert res.iter_seconds == []
        assert torch.equal(res.p_hat, wave.p_hat[b])
        # each lane's error is against its own histogram
        assert res.final_error == float(wave.final_errors[b])
        assert res.final_error == pytest.approx(
            float(np.abs(Q @ (res.p_hat.numpy() - hb[b])).max()), rel=1e-5)
    shared = run_mwem_batch(Q, h, cfg, LaneDraws.seeded([0, 1], CPU),
                            index=index, device=CPU)
    assert all(r.ledger is shared.ledger for r in shared.unbatch())
    assert shared.ledger.composed() == PrivacyLedger().preview(events, gamma, slack)


def test_single_lane_wave(data, ivf_pair):
    ref, mine = _both("ivf", data, ivf_pair, seed=7, lanes=1)
    _assert_same_batch(ref, mine)
    assert mine.selected.shape == (1, T)


def test_run_is_launch_then_finish(data, ivf_pair):
    Q, h, _ = data
    index = ivf_pair[1]
    cfg = MWEMConfig(T=T, n_records=N, tail_cap=4)
    a = run_mwem_batch(Q, h, cfg, LaneDraws.seeded([3, 4], CPU), index=index,
                       device=CPU)
    pending = launch_mwem_batch(Q, h, cfg, [torch.Generator().manual_seed(s)
                                            for s in (3, 4)],
                                index=index, device=CPU)
    b = finish_mwem_batch(pending)
    np.testing.assert_array_equal(a.selected, b.selected)
    np.testing.assert_array_equal(a.n_scored, b.n_scored)
    assert torch.equal(a.p_hat, b.p_hat)


def test_entry_points_need_a_device(data, ivf_pair):
    Q, h, _ = data
    cfg = MWEMConfig(T=2, mode="exact", n_records=N)
    draws = LaneDraws.seeded([0, 1], CPU)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_mwem_batch(Q, h, cfg, draws)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_mwem_batch(Q, h, cfg, draws)


def test_bad_arguments_raise(data, ivf_pair):
    Q, h, hb = data
    cfg = MWEMConfig(T=2, n_records=N)
    draws = LaneDraws.seeded([0, 1], CPU)
    with pytest.raises(ValueError, match="index"):
        run_mwem_batch(Q, h, cfg, draws, device=CPU)
    with pytest.raises(ValueError, match="ledgers"):
        run_mwem_batch(Q, h, cfg, draws, index=ivf_pair[1],
                       ledgers=[PrivacyLedger()], device=CPU)
    with pytest.raises(ValueError, match="per-lane h"):
        run_mwem_batch(Q, hb, cfg, draws, index=ivf_pair[1], device=CPU)
    class SingleProbeIndex:  # a probe of one lane at a time only
        device, approx_margin, failure_mass = CPU, 0.0, 0.0
    with pytest.raises(ValueError, match="cannot probe a wave"):
        run_mwem_batch(Q, h, cfg, draws, index=SingleProbeIndex(), device=CPU)
    with pytest.raises(ValueError, match="at least one lane"):
        LaneDraws([])
    assert len(LaneDraws([TorchDraws.seeded(0, CPU)])) == 1
