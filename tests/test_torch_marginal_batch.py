"""Factored marginal waves in the port, held to `repro` on the same inputs:
the `MarginalWorkload` primitives on (B, U) probe blocks (against the
reference's vmapped ones and the port's own lane-by-lane calls), both
factored wave probes (`query_batch_with_scores` against the reference's
vmapped `query_in_graph_with_scores`), and whole `run_mwem_batch` waves
over a `MarginalWorkload` against `repro.run_mwem_batch` on the same key
chains (`JaxDraws.chain`, one a lane) — exact, fast/flat and
fast/marginal-IVF, the three rules, shared and per-lane h, ``tail_cap=1``
so that some lanes overflow, ``eval_every``, B = 1 — and each lane against
the port's own single-lane `run_mwem`.

Workloads: all 3-way marginals over 6 binary attributes (U = 64, m = 160),
and with ``score_block=64`` the same workload past the block, where the
flat probe takes the segment sums instead of the implicit-row product (as
the reference switches); the heterogeneous workload of
`tests/test_torch_marginal.py` (cards (3, 2, 4, 2), arities 1 to 3, pad
columns and pad cells) for the primitives.

Tolerances: probe ids, integer counts and ledgers are equal; scores,
tables and densities agree to f32 accumulation-order noise (rtol 1e-5,
atol 1e-6 for scores, atol 1e-7 for densities). Selections are compared
under the margin rule; at these sizes and seeds no winner lies within f32
noise of its runner-up, so they must be equal, and a flipped near tie
would fail these tests. A wave lane and the single-lane `run_mwem` score
the tail on different routes (the probe's scores against K6's plain
version), so they too are compared under that rule.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_core import JaxDraws

from repro.core.mwem import MWEMConfig as RefConfig
from repro.core.mwem import run_mwem_batch as ref_run_mwem_batch
from repro.core.workload import MarginalWorkload as RefMarginal
from repro.mips import FlatAbsIndex as RefFlat
from repro.mips import MarginalIVFIndex as RefMarginalIVF

from repro_torch import convert
from repro_torch.core import (LaneDraws, MWEMConfig, PrivacyLedger,
                              release_cost, run_mwem, run_mwem_batch)
from repro_torch.kernels.mwem_step import mwem_step_batch
from repro_torch.mips import FlatAbsIndex, MarginalIVFIndex

CPU = torch.device("cpu")
BINARY = ((2,) * 6, list(itertools.combinations(range(6), 3)))  # U 64, m 160
HETERO = ((3, 2, 4, 2), [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3),
                         (2,), (1, 2, 3), (0,), (0, 1, 3)])       # U 48, m 79
N, T, B = 2000, 10, 3


def _pair(spec, **kw):
    card, cliques = spec
    return (RefMarginal(card, cliques, **kw),
            convert.marginal_workload(card, cliques, device=CPU, **kw))


@pytest.fixture(scope="module")
def pairs():
    """The run workload with one block and past it (segment sums)."""
    return {"block": _pair(BINARY), "segments": _pair(BINARY, score_block=64)}


@pytest.fixture(scope="module")
def hists():
    rng = np.random.default_rng(2027)
    return rng.dirichlet(np.full(64, 0.4), B).astype(np.float32)


def _probes(U, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.dirichlet(np.ones(U), n)
            - rng.dirichlet(np.ones(U), n)).astype(np.float32)


# --------------------------------------------------------------- primitives

@pytest.mark.parametrize("spec,kw", [(BINARY, {}),
                                     (BINARY, dict(score_block=64,
                                                   clique_chunk=7)),
                                     (HETERO, {}),
                                     (HETERO, dict(score_block=16,
                                                   clique_chunk=3))],
                         ids=["binary", "binary-chunked", "hetero",
                              "hetero-chunked"])
def test_block_primitives_match_reference(spec, kw):
    """`scores`, `marginal_tables`, `answer_all`, `probe_scores` and
    `max_err` on a (B, U) block: the reference's vmapped calls, and the
    port's lane-by-lane calls, lane for lane."""
    ref, mine = _pair(spec, **kw)
    V = _probes(ref.U, 4, seed=len(kw) + ref.U)
    Vt = torch.as_tensor(V)
    for name in ("scores", "marginal_tables", "answer_all", "probe_scores"):
        got = getattr(mine, name)(Vt)
        want = jax.vmap(getattr(ref, name))(jnp.asarray(V))
        assert tuple(got.shape) == tuple(want.shape), name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        lanes = torch.stack([getattr(mine, name)(Vt[b]) for b in range(4)])
        np.testing.assert_allclose(got.numpy(), lanes.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    P = torch.softmax(torch.as_tensor(_probes(ref.U, 4, seed=9)) * 20, 1)
    h = torch.softmax(torch.as_tensor(_probes(ref.U, 4, seed=10)) * 20, 1)
    for hh, axis in ((h, 0), (h[0], None)):
        got = mine.max_err(hh, P)
        want = jax.vmap(ref.max_err, in_axes=(axis, 0))(jnp.asarray(hh.numpy()),
                                                        jnp.asarray(P.numpy()))
        assert got.shape == (4,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
        for b in range(4):
            one = mine.max_err(hh if axis is None else hh[b], P[b])
            assert float(got[b]) == pytest.approx(float(one), rel=1e-6)


def test_winner_table_of_a_wave(pairs):
    """The B winners' rows as one contiguous (B, U) table with ids
    arange(B), each the implicit row `rows` builds; K2's plain path reads
    lane b's row from it."""
    _, mine = pairs["block"]
    sel = torch.tensor([5, 159, 5, 0])
    rows, ids = mine.winner_table(sel)
    assert rows.is_contiguous() and tuple(rows.shape) == (4, mine.U)
    assert torch.equal(ids, torch.arange(4))
    assert torch.equal(rows, mine.rows(sel))
    one, one_id = mine.winner_table(torch.tensor(7))
    assert tuple(one.shape) == (1, mine.U) and one_id.dim() == 0
    lw = torch.zeros(4, mine.U)
    p = torch.softmax(lw, 1)
    out = mwem_step_batch(lw, p, p.clone(), rows, ids, torch.full(
        (mine.U,), 1.0 / mine.U), torch.zeros(4), rule="paper", eta=0.5)
    for b in range(4):  # paper rule: lw' = −η·row, max-shifted
        want = -0.5 * rows[b] - torch.max(-0.5 * rows[b])
        assert torch.equal(out[0][b], want)


# ------------------------------------------------------------ wave probes

@pytest.mark.parametrize("kind", ["flat", "flat-segments", "mivf"])
def test_wave_probe_matches_reference(kind, pairs):
    ref_w, mine = pairs["segments" if kind == "flat-segments" else "block"]
    if kind == "mivf":
        r_idx, m_idx = RefMarginalIVF(ref_w), MarginalIVFIndex(mine, device=CPU)
        assert not m_idx.supports_batch_probe
    else:
        r_idx = RefFlat(ref_w, use_pallas="never")
        m_idx = FlatAbsIndex(mine, device=CPU)
        assert not m_idx.supports_batch_probe
    assert m_idx.has_full_scores and r_idx.has_full_scores
    assert m_idx.workload is mine
    V = _probes(ref_w.U, 5, seed=13)
    for k in (1, 13, 40):
        a_m, s_m, f_m = m_idx.query_batch_with_scores(torch.as_tensor(V), k)
        a_r, s_r, f_r = jax.vmap(
            lambda v: r_idx.query_in_graph_with_scores(v, k))(jnp.asarray(V))
        assert a_m.dtype == torch.int32 and tuple(a_m.shape) == (5, k)
        np.testing.assert_array_equal(a_m.numpy(), np.asarray(a_r))
        np.testing.assert_allclose(s_m.numpy(), np.asarray(s_r), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(f_m.numpy(), np.asarray(f_r), rtol=1e-5,
                                   atol=1e-7)
        for b in range(5):  # lane b is the single-lane probe
            a1, s1 = m_idx.query(torch.as_tensor(V[b]), k)
            np.testing.assert_array_equal(a_m[b].numpy(), a1.numpy())
            np.testing.assert_allclose(s_m[b].numpy(), s1.numpy(), rtol=1e-5,
                                       atol=1e-7)


def test_dense_flat_index_has_no_factored_wave_probe():
    Q = np.random.default_rng(0).random((12, 8)).astype(np.float32)
    index = FlatAbsIndex(Q, device=CPU)
    assert index.supports_batch_probe and not index.has_full_scores
    with pytest.raises(ValueError, match="query_batch"):
        index.query_batch_with_scores(torch.zeros(2, 8), 3)


# --------------------------------------------------------------- whole waves

def _indices(kind, ref_w, mine):
    if kind == "exact":
        return None, None
    if kind == "flat":
        return RefFlat(ref_w, use_pallas="never"), FlatAbsIndex(mine, device=CPU)
    return RefMarginalIVF(ref_w), MarginalIVFIndex(mine, device=CPU)


def _keys(seed, lanes):
    return [jax.random.PRNGKey(seed + b) for b in range(lanes)]


def _both(kind, pair, hh, seed, lanes=B, **cfg):
    ref_w, mine = pair
    ref_index, index = _indices(kind, ref_w, mine)
    mode = "exact" if kind == "exact" else "fast"
    keys = _keys(seed, lanes)
    ref = ref_run_mwem_batch(ref_w, jnp.asarray(hh),
                             RefConfig(T=T, mode=mode, n_records=N, **cfg),
                             jnp.stack(keys), index=ref_index)
    ledgers = [PrivacyLedger() for _ in range(lanes)]
    mcfg = MWEMConfig(T=T, mode=mode, n_records=N, **cfg)
    got = run_mwem_batch(mine, convert.tensor(hh, CPU), mcfg,
                         LaneDraws([JaxDraws.chain(k, T) for k in keys]),
                         index=index, ledgers=ledgers, device=CPU)
    preview = PrivacyLedger().preview(*release_cost(mcfg, mine.m, mine.U, index))
    assert all(led.composed() == preview for led in ledgers)
    return ref, got


def _assert_same_wave(ref, mine):
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
    assert mine.ledger.approx_slack == ref.ledger.approx_slack
    for tight in (False, True):
        assert mine.ledger.composed(tight) == ref.ledger.composed(tight)
    assert mine.total_seconds == 0.0  # no clock on the CPU


# (kind, workload, rule, per-lane h, extra config, seed, lanes)
WAVES = [
    ("exact", "block", "hardt", True, {}, 1, B),
    ("exact", "segments", "paper", False, {}, 2, B),
    ("flat", "block", "paper", False, {}, 3, B),
    ("flat", "segments", "signed", True, {}, 4, B),
    ("flat", "block", "hardt", True, dict(tail_cap=1), 5, B),
    ("mivf", "block", "signed", True, {}, 6, B),
    ("mivf", "block", "hardt", False, {}, 7, B),
    ("mivf", "segments", "hardt", True, dict(tail_cap=1), 8, B),
    ("flat", "block", "hardt", False, {}, 9, 1),
    ("mivf", "block", "signed", True, {}, 10, 1),
]


@pytest.mark.parametrize("kind,work,rule,per_lane,extra,seed,lanes", WAVES,
                         ids=[f"{w[0]}-{w[1]}-{w[2]}-{'perlane' if w[3] else 'shared'}"
                              f"{'-overflow' if w[4] else ''}-B{w[6]}"
                              for w in WAVES])
def test_wave_matches_reference(kind, work, rule, per_lane, extra, seed, lanes,
                                pairs, hists):
    hh = hists[:lanes] if per_lane else hists[0]
    ref, mine = _both(kind, pairs[work], hh, seed, lanes=lanes,
                      update_rule=rule, **extra)
    _assert_same_wave(ref, mine)
    assert mine.selected.shape == (lanes, T)
    if extra.get("tail_cap") == 1:  # some iterations redo some lanes only
        redo = mine.n_scored == pairs[work][1].m           # (lanes, T)
        assert redo.sum() == mine.overflow_counts.sum()
        assert ((redo.sum(0) > 0) & (redo.sum(0) < lanes)).any()


@pytest.mark.parametrize("kind", ["exact", "mivf"])
def test_wave_eval_every_matches_reference(kind, pairs, hists):
    ref, mine = _both(kind, pairs["block"], hists, 11, update_rule="hardt",
                      eval_every=5)
    _assert_same_wave(ref, mine)
    assert mine.errors.shape == (B, T // 5)
    np.testing.assert_allclose(mine.errors, np.asarray(ref.errors),
                               rtol=1e-5)
    unb = mine.unbatch()
    assert [t for t, _ in unb[0].errors] == [5, 10]


@pytest.mark.parametrize("kind", ["exact", "flat", "mivf"])
def test_wave_lanes_match_single_lane_runs(kind, pairs, hists):
    """Lane b of a factored wave against the port's own single-lane
    `run_mwem` on lane b's draws and histogram."""
    ref_w, mine = pairs["block"]
    index = _indices(kind, ref_w, mine)[1]
    cfg = MWEMConfig(T=T, mode="exact" if kind == "exact" else "fast",
                     n_records=N, update_rule="signed")
    keys = _keys(20, B)
    wave = run_mwem_batch(mine, torch.as_tensor(hists), cfg,
                          LaneDraws([JaxDraws.chain(k, T) for k in keys]),
                          index=index, device=CPU)
    for b, lane in enumerate(wave.unbatch()):
        one = run_mwem(mine, torch.as_tensor(hists[b]), cfg,
                       JaxDraws.chain(keys[b], T), index=index, device=CPU)
        assert lane.selected == one.selected
        assert lane.n_scored == one.n_scored
        np.testing.assert_allclose(lane.p_hat.numpy(), one.p_hat.numpy(),
                                   rtol=1e-5, atol=1e-7)
        assert lane.final_error == pytest.approx(one.final_error, rel=1e-5)
