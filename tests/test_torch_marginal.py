"""Factored k-way marginal workloads in the port, held to `repro` on the
same inputs: the `MarginalWorkload` primitives, the K6 tail scorer's plain
version (against the reference's Pallas kernel in interpret mode), the
clique-structured probe and both factored indices, whole `run_mwem` runs
in exact, flat and marginal-IVF mode, the adaptive worst-marginal loop,
and K2's plain path at the factored domains' U (U > 16384).

The workload is heterogeneous on purpose: cards (3, 2, 4, 2) and cliques of
arity 1, 2 and 3, so pad columns (card 1, cell stride 0) and pad cells
(``max_cells`` above a clique's own count) are on every path.

Tolerances: integer tables, cell maps, rows and densified tables are
equal; scores, marginal tables and densities agree to f32
accumulation-order noise (rtol 1e-5, atol 1e-6 for scores of magnitude
≤ 1 summed over ≤ 48 points; rtol 1e-5, atol 1e-7 for densities);
selections, n_scored, overflow counts and ledgers are equal. Equal
selections satisfy the margin rule (compare winners only where the
winner beats the runner-up by more than f32 noise) with room to spare: a
near tie that flipped a winner would fail these tests, and none occurs
at these sizes and seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_core import JaxDraws

from repro.core.adaptive import AdaptiveConfig as RefAdaptiveConfig
from repro.core.adaptive import run_adaptive_marginals as ref_adaptive
from repro.core.mwem import MWEMConfig as RefConfig
from repro.core.mwem import run_mwem as ref_run_mwem
from repro.core.workload import MarginalWorkload as RefMarginal
from repro.core.workload import aug_decompose as ref_aug_decompose
from repro.kernels.ivf_probe import marginal_probe_topk_ref as ref_probe
from repro.kernels.mwem_step.mwem_step import marginal_gather_score_pallas
from repro.kernels.mwem_step.ref import mwem_step_ref as ref_step
from repro.mips import FlatAbsIndex as RefFlat
from repro.mips import MarginalIVFIndex as RefMarginalIVF

from repro_torch import convert
from repro_torch.core import (AdaptiveConfig, MWEMConfig, MarginalWorkload,
                              PrivacyLedger, TorchDraws, aug_decompose,
                              launch_mwem_batch, release_cost,
                              run_adaptive_marginals, run_mwem)
from repro_torch.kernels.ivf_probe import marginal_probe_topk_ref
from repro_torch.kernels.mwem_step import (MAX_U, marginal_gather_score,
                                           marginal_gather_score_ref,
                                           mwem_step, mwem_step_batch)
from repro_torch.mips import FlatAbsIndex, MarginalIVFIndex


CPU = torch.device("cpu")
CARD = (3, 2, 4, 2)                                    # U = 48
CLIQUES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3), (2,), (1, 2, 3),
           (0,), (0, 1, 3)]                            # arity 1, 2 and 3
N, T = 2000, 20


def _pair(card=CARD, cliques=CLIQUES, **kw):
    return (RefMarginal(card, cliques, **kw),
            convert.marginal_workload(card, cliques, device=CPU, **kw))


def _np(x):
    return np.asarray(x)


def _leaves(W):
    """The port's int32 tables in the order of the reference's leaves."""
    return [t.numpy() for t in (W.q_clique, W.q_offset, W.cl_dstride,
                                W.cl_card, W.cl_stride, W.cl_cells)]


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def hist(pair):
    rng = np.random.default_rng(2026)
    U = pair[1].U
    h = rng.dirichlet(np.full(U, 0.4)).astype(np.float32)
    return h


def _probes(U, n, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.dirichlet(np.ones(U)) - rng.dirichlet(np.ones(U))
             ).astype(np.float32) for _ in range(n)]


# --------------------------------------------------------------- primitives

@pytest.mark.parametrize("blocks", [dict(), dict(score_block=16, clique_chunk=3)],
                         ids=["one-block", "chunked"])
def test_primitives_match_reference(blocks):
    """Tables, cell maps, rows, the oracle's blockwise scores, the segment
    sums and everything built on them, with one block and with several."""
    ref, mine = _pair(**blocks)
    for got, want in zip(_leaves(mine),
                         jax.tree_util.tree_leaves(ref)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, _np(want))
    for name in ("m", "U", "n_cliques", "kmax", "max_cells", "n_aug",
                 "dense_nbytes", "nbytes", "score_block", "clique_chunk"):
        assert getattr(mine, name) == getattr(ref, name), name
    cl = np.arange(ref.n_cliques, dtype=np.int32)
    np.testing.assert_array_equal(mine.cell_maps(torch.as_tensor(cl)).numpy(),
                                  _np(ref.cell_maps(jnp.asarray(cl))))
    ids = np.arange(ref.m, dtype=np.int32)
    np.testing.assert_array_equal(mine.rows(torch.as_tensor(ids)).numpy(),
                                  _np(ref.rows(jnp.asarray(ids))))
    np.testing.assert_array_equal(mine.row(5).numpy(), _np(ref.row(5)))
    np.testing.assert_array_equal(mine.densify(), ref.densify())
    for c in range(ref.n_cliques):
        assert mine.clique_slice(c) == ref.clique_slice(c)
    for v in _probes(ref.U, 3):
        tv, jv = torch.as_tensor(v), jnp.asarray(v)
        for fn in ("scores", "marginal_tables", "answer_all", "probe_scores",
                   "clique_abs_err"):
            np.testing.assert_allclose(getattr(mine, fn)(tv).numpy(),
                                       _np(getattr(ref, fn)(jv)),
                                       rtol=1e-5, atol=1e-6, err_msg=fn)
        h = np.abs(v) / np.abs(v).sum()
        p = np.full(ref.U, 1.0 / ref.U, np.float32)
        assert float(mine.max_err(torch.as_tensor(h), torch.as_tensor(p))) == \
            pytest.approx(float(ref.max_err(jnp.asarray(h), jnp.asarray(p))),
                          rel=1e-5)
    # pad cells: 0 in the tables, masked out of the per-clique statistic
    tabs = mine.marginal_tables(torch.as_tensor(_probes(ref.U, 1)[0]))
    pad = (torch.arange(mine.max_cells)[None, :] >= mine.cl_cells[:, None])
    assert bool(pad.any()) and float(tabs[pad].abs().sum()) == 0.0


def test_all_kway_and_construction_errors():
    for k, cap in ((2, None), (3, 2), (1, None)):
        ref = RefMarginal.all_kway(CARD, k, max_cliques=cap)
        mine = MarginalWorkload.all_kway(CARD, k, max_cliques=cap, device=CPU)
        assert mine.cliques == ref.cliques and mine.m == ref.m
        for got, want in zip(_leaves(mine),
                             jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(got, _np(want))
    bad = [[(0, 4)],    # an attribute past the domain's arity
           [(1, 1)],    # a repeated attribute
           []]          # no clique at all
    for cliques in bad:
        with pytest.raises(ValueError):
            RefMarginal(CARD, cliques)
        with pytest.raises(ValueError):
            MarginalWorkload(CARD, cliques, device=CPU)
    with pytest.raises(ValueError):  # k > n_attrs leaves no clique
        MarginalWorkload.all_kway(CARD, 5, device=CPU)


def test_densify_limit_raises(pair):
    ref, mine = pair
    limit = mine.dense_nbytes - 1
    with pytest.raises(ValueError, match="limit"):
        ref.densify(limit)
    with pytest.raises(ValueError, match="limit"):
        mine.densify(limit)
    with pytest.raises(ValueError, match="the sharded driver requires"):
        mine.require_dense("the sharded driver", limit)
    Q = mine.require_dense("a test")
    assert Q.shape == (mine.m, mine.U) and Q.dtype == torch.float32


# ---------------------------------------------------------- K6, plain version

@pytest.mark.parametrize("cliques", [
    [(0, 1), (1, 2), (2, 3), (0, 3)],               # kmax 2, no padding
    [(0, 1), (2,), (0, 2, 3), (1, 3), (3,)],        # arity 1-3: pad columns
    [(1,), (0,), (3,), (2,)],                       # kmax 1
    [(0, 1, 2, 3), (1,), (2, 3)],                   # kmax 4
], ids=["k2", "mixed", "k1", "k4"])
def test_marginal_gather_score_ref_matches_pallas_interpret(cliques):
    """The plain version against the reference's K6 program (interpret
    mode) and against its traceable gather, with − signs, a single
    candidate and inactive slots; atol 1e-5 (sums of ≤ 128 standard
    normals, f32)."""
    card = (2, 4, 4, 4)                                 # U = 128
    ref, mine = _pair(card, cliques)
    v = np.random.default_rng(0).standard_normal(ref.U).astype(np.float32)
    m = ref.m
    for ids in ([1, 7, m - 2, m + 3, 2 * m - 1, 0, m], [m + 1]):
        ids = np.asarray(ids, np.int64)
        base, sign = ids % m, np.where(ids < m, 1.0, -1.0).astype(np.float32)
        cl = _np(ref.q_clique)[base]
        tab = np.concatenate([_np(ref.cl_dstride)[cl], _np(ref.cl_card)[cl],
                              _np(ref.cl_stride)[cl]], axis=1)
        want = _np(marginal_gather_score_pallas(
            jnp.asarray(tab), jnp.asarray(_np(ref.q_offset)[base]),
            jnp.asarray(sign), jnp.asarray(v), kmax=ref.kmax, interpret=True))
        got = marginal_gather_score_ref(mine, torch.as_tensor(v),
                                        torch.as_tensor(ids))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        np.testing.assert_allclose(
            got.numpy(), _np(ref.score_in_graph(jnp.asarray(v),
                                                jnp.asarray(ids))), atol=1e-5)
        active = torch.as_tensor(np.arange(len(ids)) % 2 == 0)
        masked = marginal_gather_score_ref(mine, torch.as_tensor(v),
                                           torch.as_tensor(ids), active)
        np.testing.assert_array_equal(masked.numpy(),
                                      np.where(active.numpy(), got.numpy(), 0))
        none = marginal_gather_score_ref(mine, torch.as_tensor(v),
                                         torch.as_tensor(ids),
                                         torch.zeros(len(ids), dtype=torch.bool))
        assert float(none.abs().sum()) == 0.0


def test_marginal_gather_score_dispatches_to_plain_on_cpu(pair):
    ref, mine = pair
    v = _probes(mine.U, 1)[0]
    ids = np.arange(2 * mine.m)
    before = marginal_gather_score.launches
    got = marginal_gather_score(mine, torch.as_tensor(v), torch.as_tensor(ids))
    assert marginal_gather_score.launches == before  # no kernel on the CPU
    base, sign = aug_decompose(torch.as_tensor(ids), mine.m)
    r_base, r_sign = ref_aug_decompose(jnp.asarray(ids), ref.m)
    np.testing.assert_array_equal(base.numpy(), _np(r_base))
    np.testing.assert_array_equal(sign.numpy(), _np(r_sign))
    np.testing.assert_allclose(got.numpy(), (mine.rows(base) @ torch.as_tensor(v)
                                             * sign).numpy(), atol=1e-6)


# ------------------------------------------------------ probes and indices

def test_marginal_probe_topk_matches_reference(pair):
    ref, mine = pair
    starts = np.concatenate([[0], np.cumsum(_np(ref.cl_cells))[:-1]]
                            ).astype(np.int32)
    for v in _probes(ref.U, 3, seed=11):
        tabs = ref.marginal_tables(jnp.asarray(v))
        for k, nprobe in ((6, ref.n_cliques), (10, 4), (1, 1)):
            a_r, s_r, n_r = ref_probe(tabs, ref.cl_cells, jnp.asarray(starts),
                                      ref.m, k, nprobe)
            a_m, s_m, n_m = marginal_probe_topk_ref(
                torch.as_tensor(np.array(tabs)), mine.cl_cells,
                torch.as_tensor(starts), mine.m, k, nprobe)
            np.testing.assert_array_equal(a_m.numpy(), _np(a_r))
            np.testing.assert_array_equal(s_m.numpy(), _np(s_r))
            assert int(n_m) == int(n_r)
    # exact ties rank to the lower clique, then the lower cell
    tabs = torch.zeros(3, 4)
    tabs[:, 1] = 0.5
    a_m, _, _ = marginal_probe_topk_ref(tabs, torch.tensor([4, 4, 4]),
                                        torch.tensor([0, 4, 8]), 12, 3, 3)
    assert a_m.tolist() == [1, 5, 9]


@pytest.mark.parametrize("kind", ["flat", "mivf"])
def test_factored_index_query_matches_reference(kind, pair):
    ref, mine = pair
    if kind == "flat":
        r_idx, m_idx = RefFlat(ref, use_pallas="never"), FlatAbsIndex(mine, device=CPU)
        assert not m_idx.supports_batch_probe
    else:
        r_idx, m_idx = RefMarginalIVF(ref), MarginalIVFIndex(mine, device=CPU)
        assert m_idx.nprobe == r_idx.nprobe and m_idx.device == CPU
        for k in (3, 8, 40):
            assert m_idx._nprobe_for(k) == r_idx._nprobe_for(k)
    assert m_idx.query_cost(8) == r_idx.query_cost(8)
    assert (m_idx.approx_margin, m_idx.failure_mass) == (0.0, 0.0)
    for v in _probes(ref.U, 3, seed=12):
        for k in (4, 9):
            a_r, s_r = r_idx.query(jnp.asarray(v), k)
            a_m, s_m = m_idx.query(torch.as_tensor(v), k)
            np.testing.assert_array_equal(a_m.numpy(), _np(a_r))
            np.testing.assert_allclose(s_m.numpy(), _np(s_r), rtol=1e-5,
                                       atol=1e-7)


def test_index_construction_errors(pair):
    _, mine = pair
    with pytest.raises(TypeError, match="MarginalWorkload"):
        MarginalIVFIndex(np.zeros((4, 8), np.float32), device=CPU)
    with pytest.raises(ValueError, match="one lane"):
        FlatAbsIndex(mine, device=CPU).query_batch(torch.zeros(2, mine.U), 3)


# --------------------------------------------------------------- whole runs

def _indices(kind, ref_w, mine):
    if kind == "exact":
        return None, None
    if kind == "flat":
        return RefFlat(ref_w, use_pallas="never"), FlatAbsIndex(mine, device=CPU)
    return RefMarginalIVF(ref_w), MarginalIVFIndex(mine, device=CPU)


def _both(kind, pair, hist, seed=1, **cfg):
    ref_w, mine = pair
    ref_index, index = _indices(kind, ref_w, mine)
    mode = "exact" if kind == "exact" else "fast"
    ref = ref_run_mwem(ref_w, jnp.asarray(hist),
                       RefConfig(T=T, mode=mode, n_records=N, driver="host",
                                 use_pallas="never", **cfg),
                       jax.random.PRNGKey(seed), index=ref_index)
    got = run_mwem(mine, convert.tensor(hist, CPU),
                   MWEMConfig(T=T, mode=mode, n_records=N, **cfg),
                   JaxDraws.chain(jax.random.PRNGKey(seed), T), index=index,
                   device=CPU)
    return ref, got


def _assert_same_run(ref, mine):
    assert mine.selected == [int(s) for s in ref.selected]
    assert mine.n_scored == [int(s) for s in ref.n_scored]
    assert mine.overflow_count == ref.overflow_count
    np.testing.assert_allclose(mine.p_hat.numpy(), _np(ref.p_hat),
                               rtol=1e-5, atol=1e-7)
    assert mine.final_error == pytest.approx(ref.final_error, rel=1e-5)
    assert mine.ledger.events == ref.ledger.events
    assert mine.ledger.index_failure_mass == ref.ledger.index_failure_mass
    assert mine.ledger.approx_slack == ref.ledger.approx_slack
    for tight in (False, True):
        assert mine.ledger.composed(tight) == ref.ledger.composed(tight)


@pytest.mark.parametrize("rule", ["paper", "signed", "hardt"])
@pytest.mark.parametrize("kind", ["exact", "flat", "mivf"])
def test_run_matches_reference(kind, rule, pair, hist):
    ref, mine = _both(kind, pair, hist, update_rule=rule)
    _assert_same_run(ref, mine)


@pytest.mark.parametrize("kind", ["flat", "mivf"])
def test_forced_overflow_matches_reference(kind, pair, hist):
    """``tail_cap=1`` overflows (nearly) every step: the redo takes the
    fallback stream and the implicit-row oracle, as the reference does."""
    ref, mine = _both(kind, pair, hist, seed=3, tail_cap=1)
    assert ref.overflow_count > T // 2
    _assert_same_run(ref, mine)
    assert mine.n_scored.count(pair[1].m) == mine.overflow_count


@pytest.mark.parametrize("kind", ["exact", "mivf"])
def test_eval_every_matches_reference(kind, pair, hist):
    ref, mine = _both(kind, pair, hist, seed=4, eval_every=5)
    _assert_same_run(ref, mine)
    assert [t for t, _ in mine.errors] == [t for t, _ in ref.errors]
    np.testing.assert_allclose([e for _, e in mine.errors],
                               [e for _, e in ref.errors], rtol=1e-5)


@pytest.mark.parametrize("kind", ["exact", "flat", "mivf"])
def test_ledger_equals_release_cost(kind, pair, hist):
    _, mine = pair
    index = _indices(kind, pair[0], mine)[1]
    cfg = MWEMConfig(T=T, mode="exact" if kind == "exact" else "fast",
                     n_records=N, update_rule="signed")
    res = run_mwem(mine, torch.as_tensor(hist), cfg, TorchDraws.seeded(0, CPU),
                   index=index, device=CPU)
    preview = PrivacyLedger().preview(*release_cost(cfg, mine.m, mine.U, index))
    assert res.ledger.composed() == preview
    assert res.final_error < float(mine.max_err(
        torch.as_tensor(hist), torch.full((mine.U,), 1.0 / mine.U)))


def test_factored_wave_raises(pair, hist):
    """What a factored wave still refuses: a per-lane h of the wrong shape,
    an index built over another workload, and a fast wave given an index
    without a factored wave probe (`tests/test_torch_marginal_batch.py`
    runs the waves themselves)."""
    _, mine = pair
    draws = [TorchDraws.seeded(0, CPU), TorchDraws.seeded(1, CPU)]
    fast = MWEMConfig(T=2, mode="fast", n_records=N)
    with pytest.raises(ValueError, match="per-lane h"):
        launch_mwem_batch(mine, torch.as_tensor(np.stack([hist] * 3)),
                          MWEMConfig(T=2, mode="exact", n_records=N), draws,
                          device=CPU)
    other = convert.marginal_workload(CARD, CLIQUES, device=CPU)
    for index in (FlatAbsIndex(other, device=CPU),
                  MarginalIVFIndex(other, device=CPU)):
        with pytest.raises(ValueError, match="another workload"):
            launch_mwem_batch(mine, torch.as_tensor(hist), fast, draws,
                              index=index, device=CPU)
    with pytest.raises(ValueError, match="no factored wave probe"):
        launch_mwem_batch(mine, torch.as_tensor(hist), fast, draws,
                          index=FlatAbsIndex(mine.densify(), device=CPU),
                          device=CPU)


# ----------------------------------------------------------- adaptive loop

@pytest.mark.parametrize("T_a", [6, 12])
def test_adaptive_matches_reference(T_a, pair, hist):
    ref_w, mine = pair
    key = jax.random.PRNGKey(4 + T_a)
    ref_led, led = PrivacyLedger(), PrivacyLedger()
    ref = ref_adaptive(ref_w, jnp.asarray(hist),
                       RefAdaptiveConfig(eps=2.0, T=T_a, n_records=5000),
                       key, ledger=ref_led)
    got = run_adaptive_marginals(mine, torch.as_tensor(hist),
                                 AdaptiveConfig(eps=2.0, T=T_a, n_records=5000),
                                 JaxDraws.chain(key, T_a), ledger=led,
                                 device=CPU)
    np.testing.assert_array_equal(got.selected.numpy(), _np(ref.selected))
    assert got.n_scored == int(ref.n_scored)
    np.testing.assert_allclose(got.clique_errors.numpy(),
                               _np(ref.clique_errors), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.p_hat.numpy(), _np(ref.p_hat),
                               rtol=1e-5, atol=1e-7)
    assert float(got.final_error) == pytest.approx(float(ref.final_error),
                                                   rel=1e-5)
    assert led.events == ref_led.events
    assert (got.eps_spent, got.delta_spent) == (ref.eps_spent, ref.delta_spent)
    assert [e[2] for e in led.events] == ["adaptive_em",
                                          "adaptive_measure"] * T_a


def test_adaptive_needs_a_marginal_workload(pair, hist):
    with pytest.raises(TypeError, match="MarginalWorkload"):
        run_adaptive_marginals(np.eye(4, dtype=np.float32), hist,
                               AdaptiveConfig(n_records=10),
                               TorchDraws.seeded(0, CPU), device=CPU)
    with pytest.raises(ValueError, match="n_records"):
        run_adaptive_marginals(pair[1], hist, AdaptiveConfig(),
                               TorchDraws.seeded(0, CPU), device=CPU)


# ------------------------------------- entry points default to the card

def test_entry_points_need_a_device(pair, hist):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MarginalWorkload(CARD, CLIQUES)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.marginal_workload(CARD, CLIQUES)
    _, mine = pair
    for build in (lambda: MarginalIVFIndex(mine), lambda: FlatAbsIndex(mine),
                  lambda: run_adaptive_marginals(
                      mine, hist, AdaptiveConfig(n_records=10),
                      TorchDraws.seeded(0, CPU))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


# ----------------------------------------------------- K2 past U = 16384

@pytest.mark.parametrize("U", [MAX_U + 1, 32768])
@pytest.mark.parametrize("rule", ["paper", "signed", "hardt"])
def test_large_u_step_matches_reference(U, rule):
    """`mwem_step` and `mwem_step_batch` at U > 16384 (one cluster
    launch on the card) take their plain path on the CPU, held to the
    reference's `mwem_step_ref`, one lane and a 3-lane grid with shared
    and per-lane h."""
    rng = np.random.default_rng(U % 97)
    B = 3
    lw = rng.standard_normal((B, U)).astype(np.float32)
    lw -= lw.max(1, keepdims=True)
    p = (np.exp(lw) / np.exp(lw).sum(1, keepdims=True)).astype(np.float32)
    ps = rng.random((B, U)).astype(np.float32)
    Q = (rng.random((5, U)) < 0.3).astype(np.float32)
    hb = rng.dirichlet(np.ones(U), B).astype(np.float32)
    sel = np.array([4, 0, 2])
    noise = np.float32(1e-3) * rng.standard_normal(B).astype(np.float32)
    t = torch.as_tensor

    def ref_lane(b, h):
        return ref_step(jnp.asarray(lw[b]), jnp.asarray(p[b]), jnp.asarray(ps[b]),
                        jnp.asarray(Q[sel[b]]), jnp.asarray(h),
                        jnp.float32(noise[b]), rule=rule, eta=0.3)

    one = mwem_step(t(lw[0]), t(p[0]), t(ps[0]), t(Q), t(sel[0]), t(hb[0]),
                    t(noise[0]), rule=rule, eta=0.3)
    for a, b in zip(one, ref_lane(0, hb[0])):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-7)
    for h in (hb[0], hb):
        got = mwem_step_batch(t(lw), t(p), t(ps), t(Q), t(sel), t(h), t(noise),
                              rule=rule, eta=0.3)
        for b in range(B):
            want = ref_lane(b, h if h.ndim == 1 else h[b])
            for a, w in zip(got, want):
                np.testing.assert_allclose(a[b].numpy(), _np(w), rtol=1e-5,
                                           atol=1e-7)
