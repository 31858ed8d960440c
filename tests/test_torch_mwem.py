"""The slice as a whole: the port's `run_mwem` against `repro.run_mwem` in
exact, flat and IVF mode, for each update rule, and with a one-slot tail
buffer that overflows every step — the same Q, h and key chain on both
sides (the port draws through `JaxDraws`).

Tolerances: selections and n_scored must be equal (at these sizes no
winner is within float noise of its runner-up); ``p_hat`` and
``final_error`` agree to f32 accumulation-order noise (rtol 1e-5, atol
1e-7); the ledgers are equal event for event.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from test_torch_core import JaxDraws

from repro.core.mwem import MWEMConfig as RefConfig
from repro.core.mwem import run_mwem as ref_run_mwem
from repro.mips import FlatAbsIndex as RefFlat
from repro.mips import IVFIndex as RefIVF

from repro_torch import convert
from repro_torch.core import (MWEMConfig, PrivacyLedger, TorchDraws,
                              release_cost, run_mwem)
from repro_torch.core.queries import gaussian_histogram, random_binary_queries
from repro_torch.mips import FlatAbsIndex, IVFIndex, augment_complement

ref_ivf = importlib.import_module("repro.mips.ivf")

CPU = torch.device("cpu")
M, U, N, T = 96, 64, 500, 20


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(2026)
    return random_binary_queries(rng, M, U), gaussian_histogram(rng, N, U)


@pytest.fixture(scope="module")
def ivf_pair(data):
    Q, _ = data
    ref = RefIVF(augment_complement(Q), seed=0, use_pallas="never")
    mine = convert.ivf_index(np.asarray(ref._v), np.asarray(ref._cents),
                             np.asarray(ref._cells), nprobe=ref.nprobe,
                             device=CPU)
    return ref, mine


def _indices(kind, data, ivf_pair):
    Q, _ = data
    if kind == "exact":
        return None, None
    if kind == "flat":
        return RefFlat(Q, use_pallas="never"), FlatAbsIndex(Q, device=CPU)
    return ivf_pair


def _both(kind, data, ivf_pair, seed=1, **cfg):
    Q, h = data
    ref_index, index = _indices(kind, data, ivf_pair)
    mode = "exact" if kind == "exact" else "fast"
    ref = ref_run_mwem(Q, h, RefConfig(T=T, mode=mode, n_records=N, **cfg),
                       jax.random.PRNGKey(seed), index=ref_index)
    key = jax.random.PRNGKey(seed)
    mine = run_mwem(convert.tensor(Q, CPU), convert.tensor(h, CPU),
                    MWEMConfig(T=T, mode=mode, n_records=N, **cfg),
                    JaxDraws.chain(key, T), index=index, device=CPU)
    return ref, mine


def _assert_same_run(ref, mine):
    assert mine.selected == [int(s) for s in ref.selected]
    assert mine.n_scored == [int(s) for s in ref.n_scored]
    assert mine.overflow_count == ref.overflow_count
    np.testing.assert_allclose(mine.p_hat.numpy(), np.asarray(ref.p_hat),
                               rtol=1e-5, atol=1e-7)
    assert mine.final_error == pytest.approx(ref.final_error, rel=1e-5)
    assert mine.ledger.events == ref.ledger.events
    assert mine.ledger.index_failure_mass == ref.ledger.index_failure_mass
    assert mine.ledger.approx_slack == ref.ledger.approx_slack
    for tight in (False, True):
        assert mine.ledger.composed(tight) == ref.ledger.composed(tight)


@pytest.mark.parametrize("rule", ["paper", "signed", "hardt"])
@pytest.mark.parametrize("kind", ["exact", "flat", "ivf"])
def test_run_matches_reference(kind, rule, data, ivf_pair):
    ref, mine = _both(kind, data, ivf_pair, update_rule=rule)
    _assert_same_run(ref, mine)
    assert mine.iter_seconds == []  # no clock on the CPU


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_forced_overflow_matches_reference(kind, data, ivf_pair):
    """``tail_cap=1`` overflows (nearly) every step: the redo must take
    the fallback stream, as the reference does."""
    ref, mine = _both(kind, data, ivf_pair, seed=3, tail_cap=1)
    assert ref.overflow_count > T // 2
    _assert_same_run(ref, mine)
    assert mine.n_scored.count(M) == mine.overflow_count


def test_eval_every_matches_reference(data, ivf_pair):
    ref, mine = _both("flat", data, ivf_pair, seed=4, eval_every=5)
    _assert_same_run(ref, mine)
    assert [t for t, _ in mine.errors] == [t for t, _ in ref.errors]
    np.testing.assert_allclose([e for _, e in mine.errors],
                               [e for _, e in ref.errors], rtol=1e-5)


def test_ivf_build_matches_reference(data):
    """The numpy build is the reference's: same seed, same tables."""
    Q, _ = data
    V = augment_complement(Q)
    ref = RefIVF(V, seed=5, use_pallas="never")
    mine = IVFIndex(V, seed=5, device=CPU)
    assert (mine.nlist, mine.nprobe, mine.cap) == (ref.nlist, ref.nprobe, ref.cap)
    np.testing.assert_array_equal(mine._cents.numpy(), np.asarray(ref._cents))
    np.testing.assert_array_equal(mine.cells, np.asarray(ref._cells))
    assert mine.query_cost(10) == ref.query_cost(10)
    assert mine.failure_mass == ref.failure_mass
    # the device layout: cap padded to a multiple of 8, pad slots empty
    rows, ids = mine._cell_rows, mine._cells8
    assert rows.shape == (ref.nlist, -(-ref.cap // 8) * 8, V.shape[1])
    assert bool((ids[:, ref.cap:] == -1).all())
    valid = ids >= 0
    torch.testing.assert_close(rows[valid], torch.as_tensor(V)[ids[valid].long()])
    assert float(rows[~valid].abs().sum()) == 0.0


def test_ivf_query_matches_reference(data, ivf_pair):
    ref, mine = ivf_pair
    rng = np.random.default_rng(9)
    for _ in range(3):
        v = (rng.dirichlet(np.ones(U)) - rng.dirichlet(np.ones(U))).astype(np.float32)
        i_r, s_r = ref_ivf._query_xla(ref._v, ref._cents, ref._cells,
                                      jax.numpy.asarray(v), 10, ref.nprobe)
        i_m, s_m = mine.query(torch.as_tensor(v), 10)
        np.testing.assert_array_equal(i_m.numpy(), np.asarray(i_r))
        np.testing.assert_allclose(s_m.numpy(), np.asarray(s_r), 1e-5, 1e-7)


@pytest.mark.parametrize("kind", ["exact", "flat", "ivf"])
def test_ledger_equals_release_cost(kind, data, ivf_pair):
    Q, h = data
    index = _indices(kind, data, ivf_pair)[1]
    cfg = MWEMConfig(T=T, mode="exact" if kind == "exact" else "fast",
                     n_records=N, update_rule="signed")
    res = run_mwem(torch.as_tensor(Q), torch.as_tensor(h), cfg,
                   TorchDraws.seeded(0, CPU), index=index, device=CPU)
    preview = PrivacyLedger().preview(*release_cost(cfg, M, U, index))
    assert res.ledger.composed() == preview
    assert res.final_error < float(
        np.abs(Q @ (np.full(U, 1 / U, np.float32) - h)).max())


def test_state_conversion_steps_like_reference(data):
    """A reference state carried across takes the same fused step."""
    from repro.kernels.mwem_step.ref import mwem_step_ref as ref_step
    from repro_torch.kernels.mwem_step import mwem_step

    Q, h = data
    rng = np.random.default_rng(3)
    lw = rng.standard_normal(U).astype(np.float32)
    lw -= lw.max()
    p = (np.exp(lw) / np.exp(lw).sum()).astype(np.float32)
    ps = rng.random(U).astype(np.float32)
    state = convert.mwem_state(lw, ps, CPU)
    jnp = jax.numpy
    ref = ref_step(jnp.asarray(lw), jnp.asarray(p), jnp.asarray(ps),
                   jnp.asarray(Q[7]), jnp.asarray(h), jnp.float32(0.01),
                   rule="hardt", eta=0.2)
    mine = mwem_step(state.log_w, torch.as_tensor(p), state.p_sum,
                     convert.tensor(Q, CPU), torch.tensor(7),
                     convert.tensor(h, CPU), torch.tensor(0.01),
                     rule="hardt", eta=0.2)
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), 1e-5, 1e-7)


def test_entry_points_need_a_device(data):
    Q, h = data
    cfg = MWEMConfig(T=2, mode="exact", n_records=N)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_mwem(Q, h, cfg, TorchDraws.seeded(0, CPU))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FlatAbsIndex(Q)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IVFIndex(augment_complement(Q))


def test_fast_mode_needs_index_on_the_run_device(data):
    Q, h = data
    with pytest.raises(ValueError, match="index"):
        run_mwem(Q, h, MWEMConfig(T=2, n_records=N), TorchDraws.seeded(0, CPU),
                 device=CPU)
    with pytest.raises(ValueError, match="n_records"):
        run_mwem(Q, h, MWEMConfig(T=2, mode="exact"), TorchDraws.seeded(0, CPU),
                 device=CPU)
