"""K7, the fused multiplicative-weights update, and the dense Bregman
projection, held to `repro` on the same inputs.

The plain version of K7 (`mwu_update_ref`, what the CPU runs and what
`chip_smoke.py` holds the CUDA kernel to on the card) is compared with the
reference's Pallas program in interpret mode and with its jnp oracle.
Tolerances: ``lw'`` equal bit for bit to the oracle's ``lw + coef·c`` (one
rounded product and one rounded sum either way) and within 1e-6 of the
Pallas program's; ``p`` at rtol 1e-5, atol 1e-8 (a sum of up to 4096
exponentials in another order). The projection agrees to rtol 1e-5, atol
1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bregman import bregman_project_dense as ref_bregman
from repro.kernels.mwu_update.ops import mwu_update as ref_mwu_update
from repro.kernels.mwu_update.ref import mwu_update_ref as ref_mwu_oracle

from repro_torch.core.bregman import bregman_project_dense
from repro_torch.kernels.mwu_update import mwu_update, mwu_update_ref

COEFS = [-0.37, 0.0, 1.5]


def _row(rng, U, scale=3.0):
    return (scale * rng.standard_normal(U)).astype(np.float32)


@pytest.mark.parametrize("coef", COEFS)
@pytest.mark.parametrize("U", [1, 7, 20, 21, 300, 1025, 4096])
def test_plain_matches_reference(U, coef):
    rng = np.random.default_rng([U, 11])
    lw, c = _row(rng, U), _row(rng, U, 1.0)
    lw_o, p_o = ref_mwu_oracle(jnp.asarray(lw), jnp.asarray(c), coef)
    lw_k, p_k = ref_mwu_update(jnp.asarray(lw), jnp.asarray(c), coef,
                               interpret=True)
    out, p, m, s = mwu_update(torch.from_numpy(lw), torch.from_numpy(c), coef)
    np.testing.assert_array_equal(out.numpy(), np.asarray(lw_o))
    np.testing.assert_allclose(out.numpy(), np.asarray(lw_k), rtol=1e-6,
                               atol=1e-6)
    for ref_p in (p_o, p_k):
        np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), rtol=1e-5,
                                   atol=1e-8)
    assert float(m) == float(np.max(np.asarray(lw_o)))
    np.testing.assert_allclose(float(s), float(np.exp(out.numpy() - float(m))
                                               .astype(np.float64).sum()),
                               rtol=1e-5)
    assert m.dim() == 0 and s.dim() == 0


@pytest.mark.parametrize("U", [1, 20, 1025])
def test_lane_grid_equals_rows(U):
    """(B, U) rows, dense and by row id, equal the single-row calls."""
    rng = np.random.default_rng([U, 12])
    B, n = 5, 9
    lw = torch.from_numpy(np.stack([_row(rng, U) for _ in range(B)]))
    table = torch.from_numpy(np.stack([_row(rng, U, 1.0) for _ in range(n)]))
    rows = torch.tensor([3, 0, 8, 3, 5])
    dense = table[rows]
    for coef in COEFS:
        by_id = mwu_update(lw, table, coef, rows=rows)
        by_row = mwu_update(lw, dense, coef)
        for a, b in zip(by_id, by_row):
            assert torch.equal(a, b)
        for b_ in range(B):
            one = mwu_update(lw[b_], dense[b_], coef)
            one_id = mwu_update(lw[b_], table, coef, rows=rows[b_])
            for got, a, c in zip(by_row, one, one_id):
                torch.testing.assert_close(got[b_], a, rtol=1e-6, atol=1e-9)
                assert torch.equal(a, c)


def test_plain_version_is_the_formula():
    lw = torch.tensor([[0.0, -1.0, 2.0], [5.0, 5.0, 5.0]])
    c = torch.tensor([[1.0, 1.0, -1.0], [0.0, 2.0, 0.0]])
    out, p, m, s = mwu_update_ref(lw, c, -0.5)
    assert torch.equal(out, lw - 0.5 * c)
    assert torch.equal(m, out.amax(1))
    torch.testing.assert_close(p, torch.softmax(out, 1))
    torch.testing.assert_close(s, torch.exp(out - m[:, None]).sum(1))


@pytest.mark.parametrize("m,s", [(1, 0.5), (1, 1.0), (13, 1.0), (13, 2.0),
                                 (13, 5.0), (64, 2.0), (64, 12.0),
                                 (300, 5.0), (300, 12.0)])
def test_bregman_matches_reference(m, s):
    rng = np.random.default_rng([m, int(4 * s)])
    a = np.exp(3.0 * rng.standard_normal(m)).astype(np.float32)
    a[rng.random(m) < 0.1] = 0.0       # zero mass is floored, as there
    y = bregman_project_dense(torch.from_numpy(a), s)
    want = np.asarray(ref_bregman(jnp.asarray(a), s))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-8)
    if s > 1:
        assert float(y.max()) <= 1.0 / s * (1 + 1e-5)
    assert float(y.sum()) == pytest.approx(1.0, abs=1e-6)


def test_bregman_caps_dense_tail():
    """A measure with one heavy entry: the projection clips it at 1/s and
    spreads the rest in proportion, as the reference does."""
    a = np.array([1000.0, 1.0, 2.0, 3.0, 4.0], np.float32)
    y = bregman_project_dense(torch.from_numpy(a), 2.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_bregman(
        jnp.asarray(a), 2.0)), rtol=1e-6)
    assert float(y[0]) == pytest.approx(0.5, rel=1e-6)


# ---------------------------------------------- K7's routes, replayed on numpy
#
# The CUDA kernels of csrc/mwu_update.cu run only on the card. Here `plan`
# and each route's placement of values and order of reduction are replayed
# in float32 on numpy and held to the reference's jnp oracle: lw' bit for
# bit, m exactly, s and p at rtol 1e-5 (the tolerances chip_smoke.py holds
# the kernels to on the card).

import inspect

from repro_torch.kernels.mwu_update.ops import (BLOCK_U, GRID_BLOCKS_PER_SM,
                                                GRID_TILE, WARP_U, grid_slice,
                                                plan)

F32 = np.float32
NEG = F32(-np.inf)


def _butterfly(x, op):
    """The kernels' xor-shuffle tree over the last axis (32 lanes): every
    lane ends with the same value."""
    lanes = np.arange(x.shape[-1])
    for off in (16, 8, 4, 2, 1):
        x = op(x, x[..., lanes ^ off])
    return x


def _pair_merge(m, s, m2, s2):
    """`pair_merge`: (max, sum of exp(x - max)) of two parts, either empty."""
    with np.errstate(invalid="ignore"):
        mx = np.maximum(m, m2)
        s = (np.where(s > 0, s * np.exp(m - mx), F32(0))
             + np.where(s2 > 0, s2 * np.exp(m2 - mx), F32(0)))
    return mx, s.astype(F32)


def _values_per(U, threads):
    v = 1
    while v * threads < U:
        v *= 2
    return v


def _in_registers(x, threads):
    """(threads, V): value e of thread t is element e·threads + t, pads -inf."""
    V = _values_per(x.size, threads)
    pad = np.full(V * threads, NEG, F32)
    pad[:x.size] = x
    return pad.reshape(V, threads).T


def _seq_sum(cols):
    """Sum along the last axis one value after another, in float32."""
    s = np.zeros(cols.shape[:-1], F32)
    for e in range(cols.shape[-1]):
        s = s + cols[..., e]
    return s


def _block_reduce(x, op, pad):
    """`block_reduce`: each warp's butterfly, then one butterfly over the
    warps' results (lanes past the warp count hold ``pad``)."""
    w = _butterfly(x.reshape(-1, 32), op)[:, 0]
    red = np.full(32, pad, F32)
    red[:w.size] = w
    return _butterfly(red, op)[0]


def _warp_or_block(x, threads):
    """The warp route (32 threads, butterflies) or the block route (1024,
    block reductions): max, then the sum of exp(x - max), pads exp(-inf) = 0."""
    X = _in_registers(x, threads)
    if threads == 32:
        M = _butterfly(X.max(1), np.maximum)[0]
        ex = np.exp(X - M)
        S = _butterfly(_seq_sum(ex), np.add)[0]
    else:
        M = _block_reduce(X.max(1), np.maximum, NEG)
        ex = np.exp(X - M)
        S = _block_reduce(_seq_sum(ex), np.add, F32(0))
    return M, S, (ex / S).T.reshape(-1)[:x.size]


def _grid(x, S):
    """Both launches of the grid route: each block's running pairs over its
    tiles, merged over the block; then the row's M and Z from the S pairs in
    one fixed order, and p."""
    U, sl, threads, per = x.size, grid_slice(x.size, S), 256, GRID_TILE // 256
    part = np.zeros((S, 2), F32)
    for k in range(S):
        lo, hi = k * sl, min(U, (k + 1) * sl)
        m, s = np.full(threads, NEG, F32), np.zeros(threads, F32)
        for t0 in range(lo, hi, GRID_TILE):
            idx = t0 + np.arange(per)[:, None] * threads + np.arange(threads)
            X = np.where(idx < hi, x[np.minimum(idx, U - 1)], NEG)
            tm = X.max(0)
            has = tm != NEG
            grow = has & (tm > m)
            with np.errstate(invalid="ignore"):  # -inf - -inf where unused
                s = np.where(grow, np.where(s > 0, s * np.exp(m - tm), F32(0)), s)
                m = np.where(grow, tm, m)
                for e in range(per):
                    s = np.where(has, s + np.exp(X[e] - m), s).astype(F32)
        wm, ws = m.reshape(-1, 32), s.reshape(-1, 32)
        for off in (16, 8, 4, 2, 1):
            lanes = np.arange(32) ^ off
            wm, ws = _pair_merge(wm, ws, wm[:, lanes], ws[:, lanes])
        rm, rs = np.full(32, NEG, F32), np.zeros(32, F32)
        rm[:wm.shape[0]], rs[:ws.shape[0]] = wm[:, 0], ws[:, 0]
        for off in (16, 8, 4, 2, 1):
            lanes = np.arange(32) ^ off
            rm, rs = _pair_merge(rm, rs, rm[lanes], rs[lanes])
        part[k] = rm[0], rs[0]
    slots = np.full((-(-S // threads) * threads, 2), [NEG, 0], F32)
    slots[:S] = part
    slots = slots.reshape(-1, threads, 2)          # [round, thread]
    M = _block_reduce(slots[..., 0].max(0), np.maximum, NEG)
    z = np.zeros(threads, F32)
    for r in range(slots.shape[0]):                # thread t: partials t, t + 256, …
        with np.errstate(invalid="ignore"):
            z = z + np.where(slots[r, :, 1] > 0,
                             slots[r, :, 1] * np.exp(slots[r, :, 0] - M), F32(0))
    Z = _block_reduce(z, np.add, F32(0))
    return M, Z, np.exp(x - M) / Z


def test_plan_takes_no_row_count():
    assert list(inspect.signature(plan).parameters) == ["U", "sms"]
    with pytest.raises(ValueError):
        plan(0, 132)


@pytest.mark.parametrize("sms", [1, 2, 66, 132])
def test_plan_routes_by_length(sms):
    edge = GRID_TILE * GRID_BLOCKS_PER_SM * sms
    sizes = {1, 20, 300, 2 ** 20, 2 ** 24 + 7}
    sizes |= {e + d for e in (WARP_U, BLOCK_U, edge, 3 * edge) for d in (-1, 0, 1)}
    for U in sorted(sizes):
        route, S = plan(U, sms)
        want = ("warp" if U <= WARP_U else "block" if U <= BLOCK_U else "grid")
        assert route == want, U
        if route != "grid":
            assert S == 1
            continue
        sl = grid_slice(U, S)
        assert sl % GRID_TILE == 0 and (S - 1) * sl < U <= S * sl, (U, S)
        assert S <= GRID_BLOCKS_PER_SM * sms, (U, S)
        assert S == min(-(-U // GRID_TILE), GRID_BLOCKS_PER_SM * sms) or sl > GRID_TILE


@pytest.mark.parametrize("U,sms", [(1, 132), (20, 132), (21, 132), (33, 132),
                                   (300, 132), (1024, 132), (1025, 132),
                                   (4097, 132), (8192, 132), (8193, 132),
                                   (8193, 1), (50001, 1), (50001, 2),
                                   (2 ** 20 + 3, 132)])
def test_route_replay_matches_reference(U, sms):
    """Each route's arithmetic, replayed, equals the jnp oracle: lw' bit for
    bit (one rounded product, one rounded sum), m exactly, s and p at
    rtol 1e-5; a multi-tile slice (sms = 1, 2) and partials past one a
    thread (2**20 + 3 on 132 SMs: 513 blocks) are covered."""
    rng = np.random.default_rng([U, sms, 13])
    lw, c = _row(rng, U), _row(rng, U, 1.0)
    coef = -0.37
    x = (lw + F32(coef) * c).astype(F32)  # __fadd_rn(lw, __fmul_rn(coef, c))
    lw_o, p_o = ref_mwu_oracle(jnp.asarray(lw), jnp.asarray(c), coef)
    np.testing.assert_array_equal(x, np.asarray(lw_o))
    route, S = plan(U, sms)
    if route == "grid":
        M, Z, p = _grid(x, S)
    else:
        M, Z, p = _warp_or_block(x, 32 if route == "warp" else 1024)
    assert M == np.max(np.asarray(lw_o))
    np.testing.assert_allclose(Z, np.exp(x.astype(np.float64) - M).sum(), rtol=1e-5)
    np.testing.assert_allclose(p, np.asarray(p_o), rtol=1e-5, atol=1e-30)
