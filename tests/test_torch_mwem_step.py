"""K6's cell walk and K2's route plan and cluster reduction, on the CPU.

The CUDA kernels of ``src/repro_torch/csrc/mwem_step.cu`` run only on the
card, where `chip_smoke.py` holds them to their plain versions. Here their
index arithmetic and reduction order are replayed on numpy: the walk's
points of every cell equal ``np.nonzero(cell_map == offset)``, the
multiply-high division is exact, `plan` picks the documented route, and
the cluster route's partition and rank-order reduction match
`mwem_step_ref` at rtol 1e-4 (the tolerance `chip_smoke.py` holds the
kernel to: f32 sums in another order).
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import MarginalWorkload
from repro_torch.kernels.mwem_step import (CHUNK, CLUSTER_U, MAX_CLUSTER,
                                           UPDATE_RULES, mwem_step_ref, plan,
                                           walk_table)
from repro_torch.kernels.mwem_step.ops import MAX_LANES, WALK_COLS, _walk_of

CPU = torch.device("cpu")


# ------------------------------------------------------------ K6 cell walk

def _udiv(u, magic, shift):
    """The kernel's ``__umulhi(u, magic) >> shift`` (``u`` itself when the
    magic is 0, a division by 1) on uint64 arrays."""
    if magic == 0:
        return u
    return ((u * np.uint64(magic)) >> np.uint64(32)) >> np.uint64(shift)


def _walk(row, offsets):
    """Replay of `marginal_gather_score_kernel`'s walk for one clique's
    walk-table row (kmax, WALK_COLS) and its cell offsets: (cells, points)
    domain points, free index r along the second axis."""
    row = row.view(np.uint32).astype(np.uint64)
    inserting = row[:, 3] > 1
    n = int(inserting.sum())
    assert inserting[:n].all(), "inserting columns must lead the row"
    offsets = np.asarray(offsets, np.uint64)[:, None]
    u = np.broadcast_to(np.arange(int(row[0, 5]), dtype=np.uint64),
                        (offsets.shape[0], int(row[0, 5]))).copy()
    for magic, shift, ds, card, cst, _ in row[:n]:
        digit = (offsets // cst) % card        # the block's own divisions
        u = u + _udiv(u, int(magic), int(shift)) * (ds * (card - 1)) + digit * ds
    return u


def _cell_map(card, clique):
    """Independent mixed-radix cell map of one clique (last attribute
    fastest, in the domain and in the clique's own order)."""
    U = int(np.prod(card))
    digits = np.stack(np.unravel_index(np.arange(U), card))
    cm = np.zeros(U, np.int64)
    for a in clique:
        cm = cm * card[a] + digits[a]
    return cm


CASES = {
    "heterogeneous": ((3, 5, 7, 2), [(0, 1, 2, 3), (0, 2), (1, 3), (2,)]),
    "padded": ((3, 5, 7, 2), [(0, 2), (3,), (1, 2, 3), (0, 1)]),
    "descending": ((4, 3, 5, 6, 7, 3), [(5, 3, 1), (3, 0), (4, 2, 1, 0),
                                        (5, 4, 3, 2, 1, 0)]),
    "all-attributes": ((2, 3, 4, 5), [(0, 1, 2, 3), (3, 2, 1, 0)]),
    "one-attribute": ((4, 3, 5, 6), [(0,), (1,), (2,), (3,)]),
    "card-1": ((2, 1, 3, 1, 4), [(1, 3), (0, 1, 4), (3, 2)]),
    "4-way-15-binary": ((2,) * 15, list(itertools.combinations(range(15), 4))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_walk_enumerates_each_cell(case):
    """Over every cell of every clique, the walk's points are exactly the
    cell's points, in ascending order, U / cells of them."""
    card, cliques = CASES[case]
    W = MarginalWorkload(card, cliques, device=CPU)
    table = _walk_of(W).numpy()
    assert table.shape == (W.n_cliques, W.kmax, WALK_COLS)
    cells = W.cl_cells.numpy()
    for c, clique in enumerate(cliques):
        cm = _cell_map(card, clique)
        want = np.argsort(cm, kind="stable").reshape(cells[c], -1)
        got = _walk(table[c], np.arange(cells[c]))
        assert got.shape == (cells[c], W.U // cells[c])
        np.testing.assert_array_equal(got, want)
    # the table's rows list each clique's own attributes, pads inert
    for c, clique in enumerate(cliques):
        real = table[c][table[c][:, 3] > 1]
        assert len(real) == sum(card[a] > 1 for a in clique)
        assert (np.diff(real[:, 2]) > 0).all()  # ascending domain stride


def test_walk_table_is_made_once_a_workload():
    """K6's table is made on a workload's first use, from its clique tables,
    and kept for that workload only; it adds nothing to ``nbytes``, the
    reference's count of the factored representation."""
    card, cliques = CASES["descending"]
    W, W2 = (MarginalWorkload(card, cliques, device=CPU) for _ in range(2))
    before = W.nbytes
    table = _walk_of(W)
    assert _walk_of(W) is table and _walk_of(W2) is not table
    want = walk_table(*(t.numpy() for t in (W.cl_dstride, W.cl_card,
                                            W.cl_stride, W.cl_cells)), W.U)
    np.testing.assert_array_equal(table.numpy(), want)
    assert table.dtype == torch.int32 and W.nbytes == before


@pytest.mark.parametrize("lo,hi", [(1, 5000), (5000, 70000)])
def test_magic_division_is_exact(lo, hi):
    """``u // d`` by multiply-high and shift, for every divisor in
    [lo, hi) and dividends at 0, around multiples of d and up to 2³¹ − 1."""
    d = np.arange(lo, hi, dtype=np.int64)
    tab = walk_table(d[:, None], np.full((len(d), 1), 2), np.ones((len(d), 1)),
                     np.full(len(d), 2), 2)
    magic = tab[:, 0, 0].view(np.uint32).astype(np.uint64)
    shift = tab[:, 0, 1].astype(np.uint64)
    rng = np.random.default_rng(lo)
    du = d.astype(np.uint64)
    top = np.uint64(2**31 - 1)
    for u in (np.zeros_like(du), du - np.uint64(1), du, np.uint64(7) * du + np.uint64(3),
              (top // du) * du - np.uint64(1), (top // du) * du,
              np.full_like(du, top), rng.integers(0, 2**31, len(d)).astype(np.uint64)):
        q = np.where(magic == 0, u, ((u * magic) >> np.uint64(32)) >> shift)
        np.testing.assert_array_equal(q, u // du)


def test_large_divisors_are_exact():
    d = np.array([2**30, 2**30 + 1, 3**19, 2**31 - 1, 1 << 20, 999_983])
    tab = walk_table(d[:, None], np.full((len(d), 1), 2), np.ones((len(d), 1)),
                     np.full(len(d), 2), 2)
    magic = tab[:, 0, 0].view(np.uint32).astype(np.uint64)
    shift = tab[:, 0, 1].astype(np.uint64)
    u = np.random.default_rng(0).integers(0, 2**31, (4096, 1)).astype(np.uint64)
    u = np.concatenate([u, np.full((1, 1), 2**31 - 1, np.uint64)])
    q = ((u * magic) >> np.uint64(32)) >> shift
    np.testing.assert_array_equal(q, u // d.astype(np.uint64))


# --------------------------------------------------------------- K2's plan

@pytest.mark.parametrize("lanes", [1, 8, MAX_LANES])
@pytest.mark.parametrize("U,want", [
    (1, ("cluster", 1)), (16384, ("cluster", 4)),
    (16385, ("cluster", 8)), (32768, ("cluster", 8)),
    (32769, ("multiblock", 17)), (131072, ("multiblock", 64)),
    (131073, ("multiblock", 65)),
])
def test_plan_routes(U, lanes, want):
    assert plan(U, lanes) == want


@pytest.mark.parametrize("U,lanes", [(0, 1), (5, 0), (131073, MAX_LANES + 1)])
def test_plan_rejects(U, lanes):
    with pytest.raises(ValueError):
        plan(U, lanes)


def test_plan_clusters_are_minimal():
    """S is the least power of two whose blocks hold the lane at 4 values a
    thread; a block never holds more than CLUSTER_U / MAX_CLUSTER values;
    the three launches start right past the cluster's reach, and only they
    limit the lanes."""
    block_u = CLUSTER_U // MAX_CLUSTER
    for U in range(1, CLUSTER_U + 1, 997):
        route, S = plan(U, MAX_LANES + 1)
        assert route == "cluster" and S in (1, 2, 4, 8)
        assert S * block_u >= U
        assert S == 1 or S // 2 * block_u < U
        assert all(b > a for a, b in _slices(U, S))  # every block has values
    assert plan(CLUSTER_U, 1) == ("cluster", MAX_CLUSTER)
    assert plan(CLUSTER_U + 1, 1) == ("multiblock", -(-(CLUSTER_U + 1) // CHUNK))


# ------------------------------------------- K2's cluster route, emulated

def _slices(U, S):
    """The launch function's partition: even slices, each a multiple of
    128 elements."""
    slice_ = -(-(-(-U // S)) // 128) * 128
    return [(x * slice_, min(U, (x + 1) * slice_)) for x in range(S)]


def _cluster_step(lw, p, ps, q, h, noise, rule, eta, S):
    """`mwem_step_cluster_kernel` on numpy f32: per-block partial dots and
    softmax pairs (max, sum of exp(x − max)), then every block's
    rank-order reduction of the S partials."""
    f = np.float32
    parts = _slices(lw.shape[0], S)
    lv = lw.copy()
    if rule == "paper":
        lv = lv - f(eta) * q
    else:
        dots = [(np.dot(q[a:b], h[a:b]), np.dot(q[a:b], p[a:b])) for a, b in parts]
        sum_h = sum_p = f(0.0)
        for dh, dp in dots:  # rank order
            sum_h, sum_p = f(sum_h + dh), f(sum_p + dp)
        diff = f(f(sum_h + noise) - sum_p)
        if rule == "signed":
            lv = lv + f(eta) * f(np.sign(diff)) * q
        else:
            lv = lv + q * diff / f(2.0)
    M, Z = f(-np.inf), f(0.0)
    for a, b in parts:  # rank order; an empty slice adds nothing
        if b > a:
            m_b = lv[a:b].max()
            s_b = np.exp(lv[a:b] - m_b).sum(dtype=f)
            mx = max(M, m_b)
            Z = f((Z * np.exp(f(M - mx)) if Z > 0 else f(0.0)) + s_b * np.exp(f(m_b - mx)))
            M = mx
    l2 = lv - M
    pn = np.exp(l2) / Z
    return l2, pn, ps + pn


@pytest.mark.parametrize("rule", UPDATE_RULES)
@pytest.mark.parametrize("U", [1000, 4097, 16384, 16385, 20_000, 32768])
def test_cluster_reduction_matches_ref(U, rule):
    route, S = plan(U, 1)
    assert route == "cluster"
    parts = _slices(U, S)
    assert parts[0][0] == 0 and parts[-1][1] == U
    assert all(b0 == a1 for (_, b0), (a1, _) in zip(parts, parts[1:]))
    assert all(0 < b - a <= CLUSTER_U // MAX_CLUSTER for a, b in parts)
    rng = np.random.default_rng(U)
    lw = rng.standard_normal(U).astype(np.float32)
    lw -= lw.max()
    p = (np.exp(lw) / np.exp(lw).sum()).astype(np.float32)
    ps = rng.random(U).astype(np.float32)
    q = (rng.random(U) < 0.3).astype(np.float32)
    h = rng.dirichlet(np.ones(U)).astype(np.float32)
    noise = np.float32(1e-3)
    got = _cluster_step(lw, p, ps, q, h, noise, rule, 0.3, S)
    want = mwem_step_ref(*(torch.as_tensor(x) for x in (lw, p, ps, q[None])),
                         torch.tensor(0), torch.as_tensor(h),
                         torch.tensor(noise), rule=rule, eta=0.3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-4, atol=1e-7)
