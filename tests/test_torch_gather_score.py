"""K3's two routes and `score_plan`, replayed on the CPU.

The CUDA kernels of ``src/repro_torch/csrc/mwem_step.cu`` run only on the
card, where `chip_smoke.py` holds them to their plain versions. Here their
integer logic and order of summation are replayed on numpy and held to the
reference's `repro.core.mwem._aug_score`: the split route's per-block scan
of the flags and its even shares of (segment, rank) items give every
active (slot, segment) item to exactly one warp and no inactive one, and
zero every inactive slot once; each item's dot is summed in the kernel's
register order and the segments in order; the narrow route sums a row in
order. Scores agree within 8·√d·2⁻²⁴·Σ|x·y| (f32 sums in another order),
the tolerance `chip_smoke.py` holds the kernel to.
"""

from __future__ import annotations

import inspect
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mwem as ref_mwem
from repro.core.workload import DenseWorkload as RefDenseWorkload

from repro_torch.kernels.mwem_step import (NARROW_U, SEG, gather_score,
                                           gather_score_batch, score_plan)
from repro_torch.kernels.mwem_step import ops as score_ops
from repro_torch.kernels.mwem_step.ops import MAX_SLOTS, score_groups
F32 = np.float32
WARPS = 8  # warps a split block: kScoreWarps


def _tol(d, mag):
    return 8.0 * np.sqrt(d) * 2.0 ** -24 * mag + 1e-30


# --------------------------------------------------------------- the plans

def test_score_plan_takes_only_U():
    assert list(inspect.signature(score_plan).parameters) == ["U"]
    with pytest.raises(ValueError):
        score_plan(0)


@pytest.mark.parametrize("U", [1, 4, 21, NARROW_U - 1, NARROW_U, NARROW_U + 1,
                               300, SEG - 1, SEG, SEG + 1, 2 * SEG + 1, 2 ** 14,
                               2 ** 15 + 3])
def test_score_plan_routes(U):
    route, nseg = score_plan(U)
    if U <= NARROW_U:
        assert (route, nseg) == ("narrow", 0)
    else:
        assert route == "split" and nseg == -(-U // SEG)
        assert (nseg - 1) * SEG < U <= nseg * SEG


# --------------------------------------------------- the split route's items

def _split_schedule(lanes, C, nseg, sms, active):
    """Replay of `gather_score_split_kernel`'s schedule: with one segment
    and no more slots than warps, warp c takes slot c; else the flags are
    counted by 32-slot chunks and scanned into offsets, the slot of each
    rank found as `active_slot` does (binary search over the chunk offsets,
    then the chunk's set bits), item k = (segment k // n_act, rank
    k % n_act), and warp w of W takes items [w q, w q + q). Returns each
    warp's items (slot, segment) and the slots written 0."""
    total = lanes * C
    W = min(sms, -(-total * nseg // WARPS)) * WARPS
    if nseg == 1 and total <= W:  # a warp a slot, no scan
        shares = [[(c, 0)] if c < total and active[c] else [] for c in range(W)]
        return shares, np.flatnonzero(~active).tolist()
    nch = -(-total // 32)
    assert nch <= MAX_SLOTS // 32
    counts = [int(active[32 * ch:32 * ch + 32].sum()) for ch in range(nch)]
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    def slot_of(r):
        lo, hi = 0, nch
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if off[mid] <= r else (lo, mid)
        on = [32 * lo + i for i in range(32)
              if 32 * lo + i < total and active[32 * lo + i]]
        return on[r - off[lo]]

    n_act = int(off[-1])
    n_items = n_act * nseg
    q = -(-n_items // W) if n_items else 0
    shares = [[(slot_of(k % n_act), k // n_act)
               for k in range(w * q, min(n_items, w * q + q))] for w in range(W)]
    return shares, np.flatnonzero(~active).tolist()


def _actives(kind, lanes, C, rng):
    if kind == "prefix":
        n = rng.integers(0, C + 1)
        return np.tile(np.arange(C) < n, lanes)
    if kind == "random":
        return rng.random(lanes * C) < 0.3
    if kind == "last":
        return np.tile(np.arange(C) == C - 1, lanes)
    return np.full(lanes * C, kind == "all")


@pytest.mark.parametrize("kind", ["prefix", "random", "none", "last", "all"])
@pytest.mark.parametrize("lanes,C,nseg", [(1, 1452, 8), (8, 1452, 8),
                                          (1, 184, 1), (33, 5, 2), (3, 1, 1),
                                          (2, 37, 3), (1, 300, 1),
                                          (8, 1452, 1)])
def test_split_items_cover_the_active_slots_once(kind, lanes, C, nseg):
    rng = np.random.default_rng([lanes, C, nseg])
    active = _actives(kind, lanes, C, rng)
    on = np.flatnonzero(active)
    for sms in (1, 7, 132):
        shares, zeroed = _split_schedule(lanes, C, nseg, sms, active)
        items = [it for share in shares for it in share]
        assert Counter(items) == Counter((int(c), s) for c in on
                                         for s in range(nseg)), sms
        assert zeroed == np.flatnonzero(~active).tolist()
        sizes = [len(share) for share in shares if share]
        assert all(n == sizes[0] for n in sizes[:-1]), sms  # even shares
        # a warp's share runs through ranks in order, one segment at a time
        for share in shares:
            assert share == sorted(share, key=lambda it: (it[1], it[0]))


# ----------------------------------------------------- the routes' arithmetic

def _butterfly_sum(x):
    lanes = np.arange(x.shape[-1])
    for off in (16, 8, 4, 2, 1):
        x = x + x[..., lanes ^ off]
    return x[..., 0]


def _segment_dots(rows, q):
    """`segment_dot` on (n, len) rows of one segment against its (len,)
    probe: lane l's register e holds floats 4j … 4j + 3, j = l + 32e
    (pads 0), its four products are added in order into a[e % 4], the lane
    sums (a0 + a1) + (a2 + a3), and a butterfly sums the lanes."""
    n, length = rows.shape
    x = np.zeros((n, SEG), F32)
    x[:, :length] = rows
    y = np.zeros(SEG, F32)
    y[:length] = q
    pr = (x * y).reshape(n, SEG // 128, 32, 4)           # [item, e, lane, k]
    term = ((pr[..., 0] + pr[..., 1]) + pr[..., 2]) + pr[..., 3]
    a = np.zeros((4, n, 32), F32)
    for e in range(SEG // 128):
        a[e % 4] = a[e % 4] + term[:, e]
    return _butterfly_sum((a[0] + a[1]) + (a[2] + a[3]))


def _split_scores(Q, V, aug, active, sms=132):
    """The split route on (lanes, C) buffers: every item's partial, then
    each active slot's partials summed in segment order, times its sign."""
    m, U = Q.shape
    lanes, C = aug.shape
    _, nseg = score_plan(U)
    shares, zeroed = _split_schedule(lanes, C, nseg, sms, active.reshape(-1))
    items = [it for share in shares for it in share]
    flat = aug.reshape(-1)
    part = np.full((lanes * C, nseg), np.nan, F32)
    for seg in range(nseg):
        cs = np.array([c for c, s in items if s == seg], np.int64)
        if cs.size:
            lo, hi = seg * SEG, min(U, (seg + 1) * SEG)
            # the segment of lane c // C's probe, against each slot's row
            for b in np.unique(cs // C):
                mine = cs[cs // C == b]
                part[mine, seg] = _segment_dots(Q[flat[mine] % m, lo:hi],
                                                V[b, lo:hi])
    out = np.full(lanes * C, np.nan, F32)
    out[zeroed] = 0.0
    for c in np.flatnonzero(active.reshape(-1)):
        s = F32(0)
        for seg in range(nseg):
            s = F32(s + part[c, seg])
        out[c] = s * (F32(1) if flat[c] < m else F32(-1))
    return out.reshape(lanes, C)


def _narrow_scores(Q, V, aug, active):
    """The narrow route: each thread sums its row in order, times its sign."""
    m, U = Q.shape
    lanes, C = aug.shape
    out = np.zeros((lanes, C), F32)
    for b in range(lanes):
        for c in np.flatnonzero(active[b]):
            row = Q[aug[b, c] % m]
            acc = F32(0)
            for e in range(U):
                acc = F32(acc + row[e] * V[b, e])
            out[b, c] = acc * (F32(1) if aug[b, c] < m else F32(-1))
    return out


def _case(U, lanes, C, seed):
    rng = np.random.default_rng([U, lanes, C, seed])
    m = 29
    Q = rng.standard_normal((m, U)).astype(F32)
    V = rng.standard_normal((lanes, U)).astype(F32)
    aug = rng.integers(0, 2 * m, (lanes, C))
    active = rng.random((lanes, C)) < 0.4
    active[:, -1] = True
    return Q, V, aug, active


def _reference(Q, V, aug, active):
    W = RefDenseWorkload(jnp.asarray(Q))
    ref = np.stack([np.asarray(ref_mwem._aug_score(W, jnp.asarray(V[b]),
                                                   jnp.asarray(aug[b])))
                    for b in range(V.shape[0])])
    mag = np.stack([np.abs(Q[aug[b] % Q.shape[0]]) @ np.abs(V[b])
                    for b in range(V.shape[0])])
    return np.where(active, ref, 0.0), mag


@pytest.mark.parametrize("U", [1, 4, 21, NARROW_U, NARROW_U + 1, 300, 301,
                               SEG - 1, SEG, SEG + 1, 2 * SEG + 3, 2 ** 14])
def test_route_replay_matches_reference(U):
    lanes, C = 3, 40
    Q, V, aug, active = _case(U, lanes, C, 0)
    route, _ = score_plan(U)
    if route == "narrow":
        got = _narrow_scores(Q, V, aug, active)
    else:
        got = _split_scores(Q, V, aug, active)
    want, mag = _reference(Q, V, aug, active)
    assert np.array_equal(got[~active], np.zeros((~active).sum(), F32))
    assert np.all(np.abs(got - want) <= _tol(U, mag)), np.abs(got - want).max()
    # the CPU wrapper (the plain version) agrees within the same tolerance
    plain = gather_score_batch(torch.from_numpy(Q), torch.from_numpy(V),
                               torch.from_numpy(aug), torch.from_numpy(active))
    assert np.all(np.abs(plain.numpy() - got) <= 2 * _tol(U, mag))


@pytest.mark.parametrize("U", [300, 301, SEG + 1, 2 ** 14])
def test_wave_lane_equals_single_lane(U):
    """A lane of a wave and the single-lane call on its row give their items
    to other warps but score every item alike: equal bit for bit."""
    lanes, C = 8, 60
    Q, V, aug, active = _case(U, lanes, C, 1)
    wave = _split_scores(Q, V, aug, active)
    for b in range(lanes):
        one = _split_scores(Q, V[b:b + 1], aug[b:b + 1], active[b:b + 1], sms=5)
        assert np.array_equal(one[0], wave[b])


# ------------------------------------------ calls past MAX_SLOTS: in groups

@pytest.mark.parametrize("U,lanes,C,limit", [(300, 5, 70, 262144),
                                             (300, 5, 70, 140),
                                             (300, 5, 70, 64),
                                             (SEG + 1, 192, 3, 64),
                                             (NARROW_U, 5, 70, 7)])
def test_score_groups_cover_each_slot_once(monkeypatch, U, lanes, C, limit):
    """Each (lane, column) slot lies in exactly one group; on the split
    route a group holds at most MAX_SLOTS slots, whole lanes while a lane
    fits and column ranges of one lane past it; the narrow route and a
    call within the limit are one group."""
    monkeypatch.setattr(score_ops, "MAX_SLOTS", limit)
    groups = score_groups(U, lanes, C)
    seen = np.zeros((lanes, C), np.int64)
    for b0, b1, c0, c1 in groups:
        seen[b0:b1, c0:c1] += 1
        if score_plan(U)[0] == "split":
            assert (b1 - b0) * (c1 - c0) <= limit
        assert (c0, c1) == (0, C) or b1 - b0 == 1
    assert (seen == 1).all()
    if score_plan(U)[0] == "narrow" or lanes * C <= limit:
        assert groups == [(0, lanes, 0, C)]


@pytest.mark.parametrize("limit", [140, 64, 7], ids=["two-lanes", "columns-64",
                                                     "columns-7"])
@pytest.mark.parametrize("U", [300, SEG + 1])
def test_grouped_calls_equal_the_whole_call(monkeypatch, U, limit):
    """With MAX_SLOTS forced small, the lane-grouped (140: two lanes a
    group) and column-grouped (64, 7: ranges of one lane) calls equal the
    whole call bit for bit: on the split route's replay with float rows
    (each slot's items are summed alike whoever takes them), and through
    the CPU wrappers with integer-valued rows and probes (the plain
    product's own blocking follows the call's row count, so its float
    sums match only to rounding, checked with `_tol`)."""
    lanes, C = 5, 70
    Q, V, aug, active = _case(U, lanes, C, 3)
    Qi, Vi = np.rint(2 * Q).astype(F32), np.rint(2 * V).astype(F32)
    whole = _split_scores(Q, V, aug, active)
    t = [torch.from_numpy(x) for x in (Qi, Vi, aug, active)]
    tf = [torch.from_numpy(x) for x in (Q, V, aug, active)]
    w_int, w_flt = gather_score_batch(*t), gather_score_batch(*tf)
    w_one = gather_score(t[0], t[1][3], t[2][3], t[3][3])
    monkeypatch.setattr(score_ops, "MAX_SLOTS", limit)
    groups = score_groups(U, lanes, C)
    assert len(groups) > 1
    parts = np.full((lanes, C), np.nan, F32)
    for b0, b1, c0, c1 in groups:
        parts[b0:b1, c0:c1] = _split_scores(Q, V[b0:b1], aug[b0:b1, c0:c1],
                                            active[b0:b1, c0:c1], sms=5)
    assert np.array_equal(parts, whole)
    before = gather_score_batch.launches, gather_score.launches
    assert torch.equal(gather_score_batch(*t), w_int)
    assert torch.equal(gather_score(t[0], t[1][3], t[2][3], t[3][3]), w_one)
    assert torch.equal(w_one, w_int[3])
    got = gather_score_batch(*tf).numpy()
    _, mag = _reference(Q, V, aug, active)
    assert np.all(np.abs(got - w_flt.numpy()) <= 2 * _tol(U, mag))
    assert (gather_score_batch.launches, gather_score.launches) == before
