"""K4's routes, `probe_plan` and its last-block select, replayed on the CPU.

The CUDA kernels of ``src/repro_torch/csrc/ivf_probe.cu`` run only on the
card, where `chip_smoke.py` holds them to their plain versions. Here their
integer logic and order of summation are replayed on numpy and held to the
reference's `repro.kernels.ivf_probe.ref.ivf_probe_topk_ref`: the split
route's per-block scan of the probed slot ids and its even shares of
(segment, rank) items give every valid (slot, segment) item to exactly one
warp and never read a pad slot, and n_valid is exact; each item's dot is
summed in the kernel's register order and a slot's segments in order; the
narrow route sums a row in order; the last block's select (the 12-bit
threshold read off a histogram, the survivors counting-sorted by digit,
or cut to k by the radix select and ranked by counting) ranks exactly as a
stable sort. Scores agree within
8·√d·2⁻²⁴·Σ|x·y| (f32 sums in another order), the tolerance `chip_smoke.py`
holds the kernel to.
"""

from __future__ import annotations

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ivf_probe.ref import ivf_probe_topk_ref

from repro_torch.kernels.ivf_probe import ivf_probe_stream, ivf_probe_stream_ref
from repro_torch.kernels.ivf_probe import ops as ivf_ops
from repro_torch.kernels.ivf_probe.ops import (CACHE_KEYS, MAX_PROBE, MAX_SLOTS,
                                               NARROW_D, NARROW_THREADS, SEG,
                                               probe_groups, probe_plan)

F32 = np.float32
WARPS = 8        # warps a split block: kWarps
TOP_BITS = 12    # the histogram's digit: sel::kTopBits


def _tol(d, mag):
    return 8.0 * np.sqrt(d) * 2.0 ** -24 * mag + 1e-30


# --------------------------------------------------------------- the plan

@pytest.mark.parametrize("d", [1, 4, 21, NARROW_D, NARROW_D + 1, 300,
                               SEG - 1, SEG, SEG + 1, 2 * SEG + 1, 2 ** 14])
@pytest.mark.parametrize("nprobe,cap", [(1, 40), (10, 368), (8, 1024),
                                        (8, 1025), (16, 512), (5, 1)])
def test_probe_plan_routes(d, nprobe, cap):
    p = probe_plan(nprobe, cap, d, sms=132)
    slots = nprobe * cap
    assert p["slots"] == slots
    assert p["select"] == ("last_block" if slots <= CACHE_KEYS else "finish")
    if d <= NARROW_D:
        assert (p["route"], p["segments"]) == ("narrow", 1)
        assert p["blocks"] == -(-slots // NARROW_THREADS)
        assert (p["scratch"], p["tickets"]) == (slots + -(-slots // 2), 1)
    else:
        nseg = -(-d // SEG)
        assert (p["route"], p["segments"], p["blocks"]) == ("split", nseg, 132)
        assert (nseg - 1) * SEG < d <= nseg * SEG
        parts = slots * nseg if nseg > 1 else 0
        assert p["scratch"] == slots + -(-slots // 2) + -(-parts // 2)  # keys, ids, partials
        assert p["tickets"] == 1 + (slots if parts else 0)


def test_probe_plan_grid_follows_the_sms_not_cap():
    for cap in (40, 368, 2000):
        assert probe_plan(10, cap, 2 ** 14, sms=7)["blocks"] == 7
        assert probe_plan(10, cap, 2 ** 14, sms=132)["blocks"] == 132


def test_probe_plan_limits():
    probe_plan(1, MAX_SLOTS, 33, sms=132)
    probe_plan(MAX_PROBE, 2, 33, sms=132)
    for nprobe, cap, d in ((1, MAX_SLOTS + 1, 33), (MAX_PROBE + 1, 1, 33),
                           (0, 5, 33), (3, 0, 33), (3, 5, 0)):
        with pytest.raises(ValueError):
            probe_plan(nprobe, cap, d, sms=132)


# ------------------------------------------------- the split route's items

def _table(nlist, cap, d, pads, rng, integer=False):
    """Rows (nlist, cap, d) and ids with pads at the end, the start, the
    middle or at random of every cell (pad rows NaN: a read would show)."""
    if integer:
        rows = rng.integers(-2, 3, (nlist, cap, d)).astype(F32)
    else:
        rows = rng.standard_normal((nlist, cap, d)).astype(F32)
    ids = np.arange(nlist * cap, dtype=np.int32).reshape(nlist, cap)
    slot = np.broadcast_to(np.arange(cap), (nlist, cap))
    pad = {"end": slot >= (2 * cap) // 3, "start": slot < cap // 4,
           "middle": (slot >= cap // 3) & (slot < (2 * cap) // 3),
           "random": rng.random((nlist, cap)) < 0.4, "none": slot < 0}[pads]
    ids[pad] = -1
    rows[pad] = np.nan
    return rows, ids


def _scan(probe, ids, cap):
    """Every block's scan: the slot ids read through `probe`, one ballot a
    32-slot chunk into a mask, the counts into exclusive offsets."""
    total = len(probe) * cap
    nch = -(-total // 32)
    valid = np.zeros(nch * 32, bool)
    c = np.arange(total)
    valid[:total] = ids[probe[c // cap], c % cap] >= 0
    masks = valid.reshape(nch, 32)
    off = np.concatenate([[0], np.cumsum(masks.sum(1))])
    return masks, off


def _slot_of_rank(r, masks, off):
    """`slot_of_rank`: binary search over the offsets, then the chunk's set
    bits."""
    lo, hi = 0, len(masks)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if off[mid] <= r else (lo, mid)
    return 32 * lo + int(np.flatnonzero(masks[lo])[r - off[lo]])


def _split_shares(probe, ids, cap, d, blocks):
    """Each warp's items (rank, flat slot, segment), item t = (segment
    t // n_valid, rank t % n_valid), warp w of W taking [w q, w q + q)."""
    masks, off = _scan(probe, ids, cap)
    n_valid = int(off[-1])
    nseg = -(-d // SEG)
    n_items = n_valid * nseg
    W = blocks * WARPS
    q = -(-n_items // W) if n_items else 0
    shares = [[(t % n_valid, _slot_of_rank(t % n_valid, masks, off), t // n_valid)
               for t in range(w * q, min(n_items, w * q + q))] for w in range(W)]
    return shares, n_valid


@pytest.mark.parametrize("pads", ["end", "start", "middle", "random", "none"])
@pytest.mark.parametrize("nprobe,cap,d", [(10, 368, 2 ** 14), (5, 40, 300),
                                          (3, 150, 2049), (1, 7, 33),
                                          (8, 129, 4097)])
def test_split_items_cover_the_valid_slots_once(pads, nprobe, cap, d):
    rng = np.random.default_rng([nprobe, cap, d])
    nlist = nprobe + 3
    _, ids = _table(nlist, cap, 1, pads, rng)
    probe = rng.permutation(nlist)[:nprobe]
    ids[probe[-1]] = -1 if nprobe > 1 else ids[probe[-1]]  # an empty cell
    flat = ids[probe].reshape(-1)
    want = {(int(c), s) for c in np.flatnonzero(flat >= 0)
            for s in range(-(-d // SEG))}
    for blocks in (1, 7, 132):
        shares, n_valid = _split_shares(probe, ids, cap, d, blocks)
        assert n_valid == int((flat >= 0).sum())
        items = [(c, s) for share in shares for _, c, s in share]
        assert Counter(items) == Counter(want), blocks  # once each, no pad
        sizes = [len(share) for share in shares if share]
        assert all(n == sizes[0] for n in sizes[:-1])  # even shares
        for share in shares:  # ranks in order, one segment at a time
            assert share == sorted(share, key=lambda it: (it[2], it[0]))
        ranks = {c: r for share in shares for r, c, _ in share}
        assert sorted(ranks.values()) == list(range(n_valid))
        assert [c for c, _ in sorted(ranks.items(), key=lambda kv: kv[1])] \
            == sorted(ranks)  # a slot's rank follows its flat position


# ----------------------------------------------------- the routes' scores

def _butterfly_sum(x):
    lanes = np.arange(x.shape[-1])
    for off in (16, 8, 4, 2, 1):
        x = x + x[..., lanes ^ off]
    return x[..., 0]


def _segment_dots(rows, q):
    """`segment_sum` on (n, len) row segments against a (len,) probe
    segment: lane l's register e holds floats 4j … 4j + 3, j = l + 32e
    (pads 0), its four products are added in order into a[e % 4], the lane
    sums (a0 + a1) + (a2 + a3), and a butterfly sums the lanes."""
    n, length = rows.shape
    x = np.zeros((n, SEG), F32)
    x[:, :length] = rows
    y = np.zeros(SEG, F32)
    y[:length] = q
    pr = (x * y).reshape(n, SEG // 128, 32, 4)
    term = ((pr[..., 0] + pr[..., 1]) + pr[..., 2]) + pr[..., 3]
    a = np.zeros((4, n, 32), F32)
    for e in range(SEG // 128):
        a[e % 4] = a[e % 4] + term[:, e]
    return _butterfly_sum((a[0] + a[1]) + (a[2] + a[3]))


def _scores(rows, ids, probe, q):
    """The kernel's score of every valid flat slot (others NaN): the narrow
    route's in-order row sum, or the split route's segment partials summed
    in segment order."""
    nlist, cap, d = rows.shape
    flat_rows = rows[probe].reshape(-1, d)
    valid = ids[probe].reshape(-1) >= 0
    out = np.full(valid.shape, np.nan, F32)
    on = np.flatnonzero(valid)
    if d <= NARROW_D:
        acc = np.zeros(on.size, F32)
        for e in range(d):
            acc = F32(acc + flat_rows[on, e] * q[e])
        out[on] = acc
        return out
    nseg = -(-d // SEG)
    part = np.stack([_segment_dots(flat_rows[on, s * SEG:(s + 1) * SEG],
                                   q[s * SEG:(s + 1) * SEG])
                     for s in range(nseg)], 1)
    acc = np.zeros(on.size, F32)
    for s in range(nseg):
        acc = F32(acc + part[:, s])
    out[on] = acc
    return out


def _top_k(scores, ids_flat, k):
    """Ids and scores of the top k by a stable sort on (score desc, flat
    slot asc) over the valid slots, padded with −1 / −inf."""
    on = np.flatnonzero(~np.isnan(scores))
    order = on[np.lexsort((on, -scores[on].astype(np.float64)))][:k]
    ids = np.full(k, -1, np.int32)
    sc = np.full(k, -np.inf, F32)
    ids[:order.size] = ids_flat[order]
    sc[:order.size] = scores[order]
    return ids, sc


def _ref_probe(cents, q, nprobe):
    """The reference's probe order: the top-nprobe centroid scores, ties to
    the lower cell (a stable sort, as `jax.lax.top_k`)."""
    cs = cents @ q
    return np.argsort(-cs, kind="stable")[:nprobe]


@pytest.mark.parametrize("d", [1, 4, 21, NARROW_D, NARROW_D + 1, 300, 2047,
                               SEG, SEG + 1, 2 ** 14])
@pytest.mark.parametrize("pads", ["middle", "random"])
def test_route_replay_matches_reference(d, pads):
    rng = np.random.default_rng([d, len(pads)])
    nlist, cap, nprobe = (9, 24, 4) if d > 2000 else (14, 40, 5)
    rows, ids = _table(nlist, cap, d, pads, rng)
    cents = rng.standard_normal((nlist, d)).astype(F32)
    q = rng.standard_normal(d).astype(F32)
    probe = _ref_probe(cents, q, nprobe)
    ids[probe[1]] = -1  # a probed cell without a valid slot
    n_valid = int((ids[probe] >= 0).sum())
    flat_ids = ids[probe].reshape(-1)
    scores = _scores(rows, ids, probe, q)
    mag = float(np.nanmax(np.abs(np.nan_to_num(rows[probe].reshape(-1, d)))
                          @ np.abs(q)))
    V = np.nan_to_num(rows).reshape(-1, d)  # the reference reads a flat table
    cells = np.where(ids >= 0, ids, -1)
    for k in sorted({1, n_valid, n_valid + 5, nprobe * cap}):
        got_ids, got_s = _top_k(scores, flat_ids, k)
        r_ids, r_s, r_n = ivf_probe_topk_ref(jnp.asarray(cents), jnp.asarray(cells),
                                             jnp.asarray(V), jnp.asarray(q), k, nprobe)
        r_ids, r_s = np.asarray(r_ids), np.asarray(r_s)
        assert int(r_n) == n_valid
        fin = np.isfinite(r_s)
        assert np.array_equal(np.isfinite(got_s), fin)
        assert np.all(np.abs(got_s[fin] - r_s[fin]) <= _tol(d, mag))
        assert np.array_equal(got_ids[~fin], r_ids[~fin])
        for i in np.flatnonzero(got_ids != r_ids):  # only where a near tie explains it
            assert np.sum(np.abs(r_s[fin] - r_s[i]) <= 2 * _tol(d, mag)) >= 2
        # the CPU wrapper (the plain version) agrees with both
        p_ids, p_s, p_n = ivf_probe_stream(torch.from_numpy(probe.astype(np.int32)),
                                           torch.from_numpy(rows), torch.from_numpy(ids),
                                           torch.from_numpy(q), k)
        assert int(p_n) == n_valid
        assert np.all(np.abs(p_s.numpy()[fin] - got_s[fin]) <= 2 * _tol(d, mag))


@pytest.mark.parametrize("d", [8, 300, SEG + 1])
def test_integer_ties_follow_probe_then_slot_order(d):
    rng = np.random.default_rng(d)
    rows, ids = _table(12, 30, d, "middle", rng, integer=True)
    q = rng.integers(-2, 3, d).astype(F32)
    probe = np.array([7, 2, 11, 0])
    scores = _scores(rows, ids, probe, q)
    for k in (1, 25, 200):
        got = _top_k(scores, ids[probe].reshape(-1), k)
        want = ivf_probe_stream_ref(torch.from_numpy(probe.astype(np.int32)),
                                    torch.from_numpy(rows), torch.from_numpy(ids),
                                    torch.from_numpy(q), k)
        assert np.array_equal(got[0], want[0].numpy())
        assert np.array_equal(got[1], want[1].numpy())


# ------------------------------------------------- the last block's select

def _keys(scores, ties):
    """`rt::make_key`: the order-preserving image of the score (−0 folded
    onto +0) above 0xFFFFFFFF − tie."""
    s = np.where(scores == 0, F32(0), scores).astype(F32).view(np.uint32)
    ord_ = np.where(s & np.uint32(0x80000000), ~s, s | np.uint32(0x80000000))
    return (ord_.astype(np.uint64) << np.uint64(32)) | \
        (np.uint64(0xFFFFFFFF) - ties.astype(np.uint64))


def _select_last(keys, k, T):
    """The last block: the 12-bit digit of the k-th largest read off the
    histogram (0 when it counts at most k keys), the survivors at or above
    it; up to 2·T of them counting-sorted by digit (a key's rank: the keys
    of larger digits, then the larger keys of its own digit), more cut to
    exactly k by the radix select and ranked by counting."""
    top = (keys >> np.uint64(64 - TOP_BITS)).astype(np.int64)
    hist = np.bincount(top, minlength=1 << TOP_BITS)
    above = np.cumsum(hist[::-1])[::-1]  # keys at or above each digit
    hit = np.flatnonzero(above >= k)
    digit = int(hit[-1]) if keys.size > k else 0
    surv = keys[top >= digit]
    assert surv.size >= min(k, keys.size)
    if surv.size <= 2 * T:  # `digit_sort_top_k`
        d = (surv >> np.uint64(64 - TOP_BITS)).astype(np.int64)
        count = np.bincount(d, minlength=1 << TOP_BITS)
        start = np.concatenate([np.cumsum(count[::-1])[::-1][1:], [0]])  # larger digits
        order = np.argsort(-d, kind="stable")  # the scatter: groups in digit order
        grouped, gd = surv[order], d[order]
        rank = np.array([start[g] + int((grouped[gd == g] > key).sum())
                         for key, g in zip(grouped, gd)], np.int64)
    else:  # the radix select's exactly k, then `block_rank`
        grouped = np.sort(surv)[::-1][:k]
        rank = (grouped[None, :] > grouped[:, None]).sum(1)
    ranked = np.zeros(min(k, surv.size), np.uint64)
    ranked[rank[rank < k]] = grouped[rank < k]
    return ranked, surv.size


@pytest.mark.parametrize("n,k,T", [(980, 256, 256), (2800, 512, 512),
                                   (3680, 1, 256), (300, 300, 256),
                                   (0, 16, 256), (8192, 8192, 256),
                                   (5000, 64, 512), (40, 100, 512)])
@pytest.mark.parametrize("kind", ["normal", "ties", "signed zeros"])
def test_last_block_select_equals_a_stable_sort(n, k, T, kind):
    rng = np.random.default_rng([n, k, T])
    if kind == "normal":
        scores = rng.standard_normal(n).astype(F32)
    elif kind == "ties":
        scores = rng.integers(-3, 4, n).astype(F32)
    else:
        scores = np.where(rng.random(n) < 0.5, F32(0.0), F32(-0.0))
    ties = rng.permutation(4 * n + 1)[:n].astype(np.uint32)  # distinct positions
    keys = _keys(scores, ties)
    got, n_surv = _select_last(keys, k, T)
    order = np.lexsort((ties, -scores.astype(np.float64)))[:k]
    assert np.array_equal(got, keys[order])
    if kind == "normal" and n > 2 * k:
        assert n_surv <= k + n // 8  # the threshold digit's bin is small


# ------------------------------------ probes past the limits: in groups

@pytest.mark.parametrize("nprobe,cap,slots,probes", [
    (13, 6, MAX_SLOTS, 4), (13, 10, 25, MAX_PROBE), (3, 40, 16, MAX_PROBE),
    (2, 1, 1, 1), (5, 8, 8, MAX_PROBE)])
def test_probe_groups_cover_the_probe_once(monkeypatch, nprobe, cap, slots,
                                           probes):
    """Each probed (cell, slot) lies in exactly one group, in probe order;
    a group fits `probe_plan`'s limits (runs of whole cells, or slot ranges
    of one cell larger than MAX_SLOTS); within the limits, one group."""
    monkeypatch.setattr(ivf_ops, "MAX_SLOTS", slots)
    monkeypatch.setattr(ivf_ops, "MAX_PROBE", probes)
    groups = probe_groups(nprobe, cap)
    order = [(i, s) for first, last, lo, hi in groups
             for i in range(first, last) for s in range(lo, hi)]
    assert order == [(i, s) for i in range(nprobe) for s in range(cap)]
    for first, last, lo, hi in groups:
        probe_plan(last - first, hi - lo, 33, sms=132)  # within the limits
    if nprobe * cap <= slots and nprobe <= probes:
        assert groups == [(0, nprobe, 0, cap)]


@pytest.mark.parametrize("integer", [False, True], ids=["float", "ties"])
@pytest.mark.parametrize("nlist,cap,nprobe,slots,probes", [
    (20, 6, 13, MAX_SLOTS, 4),    # runs of 4 cells: MAX_PROBE
    (16, 10, 9, 25, MAX_PROBE),   # runs of 2 cells: MAX_SLOTS
    (6, 40, 3, 16, MAX_PROBE),    # each cell in slot ranges of 16
])
def test_grouped_probe_equals_ungrouped_and_reference(
        monkeypatch, integer, nlist, cap, nprobe, slots, probes):
    """With MAX_SLOTS and MAX_PROBE forced small, a probe runs in groups
    whose top-ks merge into the ungrouped probe's — ids equal (with integer
    rows, exact ties ranked in probe then slot order, and the scores bit
    for bit), n_valid equal — and into the reference's
    `ivf_probe_topk_ref`, for k from 1 past n_valid (above every group's
    valid rows, so −1 pads come last) up to every slot."""
    rng = np.random.default_rng([nlist, cap, nprobe, int(integer)])
    d = 8
    rows, ids = _table(nlist, cap, d, "random", rng, integer=integer)
    cents = rng.standard_normal((nlist, d)).astype(F32)
    q = (rng.integers(-2, 3, d) if integer else rng.standard_normal(d)).astype(F32)
    probe = _ref_probe(cents, q, nprobe)
    n_valid = int((ids[probe] >= 0).sum())
    args = [torch.from_numpy(x) for x in (probe.astype(np.int32), rows, ids, q)]
    V = np.nan_to_num(rows).reshape(-1, d)
    ks = sorted({1, 7, n_valid, n_valid + 5, nprobe * cap})
    whole = {k: ivf_probe_stream(*args, k) for k in ks}
    monkeypatch.setattr(ivf_ops, "MAX_SLOTS", slots)
    monkeypatch.setattr(ivf_ops, "MAX_PROBE", probes)
    assert len(probe_groups(nprobe, cap)) > 1
    before = ivf_probe_stream.launches
    for k in ks:
        g_ids, g_s, g_n = ivf_probe_stream(*args, k)
        w_ids, w_s, w_n = whole[k]
        assert g_ids.dtype == torch.int32 and g_ids.shape == (k,)
        assert torch.equal(g_ids, w_ids) and int(g_n) == int(w_n) == n_valid
        if integer:
            assert torch.equal(g_s, w_s)
        else:
            np.testing.assert_allclose(g_s.numpy(), w_s.numpy(), rtol=1e-6)
        r_ids, r_s, r_n = ivf_probe_topk_ref(
            jnp.asarray(cents), jnp.asarray(ids), jnp.asarray(V),
            jnp.asarray(q), k, nprobe)
        np.testing.assert_array_equal(g_ids.numpy(), np.asarray(r_ids))
        np.testing.assert_allclose(g_s.numpy(), np.asarray(r_s), rtol=1e-6,
                                   atol=1e-6)
        assert int(r_n) == n_valid
        if k > n_valid:
            assert (g_ids[n_valid:] == -1).all() and torch.isneginf(g_s[n_valid:]).all()
    assert ivf_probe_stream.launches == before  # the CPU runs no kernel
