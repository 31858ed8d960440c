"""Public wrappers of the fused MWEM step (K2) and the lazy-EM tail scorers
(K3 over a row table, K6 over a factored marginal workload), all in
``csrc/mwem_step.cu``.

K2 has two routes, picked by `plan(U, lanes)`: up to `CLUSTER_U` = 32768
one thread-block cluster of 1, 2, 4 or 8 blocks a lane reduces through
distributed shared memory in one launch; past it three launches run over
`CHUNK`-element slices with per-block partials in a scratch buffer the
wrapper allocates (see the source). `mwem_step` and
`mwem_step_batch` count every call in ``launches``, the calls past
`MAX_U` = 16384 (either route) also in ``launches_multiblock``, and those
of them that took one cluster launch also in ``launches_cluster``.
`mwem_step_batch` runs B lanes in one launch; `gather_score_batch` scores
all B lanes' tails in one K3 launch, on the route `score_plan(U)` picks:
``narrow`` (a thread a candidate, U ≤ `NARROW_U`) or ``split`` (each row
cut into `SEG`-float segments, the active (slot, segment) items shared
evenly among warps, per-segment partials in a scratch buffer); a split
launch scores at most `MAX_SLOTS` slots, so a larger call runs in lane or
column groups (`score_groups`), one launch each. K6 walks
only its candidate's cell, from the workload's `walk_table`, built on the
workload's first K6 call and kept while the workload lives. CPU tensors
run the plain versions of `ref`.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mwem_step.ref import (UPDATE_RULES,
                                               gather_score_batch_ref,
                                               gather_score_ref,
                                               marginal_gather_score_ref,
                                               mwem_step_batch_ref,
                                               mwem_step_ref)

MAX_U = 16384     # the dense paths' U: calls past it count in launches_multiblock
CLUSTER_U = 32768  # most U of one cluster launch: 8 × 1024 threads × 4; mwem_step_cluster_u()
MAX_CLUSTER = 8   # most blocks a cluster; mwem_step_max_cluster()
CHUNK = 2048      # three-launch route: elements a block; mwem_step_chunk()
MAX_LANES = 65535  # lanes of the three-launch route (a grid row each)
NARROW_U = 32     # K3: most U of the narrow route; gather_score_narrow_u()
SEG = 2048        # K3 split route: floats a segment; gather_score_seg()
MAX_SLOTS = 262144  # K3 split route: most lanes × C slots a launch; gather_score_max_slots()
MAX_K = 32        # K6: attributes a clique; marginal_gather_score_max_k()
WALK_COLS = 6     # K6: ints a walk-table column; marginal_gather_score_walk_cols()

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mwem_step")
    lib.mwem_step_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _L,
                                     _I, _F, _P, _P, _P, _I, _P, _P]
    lib.mwem_step_launch.restype = _I
    lib.gather_score_launch.argtypes = [_P, _I, _I, _P, _P, _P, _I, _I, _I,
                                        _P, _P, _L, _P, _P]
    lib.gather_score_launch.restype = _I
    lib.marginal_gather_score_launch.argtypes = [_P, _P, _P, _I, _I, _P, _P,
                                                 _P, _I, _P, _P]
    lib.marginal_gather_score_launch.restype = _I
    for fn, want in (("mwem_step_cluster_u", CLUSTER_U),
                     ("mwem_step_max_cluster", MAX_CLUSTER),
                     ("mwem_step_chunk", CHUNK),
                     ("gather_score_narrow_u", NARROW_U),
                     ("gather_score_seg", SEG),
                     ("gather_score_max_slots", MAX_SLOTS),
                     ("marginal_gather_score_max_k", MAX_K),
                     ("marginal_gather_score_walk_cols", WALK_COLS)):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = _I
        if getattr(lib, fn)() != want:
            raise RuntimeError(f"csrc/mwem_step.cu {fn}() and ops disagree")
    return lib


def plan(U: int, lanes: int) -> tuple[str, int]:
    """K2's route for a (lanes, U) state and its blocks a lane. Up to
    `CLUSTER_U` = 32768, ``("cluster", S)``: one cluster of S = 1, 2, 4 or
    8 blocks a lane, the least power of two whose blocks hold the lane at
    4 values a thread. Past it ``("multiblock", ⌈U / CHUNK⌉)``, the three
    launches, whose lanes are a grid row: more than `MAX_LANES` raise. The
    route depends on U alone, so a wave's lane takes its single-lane
    route."""
    if U < 1 or lanes < 1:
        raise ValueError(f"mwem_step needs U ≥ 1 and lanes ≥ 1, got U={U}, "
                         f"lanes={lanes}")
    if U <= CLUSTER_U:
        S = 1
        while S * CLUSTER_U < U * MAX_CLUSTER:
            S *= 2
        return "cluster", S
    if lanes > MAX_LANES:
        raise ValueError(f"mwem_step's three launches run at most {MAX_LANES} "
                         f"lanes, got {lanes}")
    return "multiblock", -(-U // CHUNK)


def _launch_step(log_w, p, p_sum, q_rows, sel, h, noise, rule, eta, dev):
    """One K2 launch over ``lanes`` = the rows of the (lanes, U) state, on
    `plan`'s route; returns the outputs and the route."""
    lanes, U = log_w.shape
    for name, t in (("log_w", log_w), ("p", p), ("p_sum", p_sum)):
        _build.require(name, t, torch.float32, shape=(lanes, U), device=dev)
    if h.dim() == 1:
        _build.require("h", h, torch.float32, shape=(U,), device=dev)
    else:
        _build.require("h", h, torch.float32, shape=(lanes, U), device=dev)
    _build.require("q_rows", q_rows, torch.float32, shape=(q_rows.shape[0], U),
                   device=dev)
    _build.require("sel", sel, torch.int64, shape=(lanes,), device=dev)
    _build.require("noise", noise, torch.float32, shape=(lanes,), device=dev)
    route, blocks = plan(U, lanes)
    lib = _lib()
    out = [torch.empty_like(log_w) for _ in range(3)]
    scratch = None
    if route == "multiblock":  # partials: two (dots) and two (max, Σexp) a block
        scratch = torch.empty(lanes * blocks * 4, dtype=torch.float32, device=dev)
    err = lib.mwem_step_launch(sel.data_ptr(), log_w.data_ptr(), p.data_ptr(),
                               p_sum.data_ptr(), q_rows.data_ptr(), h.data_ptr(),
                               noise.data_ptr(), lanes, U,
                               0 if h.dim() == 1 else U,
                               UPDATE_RULES.index(rule), float(eta),
                               *(o.data_ptr() for o in out),
                               blocks if route == "cluster" else 0,
                               None if scratch is None else scratch.data_ptr(),
                               _build.stream_ptr(dev))
    _build.check(lib, err, "mwem_step")
    return out, route


def _count(fn, route: str, U: int) -> None:
    """Every call in ``launches``; those past `MAX_U` (either route) also
    in ``launches_multiblock``, and those of them that took one cluster
    launch in ``launches_cluster``."""
    fn.launches += 1
    fn.launches_multiblock += U > MAX_U
    fn.launches_cluster += U > MAX_U and route == "cluster"


def mwem_step(log_w, p, p_sum, q_rows, sel, h, noise, *, rule: str,
              eta: float):
    """Fused step ``(log_w', p', p_sum')`` from winner row ``q_rows[sel]``.

    Args:
      log_w / p / p_sum: (U,) carried state, ``p == softmax(log_w)``.
      q_rows: (R, U) row table; only row ``sel`` is read.
      sel: one-element int64 tensor (on CUDA it stays on the device).
      h: (U,) histogram; noise: one-element f32 realized Laplace noise
        (ignored by ``rule="paper"``).
    """
    if rule not in UPDATE_RULES:
        raise ValueError(f"unknown update rule {rule!r}")
    dev = _build.dispatch_device(log_w, p, p_sum, q_rows, h)
    if dev.type == "cpu":
        return mwem_step_ref(log_w, p, p_sum, q_rows, sel, h, noise, rule=rule,
                             eta=eta)
    _build.require("h", h, torch.float32, shape=log_w.shape, device=dev)
    sel = sel.to(torch.int64).reshape(1)
    noise = torch.as_tensor(noise, dtype=torch.float32, device=dev).reshape(1)
    out, route = _launch_step(log_w.unsqueeze(0), p.unsqueeze(0),
                              p_sum.unsqueeze(0), q_rows, sel, h, noise, rule,
                              eta, dev)
    _count(mwem_step, route, log_w.shape[-1])
    return tuple(o.squeeze(0) for o in out)


mwem_step.launches = 0
mwem_step.launches_multiblock = 0
mwem_step.launches_cluster = 0


def mwem_step_batch(log_w, p, p_sum, q_rows, sel, h, noise, *, rule: str,
                    eta: float):
    """Fused step of a wave: K2 on a (B,) grid, one block a lane.

    Args:
      log_w / p / p_sum: (B, U) carried state, each row ``softmax``-paired.
      q_rows: (R, U) row table; lane b reads row ``sel[b]`` only.
      sel: (B,) int64 winner ids; noise: (B,) f32 realized Laplace noise.
      h: shared (U,) histogram, or (B, U) with one row a lane.

    Lane b's numbers equal those of `mwem_step` on lane b's slice.
    """
    if rule not in UPDATE_RULES:
        raise ValueError(f"unknown update rule {rule!r}")
    dev = _build.dispatch_device(log_w, p, p_sum, q_rows, h)
    if dev.type == "cpu":
        return mwem_step_batch_ref(log_w, p, p_sum, q_rows, sel, h, noise,
                                   rule=rule, eta=eta)
    out, route = _launch_step(log_w, p, p_sum, q_rows, sel.to(torch.int64),
                              h, noise.to(torch.float32), rule, eta, dev)
    _count(mwem_step_batch, route, log_w.shape[-1])
    return tuple(out)


mwem_step_batch.launches = 0
mwem_step_batch.launches_multiblock = 0
mwem_step_batch.launches_cluster = 0


def score_plan(U: int) -> tuple[str, int]:
    """K3's route for rows of U floats and the segments a row is cut into,
    from U alone (never from the candidates or the lanes, so a lane of a
    wave scores as the single-lane call does): ``("narrow", 0)`` up to
    `NARROW_U`, a thread a candidate; else ``("split", ⌈U / SEG⌉)``."""
    if U < 1:
        raise ValueError(f"gather_score needs U ≥ 1, got {U}")
    if U <= NARROW_U:
        return "narrow", 0
    return "split", -(-U // SEG)


def _launch_score(q_rows, V, aug_idx, active, dev):
    m, U = q_rows.shape
    lanes, C = aug_idx.shape
    _build.require("q_rows", q_rows, torch.float32, device=dev)
    _build.require("v", V, torch.float32, shape=(lanes, U), device=dev)
    _build.require("aug_idx", aug_idx, torch.int64, shape=(lanes, C), device=dev)
    if active is not None:
        _build.require("active", active, torch.bool, shape=(lanes, C), device=dev)
    route, nseg = score_plan(U)
    if route == "split" and lanes * C > MAX_SLOTS:
        raise ValueError(f"gather_score scores at most {MAX_SLOTS} slots a "
                         f"launch past U = {NARROW_U}, got {lanes} × {C}")
    lib = _lib()
    out = torch.empty((lanes, C), dtype=torch.float32, device=dev)
    ws = scratch = None
    if nseg > 1:  # a partial a segment, a ticket a slot
        ws = _build.workspace(dev, lanes * C)
        scratch = torch.empty(lanes * C * nseg, dtype=torch.float32, device=dev)
    err = lib.gather_score_launch(q_rows.data_ptr(), m, U, V.data_ptr(),
                                  aug_idx.data_ptr(),
                                  None if active is None else active.data_ptr(),
                                  C, lanes, nseg,
                                  None if scratch is None else scratch.data_ptr(),
                                  None if ws is None else ws.data_ptr(),
                                  0 if ws is None else ws.numel(),
                                  out.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "gather_score")
    return out


def score_groups(U: int, lanes: int, C: int) -> list:
    """The launches K3 takes for ``lanes`` × ``C`` slots of rows of U
    floats: ``(lane_lo, lane_hi, col_lo, col_hi)`` a group. The split route
    scores at most `MAX_SLOTS` slots a launch, so a larger call runs in
    groups of whole lanes that fit, or, when one lane alone holds more than
    `MAX_SLOTS` slots, in column ranges of each lane; the narrow route and
    a call within the limit are one group, the whole of it. Each slot's
    score depends on its own row and lane only, so the groups' outputs put
    together equal the whole call's bit for bit."""
    if score_plan(U)[0] == "narrow" or lanes * C <= MAX_SLOTS:
        return [(0, lanes, 0, C)]
    if C <= MAX_SLOTS:
        step = MAX_SLOTS // C
        return [(b, min(b + step, lanes), 0, C) for b in range(0, lanes, step)]
    return [(b, b + 1, c, min(c + MAX_SLOTS, C))
            for b in range(lanes) for c in range(0, C, MAX_SLOTS)]


def _grouped(fn, q_rows, V, aug_idx, active):
    """``fn`` (one launch's call over (lanes, C) blocks) on each group of
    `score_groups`, the outputs put back in their (lanes, C) places."""
    lanes, C = aug_idx.shape
    groups = score_groups(q_rows.shape[1], lanes, C)
    if len(groups) == 1:
        return fn(q_rows, V, aug_idx, active)
    out = torch.empty((lanes, C), dtype=torch.float32, device=aug_idx.device)
    for b0, b1, c0, c1 in groups:
        out[b0:b1, c0:c1] = fn(
            q_rows, V[b0:b1], aug_idx[b0:b1, c0:c1].contiguous(),
            None if active is None else active[b0:b1, c0:c1].contiguous())
    return out


def gather_score(q_rows, v, aug_idx, active=None):
    """``sign · ⟨q_rows[j % m], v⟩`` for the (C,) augmented ids ``aug_idx``;
    slots whose ``active`` flag is False are not read and score 0. Past
    `MAX_SLOTS` slots on the split route the tail is scored in column
    groups (`score_groups`), one launch each."""
    def one(q_rows, V, aug, act):
        dev = _build.dispatch_device(q_rows, V, aug)
        if dev.type == "cpu":
            return gather_score_ref(q_rows, V[0], aug[0],
                                    None if act is None else act[0])[None]
        out = _launch_score(q_rows, V, aug, act, dev)
        gather_score.launches += 1
        return out

    return _grouped(one, q_rows, v.unsqueeze(0), aug_idx.unsqueeze(0),
                    None if active is None else active.unsqueeze(0)).squeeze(0)


gather_score.launches = 0


def gather_score_batch(q_rows, V, aug_idx, active=None):
    """K3 over a wave: ``out[b, c] = sign · ⟨q_rows[j % m], V[b]⟩`` for
    ``j = aug_idx[b, c]``, all B·C candidates in one launch up to
    `MAX_SLOTS` slots on the split route and in lane (or column) groups of
    `score_groups` past it, one launch each; inactive slots are not read
    and score 0. Lane b equals `gather_score` on its row."""
    def one(q_rows, V, aug, act):
        dev = _build.dispatch_device(q_rows, V, aug)
        if dev.type == "cpu":
            return gather_score_batch_ref(q_rows, V, aug, act)
        out = _launch_score(q_rows, V, aug, act, dev)
        gather_score_batch.launches += 1
        return out

    return _grouped(one, q_rows, V, aug_idx, active)


gather_score_batch.launches = 0


def walk_table(cl_dstride, cl_card, cl_stride, cl_cells, U: int) -> np.ndarray:
    """K6's walk table of a factored workload from its (n_cliques, kmax)
    int32 clique tables: (n_cliques, kmax, `WALK_COLS`) int32 whose column
    is (magic, shift, ds, card, cstride, U / cells) — a clique's attributes
    in ascending domain stride ds, the inert ones (card 1: pads) last, and
    the multiply-high magic number and shift with ``u // ds ==
    (u · magic) >> (32 + shift)`` for every 0 ≤ u < 2³¹ (magic 0 for
    ds = 1; the magic's 32 bits are stored as int32)."""
    ds = np.asarray(cl_dstride, np.int64)
    card = np.asarray(cl_card, np.int64)
    cst = np.asarray(cl_stride, np.int64)
    order = np.lexsort((ds, card <= 1), axis=1)  # inserting first, by ds
    ds, card, cst = (np.take_along_axis(a, order, 1) for a in (ds, card, cst))
    magic = np.zeros_like(ds)
    shift = np.zeros_like(ds)
    for idx in zip(*np.nonzero(ds > 1)):
        d = int(ds[idx])
        bits = (d - 1).bit_length()  # ⌈log2 d⌉
        magic[idx] = ((1 << (31 + bits)) + d - 1) // d
        shift[idx] = bits - 1
    points = np.broadcast_to((U // np.asarray(cl_cells, np.int64))[:, None],
                             ds.shape)
    table = np.stack([magic, shift, ds, card, cst, points], axis=-1)
    return table.astype(np.uint32).view(np.int32)


_WALKS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _walk_of(W) -> torch.Tensor:
    """`walk_table` of the workload ``W`` on its device, made on first use
    and kept while ``W`` lives (its clique tables never change)."""
    table = _WALKS.get(W)
    if table is None:
        table = torch.as_tensor(walk_table(
            *(t.cpu().numpy() for t in (W.cl_dstride, W.cl_card, W.cl_stride,
                                        W.cl_cells)), W.U), device=W.device)
        _WALKS[W] = table
    return table


def marginal_gather_score(W, v, aug_idx, active=None):
    """K6: ``sign · ⟨q_{j % m}, v⟩`` for the (C,) augmented ids ``aug_idx``
    of a factored marginal workload ``W`` (a `MarginalWorkload`: its
    ``q_clique``, ``q_offset`` and `walk_table` are read on the device, and each candidate sums v over its own cell's U / cells points
    only, no row is materialized); slots whose ``active`` flag is False are
    not read and score 0."""
    dev = _build.dispatch_device(W.q_clique, v, aug_idx)
    if dev.type == "cpu":
        return marginal_gather_score_ref(W, v, aug_idx, active)
    if W.kmax > MAX_K:
        raise ValueError(f"marginal_gather_score takes cliques of at most "
                         f"{MAX_K} attributes, got kmax={W.kmax}")
    C = aug_idx.shape[0]
    _build.require("v", v, torch.float32, shape=(W.U,), device=dev)
    _build.require("aug_idx", aug_idx, torch.int64, shape=(C,), device=dev)
    if active is not None:
        _build.require("active", active, torch.bool, shape=(C,), device=dev)
    tables = (W.q_clique, W.q_offset, _walk_of(W))
    _build.require("q_clique", W.q_clique, torch.int32, shape=(W.m,), device=dev)
    _build.require("q_offset", W.q_offset, torch.int32, shape=(W.m,), device=dev)
    _build.require("walk", tables[2], torch.int32,
                   shape=(W.n_cliques, W.kmax, WALK_COLS), device=dev)
    lib = _lib()
    out = torch.empty(C, dtype=torch.float32, device=dev)
    err = lib.marginal_gather_score_launch(
        *(t.data_ptr() for t in tables), W.kmax, W.m, v.data_ptr(),
        aug_idx.data_ptr(), None if active is None else active.data_ptr(), C,
        out.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "marginal_gather_score")
    marginal_gather_score.launches += 1
    return out


marginal_gather_score.launches = 0
