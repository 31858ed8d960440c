"""Public wrappers of the fused MWEM step (K2) and the lazy-EM tail scorers
(K3 over a row table, K6 over a factored marginal workload), all in
``csrc/mwem_step.cu``.

K2 has two routes, chosen by U in the source. Up to `MAX_U` = 16384 one
1024-thread block holds a lane's whole (U,) state in registers; past it
the multi-block route runs three launches over `CHUNK`-element slices
with per-block partials in a scratch buffer the wrapper allocates (see
the source). `mwem_step` and `mwem_step_batch` count every launch in
``launches`` and those of the multi-block route also in
``launches_multiblock``. `mwem_step_batch` runs a (B,) lane grid;
`gather_score_batch` scores all B lanes' tails in one K3 launch. CPU
tensors run the plain versions of `ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mwem_step.ref import (UPDATE_RULES,
                                               gather_score_batch_ref,
                                               gather_score_ref,
                                               marginal_gather_score_ref,
                                               mwem_step_batch_ref,
                                               mwem_step_ref)

MAX_U = 16384  # one-block route: 1024 threads × 16 registers; mwem_step_max_u()
CHUNK = 2048   # multi-block route: elements a block; mwem_step_chunk()
MAX_K = 32     # K6: attributes a clique; marginal_gather_score_max_k()

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mwem_step")
    lib.mwem_step_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _L,
                                     _I, _F, _P, _P, _P, _P, _P]
    lib.mwem_step_launch.restype = _I
    lib.gather_score_launch.argtypes = [_P, _I, _I, _P, _P, _P, _I, _I, _P, _P]
    lib.gather_score_launch.restype = _I
    lib.marginal_gather_score_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I,
                                                 _I, _P, _P, _P, _I, _P, _P]
    lib.marginal_gather_score_launch.restype = _I
    for fn, want in (("mwem_step_max_u", MAX_U), ("mwem_step_chunk", CHUNK),
                     ("marginal_gather_score_max_k", MAX_K)):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = _I
        if getattr(lib, fn)() != want:
            raise RuntimeError(f"csrc/mwem_step.cu {fn}() and ops disagree")
    return lib


def _launch_step(log_w, p, p_sum, q_rows, sel, h, noise, rule, eta, dev):
    """One K2 launch over ``lanes`` = the rows of the (lanes, U) state;
    returns the outputs and whether the multi-block route ran."""
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
    lib = _lib()
    out = [torch.empty_like(log_w) for _ in range(3)]
    multi = U > MAX_U
    scratch = None
    if multi:  # per-block partials: two (dots) and two (max, Σexp) a block
        scratch = torch.empty(lanes * -(-U // CHUNK) * 4, dtype=torch.float32,
                              device=dev)
    err = lib.mwem_step_launch(sel.data_ptr(), log_w.data_ptr(), p.data_ptr(),
                               p_sum.data_ptr(), q_rows.data_ptr(), h.data_ptr(),
                               noise.data_ptr(), lanes, U,
                               0 if h.dim() == 1 else U,
                               UPDATE_RULES.index(rule), float(eta),
                               *(o.data_ptr() for o in out),
                               None if scratch is None else scratch.data_ptr(),
                               _build.stream_ptr(dev))
    _build.check(lib, err, "mwem_step")
    return out, multi


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
    out, multi = _launch_step(log_w.unsqueeze(0), p.unsqueeze(0),
                              p_sum.unsqueeze(0), q_rows, sel, h, noise, rule,
                              eta, dev)
    mwem_step.launches += 1
    mwem_step.launches_multiblock += multi
    return tuple(o.squeeze(0) for o in out)


mwem_step.launches = 0
mwem_step.launches_multiblock = 0


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
    out, multi = _launch_step(log_w, p, p_sum, q_rows, sel.to(torch.int64),
                              h, noise.to(torch.float32), rule, eta, dev)
    mwem_step_batch.launches += 1
    mwem_step_batch.launches_multiblock += multi
    return tuple(out)


mwem_step_batch.launches = 0
mwem_step_batch.launches_multiblock = 0


def _launch_score(q_rows, V, aug_idx, active, dev):
    m, U = q_rows.shape
    lanes, C = aug_idx.shape
    _build.require("q_rows", q_rows, torch.float32, device=dev)
    _build.require("v", V, torch.float32, shape=(lanes, U), device=dev)
    _build.require("aug_idx", aug_idx, torch.int64, shape=(lanes, C), device=dev)
    if active is not None:
        _build.require("active", active, torch.bool, shape=(lanes, C), device=dev)
    lib = _lib()
    out = torch.empty((lanes, C), dtype=torch.float32, device=dev)
    err = lib.gather_score_launch(q_rows.data_ptr(), m, U, V.data_ptr(),
                                  aug_idx.data_ptr(),
                                  None if active is None else active.data_ptr(),
                                  C, lanes, out.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "gather_score")
    return out


def gather_score(q_rows, v, aug_idx, active=None):
    """``sign · ⟨q_rows[j % m], v⟩`` for the (C,) augmented ids ``aug_idx``;
    slots whose ``active`` flag is False are not read and score 0."""
    dev = _build.dispatch_device(q_rows, v, aug_idx)
    if dev.type == "cpu":
        return gather_score_ref(q_rows, v, aug_idx, active)
    out = _launch_score(q_rows, v.unsqueeze(0), aug_idx.unsqueeze(0),
                        None if active is None else active.unsqueeze(0), dev)
    gather_score.launches += 1
    return out.squeeze(0)


gather_score.launches = 0


def gather_score_batch(q_rows, V, aug_idx, active=None):
    """K3 over a wave: ``out[b, c] = sign · ⟨q_rows[j % m], V[b]⟩`` for
    ``j = aug_idx[b, c]``, all B·C candidates in one launch; inactive
    slots are not read and score 0. Lane b equals `gather_score` on its
    row."""
    dev = _build.dispatch_device(q_rows, V, aug_idx)
    if dev.type == "cpu":
        return gather_score_batch_ref(q_rows, V, aug_idx, active)
    out = _launch_score(q_rows, V, aug_idx, active, dev)
    gather_score_batch.launches += 1
    return out


gather_score_batch.launches = 0


def marginal_gather_score(W, v, aug_idx, active=None):
    """K6: ``sign · ⟨q_{j % m}, v⟩`` for the (C,) augmented ids ``aug_idx``
    of a factored marginal workload ``W`` (a `MarginalWorkload`: its
    ``q_clique``, ``q_offset`` and clique tables are read on the device,
    no row is materialized); slots whose ``active`` flag is False are not
    read and score 0."""
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
    tables = (W.q_clique, W.q_offset, W.cl_dstride, W.cl_card, W.cl_stride)
    for name, t in zip(("q_clique", "q_offset", "cl_dstride", "cl_card",
                        "cl_stride"), tables):
        _build.require(name, t, torch.int32, device=dev)
    lib = _lib()
    out = torch.empty(C, dtype=torch.float32, device=dev)
    err = lib.marginal_gather_score_launch(
        *(t.data_ptr() for t in tables), W.kmax, W.m, W.U, v.data_ptr(),
        aug_idx.data_ptr(), None if active is None else active.data_ptr(), C,
        out.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "marginal_gather_score")
    marginal_gather_score.launches += 1
    return out


marginal_gather_score.launches = 0
