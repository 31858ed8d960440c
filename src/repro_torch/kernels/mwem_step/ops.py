"""Public wrappers of the fused MWEM step (K2) and the lazy-EM tail scorer
(K3), both in ``csrc/mwem_step.cu``.

K2 holds a lane's whole (U,) state in the registers of one 1024-thread
block, 16 values a thread, so it takes U ≤ `MAX_U` = 16384 and raises
above that — there is no other route. CPU tensors run the plain versions
of `ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mwem_step.ref import (UPDATE_RULES, gather_score_ref,
                                               mwem_step_ref)

MAX_U = 16384  # 1024 threads × 16 registers; mwem_step_max_u() in the source

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("mwem_step")
    lib.mwem_step_max_u.argtypes = []
    lib.mwem_step_max_u.restype = _I
    lib.mwem_step_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F,
                                     _P, _P, _P, _P]
    lib.mwem_step_launch.restype = _I
    lib.gather_score_launch.argtypes = [_P, _I, _I, _P, _P, _P, _I, _P, _P]
    lib.gather_score_launch.restype = _I
    if lib.mwem_step_max_u() != MAX_U:
        raise RuntimeError("csrc/mwem_step.cu and ops.MAX_U disagree")
    return lib


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
    U = log_w.shape[0]
    if U > MAX_U:
        raise ValueError(f"mwem_step kernel holds U <= {MAX_U} (1024 threads "
                         f"x 16 values in registers); got U={U}")
    sel = sel.to(torch.int64).reshape(1)
    noise = torch.as_tensor(noise, dtype=torch.float32, device=dev).reshape(1)
    for name, t in (("log_w", log_w), ("p", p), ("p_sum", p_sum), ("h", h)):
        _build.require(name, t, torch.float32, shape=(U,), device=dev)
    _build.require("q_rows", q_rows, torch.float32, shape=(q_rows.shape[0], U))
    _build.require("sel", sel, torch.int64, device=dev)
    _build.require("noise", noise, torch.float32, device=dev)
    lib = _lib()
    out = [torch.empty_like(log_w) for _ in range(3)]
    err = lib.mwem_step_launch(sel.data_ptr(), log_w.data_ptr(), p.data_ptr(),
                               p_sum.data_ptr(), q_rows.data_ptr(), h.data_ptr(),
                               noise.data_ptr(), U, UPDATE_RULES.index(rule),
                               float(eta), *(o.data_ptr() for o in out),
                               _build.stream_ptr(dev))
    _build.check(lib, err, "mwem_step")
    mwem_step.launches += 1
    return tuple(out)


mwem_step.launches = 0


def gather_score(q_rows, v, aug_idx, active=None):
    """``sign · ⟨q_rows[j % m], v⟩`` for the (C,) augmented ids ``aug_idx``;
    slots whose ``active`` flag is False are not read and score 0."""
    dev = _build.dispatch_device(q_rows, v, aug_idx)
    if dev.type == "cpu":
        return gather_score_ref(q_rows, v, aug_idx, active)
    m, U = q_rows.shape
    C = aug_idx.shape[0]
    _build.require("q_rows", q_rows, torch.float32)
    _build.require("v", v, torch.float32, shape=(U,), device=dev)
    _build.require("aug_idx", aug_idx, torch.int64, shape=(C,), device=dev)
    if active is not None:
        _build.require("active", active, torch.bool, shape=(C,), device=dev)
    lib = _lib()
    out = torch.empty(C, dtype=torch.float32, device=dev)
    err = lib.gather_score_launch(q_rows.data_ptr(), m, U, v.data_ptr(),
                                  aug_idx.data_ptr(),
                                  None if active is None else active.data_ptr(),
                                  C, out.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "gather_score")
    gather_score.launches += 1
    return out


gather_score.launches = 0
