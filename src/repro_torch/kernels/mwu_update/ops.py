"""Public wrapper of the fused multiplicative-weights update (K7).

CUDA tensors run the kernel of ``csrc/mwu_update.cu`` (one launch for any
number of rows, one block a row); CPU tensors run `ref.mwu_update_ref`.
The LP solvers call it once an iteration: the primal player with the
winner's row of ``A`` picked on the device by ``rows``, the dual player
with a dense loss row.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mwu_update.ref import mwu_update_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mwu_update")
    lib.mwu_update_launch.argtypes = [_P, _P, _P, _I, _I, _F, _P, _P, _P, _P,
                                      _P]
    lib.mwu_update_launch.restype = _I
    return lib


def mwu_update(lw: torch.Tensor, c: torch.Tensor, coef: float,
               rows: torch.Tensor | None = None):
    """``lw' = lw + coef·c`` with the softmax statistics of each row →
    ``(lw', p, m, s)``: ``m = max(lw')``, ``s = Σ exp(lw' − m)``,
    ``p = exp(lw' − m) / s``.

    Args:
      lw: (U,) f32 log-weights of one row, or (B, U) of B rows.
      c: the update direction, of ``lw``'s shape; or, with ``rows``, an
        (n, U) table whose row ``rows[b]`` updates row b.
      coef: the step, a Python float (f32 in the kernel).
      rows: (B,) int64 row ids on the device (one id for a single row).
    """
    dev = _build.dispatch_device(lw, c, *(() if rows is None else (rows,)))
    if dev.type == "cpu":
        return mwu_update_ref(lw, c, coef, rows)
    single = lw.dim() == 1
    lw2 = lw.unsqueeze(0) if single else lw
    if lw2.dim() != 2 or lw2.shape[0] < 1 or lw2.shape[1] < 1:
        raise ValueError(f"lw must be (U,) or (B, U), got {tuple(lw.shape)}")
    B, U = lw2.shape
    _build.require("lw", lw2, torch.float32, device=dev)
    if rows is None:
        c2 = c.unsqueeze(0) if single else c
        _build.require("c", c2, torch.float32, shape=(B, U), device=dev)
        rows_ptr = None
    else:
        c2 = c
        _build.require("c", c2, torch.float32, shape=(c.shape[0], U), device=dev)
        rows = rows.reshape(-1)
        _build.require("rows", rows, torch.int64, shape=(B,), device=dev)
        rows_ptr = rows.data_ptr()
    out_lw = torch.empty_like(lw2)
    out_p = torch.empty_like(lw2)
    out_m = torch.empty(B, dtype=torch.float32, device=dev)
    out_s = torch.empty(B, dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.mwu_update_launch(lw2.data_ptr(), c2.data_ptr(), rows_ptr, B, U,
                                float(coef), out_lw.data_ptr(),
                                out_p.data_ptr(), out_m.data_ptr(),
                                out_s.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "mwu_update")
    mwu_update.launches += 1
    if single:
        return out_lw[0], out_p[0], out_m[0], out_s[0]
    return out_lw, out_p, out_m, out_s


mwu_update.launches = 0
