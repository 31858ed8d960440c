"""Public wrapper of the fused multiplicative-weights update (K7).

CUDA tensors run the kernels of ``csrc/mwu_update.cu`` on the route
`plan(U, sms)` picks by row length: ``warp`` (a warp a row, U ≤ `WARP_U`),
``block`` (a block a row, U ≤ `BLOCK_U`) or ``grid`` (S blocks a row over
two launches, with per-block partials in a scratch buffer the wrapper
allocates); CPU tensors run `ref.mwu_update_ref`. The LP solvers call it
once an iteration: the primal player with the winner's row of ``A``
picked on the device by ``rows``, the dual player with a dense loss row.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mwu_update.ref import mwu_update_ref

ROUTES = ("warp", "block", "grid")
WARP_U = 1024    # warp route: most U; mwu_update_warp_u()
BLOCK_U = 8192   # block route: most U; mwu_update_block_u()
GRID_TILE = 2048  # grid route: elements a block takes at a time; mwu_update_grid_tile()
GRID_BLOCKS_PER_SM = 4  # grid route: most blocks an SM; mwu_update_grid_blocks_per_sm()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mwu_update")
    lib.mwu_update_launch.argtypes = [_P, _P, _P, _I, _I, _F, _P, _P, _P, _P,
                                      _I, _I, _P, _P]
    lib.mwu_update_launch.restype = _I
    for fn, want in (("mwu_update_warp_u", WARP_U),
                     ("mwu_update_block_u", BLOCK_U),
                     ("mwu_update_grid_tile", GRID_TILE),
                     ("mwu_update_grid_blocks_per_sm", GRID_BLOCKS_PER_SM)):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = _I
        if getattr(lib, fn)() != want:
            raise RuntimeError(f"csrc/mwu_update.cu {fn}() and ops disagree")
    return lib


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def grid_slice(U: int, S: int) -> int:
    """Elements a block of the ``grid`` route owns when S blocks share a
    row of U: whole tiles of `GRID_TILE`, as the launch function computes
    them."""
    tiles = -(-U // GRID_TILE)
    return -(-tiles // S) * GRID_TILE


def plan(U: int, sms: int | None = None) -> tuple[str, int]:
    """K7's route for rows of U values and its blocks a row, from U and the
    card's SM count ``sms`` alone (the current card's when None), never
    from the number of rows, so a single row takes its grid row's route:
    ``("warp", 1)`` up to `WARP_U`, ``("block", 1)`` up to `BLOCK_U`, else
    ``("grid", S)``: one block a tile of `GRID_TILE` elements, at most
    `GRID_BLOCKS_PER_SM` blocks an SM, each block a whole number of tiles
    and none without values."""
    if U < 1:
        raise ValueError(f"mwu_update needs U ≥ 1, got {U}")
    if U <= WARP_U:
        return "warp", 1
    if U <= BLOCK_U:
        return "block", 1
    if sms is None:
        sms = _sms(torch.cuda.current_device())
    tiles = -(-U // GRID_TILE)
    S = max(1, min(tiles, GRID_BLOCKS_PER_SM * sms))
    return "grid", -(-U // grid_slice(U, S))


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
    route, S = plan(U, _sms(dev.index if dev.index is not None
                            else torch.cuda.current_device()))
    scratch = None
    if route == "grid":  # (max, Σexp) a block
        scratch = torch.empty(2 * B * S, dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.mwu_update_launch(lw2.data_ptr(), c2.data_ptr(), rows_ptr, B, U,
                                float(coef), out_lw.data_ptr(),
                                out_p.data_ptr(), out_m.data_ptr(),
                                out_s.data_ptr(), ROUTES.index(route), S,
                                None if scratch is None else scratch.data_ptr(),
                                _build.stream_ptr(dev))
    _build.check(lib, err, "mwu_update")
    mwu_update.launches += 1
    if single:
        return out_lw[0], out_p[0], out_m[0], out_s[0]
    return out_lw, out_p, out_m, out_s


mwu_update.launches = 0
