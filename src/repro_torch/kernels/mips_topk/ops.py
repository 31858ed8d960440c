"""Public wrapper of the streaming top-k MIPS kernel (K1).

``mode`` picks the ranking: ``plain`` ⟨V_j, q⟩, ``abs`` |⟨V_j, q⟩|, or
``aug`` — the complement-augmented set, +score as id j and −score as id
j+n, the flat probe of `repro_torch.mips.FlatAbsIndex`. CUDA tensors run
the kernel of ``csrc/mips_topk.cu`` (its route by shape: `plan`); CPU
tensors run `ref.mips_topk_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mips_topk.ref import mips_topk_ref

MODES = {"plain": 0, "abs": 1, "aug": 2}
ROUTES = ("split", "narrow", "rows")
MAX_K = 8192

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mips_topk")
    lib.mips_topk_plan.argtypes = [_I, _I, _I, _I, _P]
    lib.mips_topk_plan.restype = _I
    lib.topk_workspace_len.argtypes = [_L]
    lib.topk_workspace_len.restype = _L
    lib.mips_topk_launch.argtypes = [_P, _P, _I, _I, _I, _I, _P, _L, _P, _L,
                                     _P, _P, _P]
    lib.mips_topk_launch.restype = _I
    return lib


def plan(n: int, d: int, k: int, mode: str = "plain") -> dict:
    """The kernel's launch plan on the current card: route (``split``,
    ``narrow`` or ``rows``), splits of d, scoring and filter blocks, scratch
    words."""
    return dict(_plan(n, d, k, mode, torch.cuda.current_device()))


@functools.lru_cache(maxsize=256)
def _plan(n, d, k, mode, device_index) -> tuple:
    out = (ctypes.c_longlong * 5)()
    if _lib().mips_topk_plan(n, d, k, MODES[mode], out) != 0:
        raise RuntimeError("mips_topk: cannot query the device's SM count")
    return (("route", ROUTES[out[0]]), ("splits", out[1]), ("blocks", out[2]),
            ("filter_blocks", out[3]), ("scratch", out[4]))


def mips_topk(V: torch.Tensor, q: torch.Tensor, k: int, mode: str = "plain"):
    """Top-k of ⟨V_j, q⟩ over the rows of ``V`` (n, d) in one streaming
    pass → ``(ids int32 (k,), scores f32 (k,))``; ``aug`` ids lie in
    [0, 2n). Ties as in `ref.mips_topk_ref`."""
    if mode not in MODES:
        raise ValueError(f"unknown mips_topk mode {mode!r}")
    n, d = V.shape
    n_cand = 2 * n if mode == "aug" else n
    if not 1 <= k <= min(n_cand, MAX_K):
        raise ValueError(f"k={k} must lie in [1, min({n_cand}, {MAX_K})]")
    dev = _build.dispatch_device(V, q)
    if dev.type == "cpu":
        return mips_topk_ref(V, q, k, mode)
    _build.require("V", V, torch.float32)
    _build.require("q", q, torch.float32, shape=(d,))
    if n_cand >= 2**31:
        raise ValueError(f"{n_cand} candidates overflow the kernel's int32 ids")
    lib = _lib()
    scratch = torch.empty(plan(n, d, k, mode)["scratch"], dtype=torch.int64,
                          device=dev)
    ws = _build.workspace(dev, lib.topk_workspace_len(1))
    ids = torch.empty(k, dtype=torch.int32, device=dev)
    scores = torch.empty(k, dtype=torch.float32, device=dev)
    err = lib.mips_topk_launch(V.data_ptr(), q.data_ptr(), n, d, k, MODES[mode],
                               scratch.data_ptr(), scratch.numel(),
                               ws.data_ptr(), ws.numel(),
                               ids.data_ptr(), scores.data_ptr(),
                               _build.stream_ptr(dev))
    _build.check(lib, err, "mips_topk")
    mips_topk.launches += 1
    return ids, scores


mips_topk.launches = 0
