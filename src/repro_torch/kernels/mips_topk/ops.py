"""Public wrapper of the streaming top-k MIPS kernel (K1).

``mode`` picks the ranking: ``plain`` ⟨V_j, q⟩, ``abs`` |⟨V_j, q⟩|, or
``aug`` — the complement-augmented set, +score as id j and −score as id
j+n, the flat probe of `repro_torch.mips.FlatAbsIndex`. CUDA tensors run
the kernel of ``csrc/mips_topk.cu``; CPU tensors run `ref.mips_topk_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mips_topk.ref import mips_topk_ref

MODES = {"plain": 0, "abs": 1, "aug": 2}
MAX_K = 8192

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("mips_topk")
    lib.mips_topk_scratch_len.argtypes = [_I, _I, _I]
    lib.mips_topk_scratch_len.restype = _L
    lib.mips_topk_launch.argtypes = [_P, _P, _I, _I, _I, _I, _P, _L, _P, _P, _P]
    lib.mips_topk_launch.restype = _I
    return lib


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
    scratch = torch.empty(lib.mips_topk_scratch_len(n, k, MODES[mode]),
                          dtype=torch.int64, device=dev)
    ids = torch.empty(k, dtype=torch.int32, device=dev)
    scores = torch.empty(k, dtype=torch.float32, device=dev)
    err = lib.mips_topk_launch(V.data_ptr(), q.data_ptr(), n, d, k, MODES[mode],
                               scratch.data_ptr(), scratch.numel(),
                               ids.data_ptr(), scores.data_ptr(),
                               _build.stream_ptr(dev))
    _build.check(lib, err, "mips_topk")
    mips_topk.launches += 1
    return ids, scores


mips_topk.launches = 0
