"""Public wrapper of the GQA flash-attention kernel (K8).

CUDA tensors run ``csrc/flash_attention.cu``; CPU tensors run
`ref.attention_ref`. q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), the
reference's layout; the output is in q's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

MODES = {"full": 0, "causal": 1, "window": 2, "chunk": 3}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 128
DECODE_ROWS = 16      # g·Sq up to this runs 16-row tiles (the decode route)
TARGET_BLOCKS = 264   # two blocks per SM of an H100 SXM

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_scratch_len.argtypes = [_I] * 6
    lib.flash_attention_scratch_len.restype = _L
    lib.flash_attention_launch.argtypes = (
        [_P] * 4 + [_I] * 10 + [_F, _F] + [_I] * 3 + [_P, _L, _P])
    lib.flash_attention_launch.restype = _I
    return lib


def plan(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, D: int):
    """The launch shape: ``(rows a block, D padded, kv splits)``. Short
    query groups (decode) take 16-row tiles; a grid too small to fill the
    card splits the kv range, at most one tile of 64 keys a split."""
    rows = (Hq // Hkv) * Sq
    bq = 16 if rows <= DECODE_ROWS else 64
    dp = next(w for w in (32, 64, 128) if w >= D)
    blocks = -(-rows // bq) * Hkv * B
    nsplit = 1
    if blocks < TARGET_BLOCKS:
        nsplit = max(1, min(-(-Skv // 64), TARGET_BLOCKS // blocks))
    return bq, dp, nsplit


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mode: str = "causal", window: int = 0, q_offset: int = 0,
                    logit_softcap: float = 0.0) -> torch.Tensor:
    """GQA attention, softmax(q·kᵀ/√D)·v under ``mode``'s mask, with row i
    at global position ``q_offset + i``. q: (B, Hq, Sq, D); k/v:
    (B, Hkv, Skv, D) → (B, Hq, Sq, D) in q's dtype."""
    if mode not in MODES:
        raise ValueError(f"unknown mask mode {mode!r}")
    if mode in ("window", "chunk") and window <= 0:
        raise ValueError(f"mode {mode!r} needs window > 0")
    if q_offset < 0:
        raise ValueError(f"q_offset={q_offset} must be ≥ 0")
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if Hq % Hkv or tuple(k.shape) != (B, Hkv, Skv, D) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not make GQA attention")
    dev = _build.dispatch_device(q, k, v)
    if dev.type == "cpu":
        return attention_ref(q, k, v, mode=mode, window=window,
                             q_offset=q_offset, logit_softcap=logit_softcap)
    if q.dtype not in DTYPES:
        raise ValueError(f"the attention kernel takes f32 or bf16, got {q.dtype}")
    if D > MAX_D:
        raise ValueError(f"the attention kernel takes head_dim ≤ {MAX_D}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(name, t, q.dtype, device=dev)
    bq, dp, nsplit = plan(B, Hq, Hkv, Sq, Skv, D)
    lib = _lib()
    n_part = lib.flash_attention_scratch_len(B, Hq, Hkv, Sq, dp, nsplit)
    part = torch.empty(max(n_part, 1), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], B, Hq, Hkv, Sq, Skv, D, MODES[mode], window, q_offset,
        D ** -0.5, logit_softcap, bq, dp, nsplit, part.data_ptr(), part.numel(),
        _build.stream_ptr(dev))
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    if bq == 16:
        flash_attention.launches_decode += 1
    return out


flash_attention.launches = 0
flash_attention.launches_decode = 0  # of them, on the 16-row (decode) route
