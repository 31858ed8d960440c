"""Public wrapper of the GQA flash-attention kernel (K8).

CUDA tensors run ``csrc/flash_attention.cu``; CPU tensors run
`ref.attention_ref`. q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), the
reference's layout; the output is in q's dtype. Replaces the TPU kernel
`src/repro/kernels/flash_attention/flash_attention.py:112`
(`flash_attention_pallas` :99, `_kernel` :34).

`plan` picks one of the source's three routes by dtype, rows g·Sq
(g = Hq / Hkv) and D:

- ``mma``: bf16 with g·Sq > 16 (prefill). Bound by bf16 tensor-core
  operations; FlashAttention-2 on `mma.sync` with `ldmatrix` fragments and
  a two-stage `cp.async` ring of bf16 K/V tiles, 64 rows a block.
- ``decode``: g·Sq ≤ 16, f32 or bf16 (a decode step). Bound by the bytes
  of K and V, read once in their own type by 16-byte loads with several in
  flight a lane; the kv range is split so the grid holds about two blocks
  an SM, and a second kernel combines the splits.
- ``f32``: f32 with g·Sq > 16. The products stay on the CUDA cores in f32
  (the tensor cores would round them to TF32 or bf16); bound by f32
  operations.

Each route is a hand-written kernel and raises on a build or launch error;
none gives way to another or to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

MODES = {"full": 0, "causal": 1, "window": 2, "chunk": 3}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"f32": 0, "mma": 1, "decode": 2}
MAX_D = 128
KV_TILE = 64          # keys a tile
DECODE_ROWS = 16      # g·Sq up to this runs the decode route,
DECODE_BQ = (1, 2, 3, 4, 8, 16)  # its row counts, g·Sq rounded up
SMS = 132             # streaming multiprocessors of an H100 SXM
TARGET_BLOCKS = 2 * SMS

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class Plan(NamedTuple):
    route: str    # "mma" | "decode" | "f32"
    bq: int       # rows a block (decode: g·Sq rounded up in DECODE_BQ)
    dp: int       # head dim padded to 32, 64 or 128
    nsplit: int   # blocks the kv range is split over


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_scratch_len.argtypes = [_I] * 6
    lib.flash_attention_scratch_len.restype = _L
    lib.flash_attention_launch.argtypes = (
        [_P] * 4 + [_I] * 10 + [_F, _F] + [_I] * 4 + [_P, _L, _P])
    lib.flash_attention_launch.restype = _I
    return lib


def plan(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, D: int,
         dtype: torch.dtype) -> Plan:
    """The launch: route, rows a block, D padded, kv splits.

    Decode (g·Sq ≤ 16) splits the kv range into runs of whole 64-key tiles
    (the kernel deals the visible tiles out evenly), at most two blocks an
    SM, which fit the card in one wave. Prefill takes 64-row blocks; the
    bf16 route never splits, the f32 route splits a grid under two blocks
    an SM, at most one split a tile.
    """
    rows = (Hq // Hkv) * Sq
    dp = next(w for w in (32, 64, 128) if w >= D)
    tiles = -(-Skv // KV_TILE)
    if rows <= DECODE_ROWS:
        nsplit = min(tiles, max(1, TARGET_BLOCKS // (B * Hkv)))
        return Plan("decode", next(r for r in DECODE_BQ if r >= rows), dp, nsplit)
    if dtype == torch.bfloat16:
        return Plan("mma", 64, dp, 1)
    blocks = -(-rows // 64) * Hkv * B
    nsplit = 1
    if blocks < TARGET_BLOCKS:
        nsplit = max(1, min(tiles, TARGET_BLOCKS // blocks))
    return Plan("f32", 64, dp, nsplit)


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
    p = plan(B, Hq, Hkv, Sq, Skv, D, q.dtype)
    lib = _lib()
    n_part = lib.flash_attention_scratch_len(B, Hq, Hkv, Sq, p.dp, p.nsplit)
    part = torch.empty(max(n_part, 1), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], B, Hq, Hkv, Sq, Skv, D, MODES[mode], window, q_offset,
        D ** -0.5, logit_softcap, ROUTES[p.route], p.bq, p.dp, p.nsplit,
        part.data_ptr(), part.numel(), _build.stream_ptr(dev))
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    if p.route == "decode":
        flash_attention.launches_decode += 1
    return out


flash_attention.launches = 0
flash_attention.launches_decode = 0  # of them, on the decode route
