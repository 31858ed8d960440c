"""Public wrapper of the Mamba-2 SSD chunked scan (K9).

CUDA tensors run ``csrc/ssd_scan.cu`` in two launches, as `plan` sizes
them: C·Bᵀ once a (batch, chunk) into a scratch the wrapper allocates,
then a block a (32-row state slice, head, batch) walking the chunks; CPU tensors run `ref.ssd_chunked`. Both return the output and the
final state — the TPU kernel returns only the output, and the model's
prefill needs both.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

MAX_CHUNK, MAX_P, MAX_N = 64, 128, 128
# State rows a block owns: 192 blocks of 32 at mamba2-130m's prefill, two
# an SM; 16-row slices measured slower there (each re-reads B, C and CB).
PS = 32

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_scan_launch.argtypes = [_P] * 8 + [_I] * 7 + [_P]
    lib.ssd_scan_launch.restype = _I
    lib.ssd_scan_smem_bytes.argtypes = [_I, _I, _I]
    lib.ssd_scan_smem_bytes.restype = _L
    return lib


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def smem_bytes(ps: int, N: int, Q: int) -> int:
    """Shared memory of a block of the second launch (slice of ``ps`` rows),
    as ``csrc/ssd_scan.cu::chunk_smem_floats`` counts it: C (Q, N′ + 4),
    B (Q, N′), W (Q, Q′ + 4), x (Q′, ps), the state (ps, N′ + 4) and three
    (Q′,) vectors, N′ and Q′ rounded up to 4."""
    n4, q4 = _round4(N), _round4(Q)
    return 4 * (Q * (n4 + 4) + Q * n4 + Q * (q4 + 4) + q4 * ps
                + ps * (n4 + 4) + 3 * q4)


def plan(B: int, S: int, H: int, P: int, N: int, Q: int) -> dict:
    """K9's launches for x (B, S, H, P), a state of N and chunks of Q:
    ``Ps`` = `PS` state rows a block, ``slices`` = ⌈P/Ps⌉, the second
    launch's ``grid`` (slices, H, B) and its ``smem`` a block; the first
    launch's ``cb_grid`` (chunks, B, 16-row blocks) and the ``cb_floats`` of
    its C·Bᵀ scratch."""
    if min(B, S, H, P, N, Q) < 1 or Q > MAX_CHUNK or P > MAX_P or N > MAX_N:
        raise ValueError(f"the SSD kernel takes chunk ≤ {MAX_CHUNK}, P ≤ "
                         f"{MAX_P}, N ≤ {MAX_N}, all ≥ 1; got B={B} S={S} "
                         f"H={H} P={P} N={N} chunk={Q}")
    chunks = -(-S // Q)
    slices = -(-P // PS)
    return {"Ps": PS, "slices": slices, "grid": (slices, H, B),
            "smem": smem_bytes(PS, N, Q), "chunks": chunks,
            "cb_grid": (chunks, B, -(-Q // 16)),
            "cb_floats": B * chunks * Q * _round4(Q)}


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 64):
    """Mamba-2 SSD: y_t = C_t·h_t with h_t = exp(dt_t A)h_{t−1} + dt_t x_t⊗B_t.

    x: (B, S, H, P); dt: (B, S, H); A: (H,); Bm/Cm: (B, S, N) → ``(y
    (B, S, H, P), final state (B, H, P, N))``, f32. The chunk is
    ``min(chunk, max(8, S))``, as the reference's wrapper takes it; a
    ragged last chunk acts as padding with dt = 0.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != (Bsz, S, N) or Cm.shape != Bm.shape):
        raise ValueError("ssd_scan shapes: x (B,S,H,P), dt (B,S,H), A (H,), "
                         f"Bm/Cm (B,S,N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    chunk = min(chunk, max(8, S))
    dev = _build.dispatch_device(x, dt, A, Bm, Cm)
    if dev.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
    if chunk > MAX_CHUNK or P > MAX_P or N > MAX_N:
        raise ValueError(f"the SSD kernel takes chunk ≤ {MAX_CHUNK}, P ≤ "
                         f"{MAX_P}, N ≤ {MAX_N}; got {chunk}, {P}, {N}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        _build.require(name, t, torch.float32, device=dev)
    p = plan(Bsz, S, H, P, N, chunk)
    lib = _lib()
    if lib.ssd_scan_smem_bytes(p["Ps"], N, chunk) != p["smem"]:
        raise RuntimeError("csrc/ssd_scan.cu and ops.smem_bytes disagree")
    y = torch.empty_like(x)
    hT = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    cb = torch.empty(p["cb_floats"], dtype=torch.float32, device=dev)
    err = lib.ssd_scan_launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                              Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                              hT.data_ptr(), cb.data_ptr(), Bsz, S, H, P, N,
                              chunk, p["Ps"], _build.stream_ptr(dev))
    _build.check(lib, err, "ssd_scan")
    ssd_scan.launches += 1
    return y, hT


ssd_scan.launches = 0
