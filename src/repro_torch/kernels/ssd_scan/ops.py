"""Public wrapper of the Mamba-2 SSD chunked scan (K9).

CUDA tensors run ``csrc/ssd_scan.cu``; CPU tensors run `ref.ssd_chunked`.
Both return the output and the final state — the TPU kernel returns only
the output, and the model's prefill needs both.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

MAX_CHUNK, MAX_P, MAX_N = 64, 128, 128

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_scan_launch.argtypes = [_P] * 7 + [_I] * 6 + [_P]
    lib.ssd_scan_launch.restype = _I
    return lib


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
    lib = _lib()
    y = torch.empty_like(x)
    hT = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    err = lib.ssd_scan_launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                              Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                              hT.data_ptr(), Bsz, S, H, P, N, chunk,
                              _build.stream_ptr(dev))
    _build.check(lib, err, "ssd_scan")
    ssd_scan.launches += 1
    return y, hT


ssd_scan.launches = 0
