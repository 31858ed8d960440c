"""Public wrappers of the fused IVF probe.

`ivf_probe_stream` is kernel K4 (``csrc/ivf_probe.cu``): given the probed
cell ids on the device, it reads only those cells' rows from the
cell-grouped table and keeps the top-k. `ivf_probe_topk` is the whole
probe: the centroid top-nprobe through `mips_topk` (K1, ``plain`` mode),
then K4 — the cell ids never leave the device. CPU tensors run the plain
versions.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ivf_probe.ref import ivf_probe_stream_ref
from repro_torch.kernels.mips_topk.ops import MAX_K, mips_topk

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("ivf_probe")
    lib.ivf_probe_scratch_len.argtypes = [_I, _I, _I]
    lib.ivf_probe_scratch_len.restype = _L
    lib.ivf_probe_launch.argtypes = [_P, _I, _P, _P, _I, _I, _P, _I, _P, _L,
                                     _P, _P, _P, _P]
    lib.ivf_probe_launch.restype = _I
    return lib


def ivf_probe_stream(probe: torch.Tensor, cell_rows: torch.Tensor,
                     cells: torch.Tensor, q: torch.Tensor, k: int):
    """Top-k over the probed cells → ``(ids int32 (k,), scores f32 (k,),
    n_valid int32 ())``; see `ref.ivf_probe_stream_ref` for the contract."""
    nlist, cap, d = cell_rows.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} must lie in [1, {MAX_K}]")
    dev = _build.dispatch_device(probe, cell_rows, cells, q)
    if dev.type == "cpu":
        return ivf_probe_stream_ref(probe, cell_rows, cells, q, k)
    nprobe = probe.shape[0]
    _build.require("probe", probe, torch.int32, shape=(nprobe,))
    _build.require("cell_rows", cell_rows, torch.float32)
    _build.require("cells", cells, torch.int32, shape=(nlist, cap))
    _build.require("q", q, torch.float32, shape=(d,))
    lib = _lib()
    scratch = torch.empty(lib.ivf_probe_scratch_len(nprobe, cap, k),
                          dtype=torch.int64, device=dev)
    ids = torch.empty(k, dtype=torch.int32, device=dev)
    scores = torch.empty(k, dtype=torch.float32, device=dev)
    n_valid = torch.empty((), dtype=torch.int32, device=dev)
    err = lib.ivf_probe_launch(probe.data_ptr(), nprobe, cell_rows.data_ptr(),
                               cells.data_ptr(), cap, d, q.data_ptr(), k,
                               scratch.data_ptr(), scratch.numel(),
                               ids.data_ptr(), scores.data_ptr(),
                               n_valid.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "ivf_probe")
    ivf_probe_stream.launches += 1
    return ids, scores, n_valid


ivf_probe_stream.launches = 0


def ivf_probe_topk(cents: torch.Tensor, cell_rows: torch.Tensor,
                   cells: torch.Tensor, q: torch.Tensor, k: int, nprobe: int):
    """Fused IVF probe: top-k inner products over the ``nprobe`` cells
    whose centroids score highest against ``q`` (signed, ties to the lower
    cell id) → ``(ids, scores, n_valid)``."""
    probe, _ = mips_topk(cents, q, nprobe, mode="plain")
    return ivf_probe_stream(probe, cell_rows, cells, q, k)
