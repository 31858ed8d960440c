"""Build the port's CUDA kernels on first use and load them with ctypes.

Every ``*.cu`` under ``src/repro_torch/csrc/`` is compiled by ``nvcc`` into
its own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), then loaded with `ctypes`. All sources build in
parallel, one ``nvcc`` each, into ``build/repro_torch/`` at the root of the
checkout. A library's file name carries a hash of its source and of the
shared headers, so an edited source is rebuilt and an unchanged one is not.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict[str, ctypes.CDLL] = {}
_WORKSPACES: dict[torch.device, torch.Tensor] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built on the machine with the card")


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        digest.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{source stem: library path}``; raises with nvcc's output if
    any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _lib_path(src)) for src in sorted(CSRC.glob("*.cu"))}
    procs = []
    for stem, (src, out) in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((stem, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for stem, tmp, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{stem}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {stem: out for stem, (_, out) in targets.items()}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (building all
    sources first if needed)."""
    lib = _LIBS.get(stem)
    if lib is None:
        paths = build_all()
        if stem not in paths:
            raise KeyError(f"no CUDA source csrc/{stem}.cu")
        lib = ctypes.CDLL(str(paths[stem]))
        _LIBS[stem] = lib
    return lib


def workspace(device: torch.device, words: int) -> torch.Tensor:
    """The zeroed int32 workspace of the top-k kernels on ``device``
    (``csrc/topk_select.cuh``): at least ``words`` words, kept for the
    process. The kernels count and histogram in it and set every word they
    raise back to 0 before they exit, so no call pays for a memset; calls
    that share it run on one stream. It grows (a new zeroed buffer) only
    outside CUDA-graph capture, where a fill would not run before the first
    replay: run a call once before capturing it."""
    device = torch.device("cuda", torch.cuda.current_device()
                          if device.index is None else device.index)
    ws = _WORKSPACES.get(device)
    if ws is None or ws.numel() < words:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the top-k workspace must grow before CUDA-graph "
                               "capture: run the call once uncaptured first")
        ws = torch.zeros(max(words, 1 << 16), dtype=torch.int32, device=device)
        _WORKSPACES[device] = ws
    return ws


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function of ``lib`` returned a CUDA error code."""
    if err != 0:
        fn = lib.repro_cuda_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {err} at launch "
                           f"({fn(err).decode()})")


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device`` as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None,
            device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and of
    ``shape`` and on ``device`` when given) — what the kernels take."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dispatch_device(*tensors: torch.Tensor) -> torch.device:
    """The one device all ``tensors`` live on: CPU selects a kernel's plain
    PyTorch version, CUDA its hand-written kernel; anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev
