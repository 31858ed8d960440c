"""Linear-query workloads of the paper's §5.1 and the utility objective,
counterpart of `repro.core.queries`.

The generators draw from a `numpy.random.Generator`: data is made on the
host from a seed, in bulk, and handed to the device as one tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.workload import DenseWorkload


def gaussian_histogram(rng: np.random.Generator, n: int, U: int, mean=None,
                       std=None) -> np.ndarray:
    """§5.1 dataset: n points from N(U/3, U/15) binned into [0, U),
    normalized to a (U,) float32 histogram."""
    mean = U / 3.0 if mean is None else mean
    std = U / 15.0 if std is None else std
    pts = mean + std * rng.standard_normal(n)
    idx = np.clip(np.round(pts).astype(np.int64), 0, U - 1)
    h = np.bincount(idx, minlength=U).astype(np.float32)
    return h / np.float32(n)


def random_binary_queries(rng: np.random.Generator, m: int, U: int, mean=None,
                          std=None) -> np.ndarray:
    """§5.1 queries: (m, U) binary rows marking U/4 draws from N(U/2, U/5)."""
    mean = U / 2.0 if mean is None else mean
    std = U / 5.0 if std is None else std
    n_pts = max(U // 4, 1)
    q = np.zeros((m, U), np.float32)
    block = max(1, 2**24 // n_pts)  # bounds the host scratch of the draw
    for r in range(0, m, block):
        pts = mean + std * rng.standard_normal((min(block, m - r), n_pts),
                                               dtype=np.float32)
        idx = np.clip(np.rint(pts).astype(np.int64), 0, U - 1)
        np.put_along_axis(q[r:r + len(idx)], idx, 1.0, axis=1)
    return q


def max_error(Q, h: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """‖Q(p − h)‖_∞ — the utility objective (Eq. 1). ``Q`` is a dense
    (m, U) tensor or a workload; (B, U) densities ``p`` give (B,) errors,
    against a shared (U,) or per-lane (B, U) ``h``."""
    if not hasattr(Q, "max_err"):
        Q = DenseWorkload(Q)
    return Q.max_err(h, p)
