"""Linear-query workloads of the paper's §5.1, the utility objective and
the LP instances of §5.2, counterpart of `repro.core.queries`.

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


def random_feasible_lp(rng: np.random.Generator, m: int, d: int,
                       slack: float = 0.1):
    """§5.2 LP instance: A ~ N(0, I), x* ∈ Δ([d]), b = A x* + |δ| (feasible).

    Returns (A (m, d), b (m,), x_star (d,)) as float32 arrays.
    """
    A = rng.standard_normal((m, d), dtype=np.float32)
    x_star = rng.dirichlet(np.ones(d)).astype(np.float32)
    delta = np.float32(slack) * np.abs(rng.standard_normal(m, dtype=np.float32))
    b = A @ x_star + delta
    return A, b, x_star


def random_packing_lp(rng: np.random.Generator, m: int, d: int):
    """Positive (packing) LP for the constraint-private dual solver (§4.2):
    max c^T x  s.t.  A x ≤ b,  x ≥ 0  with A, b, c > 0.

    Returns (A (m, d), b (m,), c (d,)) as float32 arrays.
    """
    A = rng.uniform(0.1, 1.0, (m, d)).astype(np.float32)
    c = rng.uniform(0.5, 1.5, d).astype(np.float32)
    b = rng.uniform(0.5, 1.5, m).astype(np.float32)
    return A, b, c
