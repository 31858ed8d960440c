"""MIPS → kNN reduction (paper §E) and the LP solvers' index rows, the
port's numpy copy of `repro.mips.transform`.

Pad every key with ``sqrt(M² − ‖k‖²)`` so all keys share norm ``M``; pad the
query with 0. Inner products are preserved, so maximum inner product equals
minimum L2 / maximum cosine.
"""

from __future__ import annotations

import numpy as np


def mips_to_knn_keys(V: np.ndarray) -> tuple[np.ndarray, float]:
    V = np.asarray(V, np.float32)
    norms2 = (V * V).sum(axis=1)
    M2 = float(norms2.max())
    aug = np.sqrt(np.maximum(M2 - norms2, 0.0))[:, None]
    return np.concatenate([V, aug], axis=1), float(np.sqrt(M2))


def mips_to_knn_query(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, np.float32)
    return np.concatenate([q, np.zeros((1,), np.float32)])


def lp_scalar_rows(A, b) -> np.ndarray:
    """Concatenated rows ``[A_i, b_i] ∈ R^{d+1}`` the scalar-private LP
    solver's k-MIPS index is built over (§4.1): the violation score is the
    inner product ``Q_t(i) = ⟨[A_i, b_i], [x, −1]⟩``."""
    A = np.asarray(A, np.float32)
    b = np.asarray(b, np.float32)
    return np.concatenate([A, b[:, None]], axis=1)


def lp_dual_rows(A, c, opt: float) -> np.ndarray:
    """Preprocessed dual-oracle vectors ``N_j = −(OPT/c_j)·A[:, j]`` as
    rows (d, m) — the constraint-private solver's index keys (§4.2): the
    oracle maximizes ``⟨y, N_j⟩`` over the dual distribution y."""
    A = np.asarray(A, np.float32)
    c = np.asarray(c, np.float32)
    return -(float(opt) / c)[:, None] * A.T
