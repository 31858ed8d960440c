"""IVF (inverted file) k-MIPS index (paper §H), counterpart of
`repro.mips.ivf.IVFIndex`.

The build is the reference's numpy code, copied verbatim (`_kmeans`,
`_balanced_assign`; only an unused norm computation is left out), so a
seed gives the same centroids and the same padded, capacity-bounded
(nlist × cap) cell table. The rows are then laid
out once on the device grouped by cell, ``cell_rows`` (nlist, cap8, dim)
with cap padded to a multiple of 8 and pad slots zero (id −1), and the
flat row copy is dropped: a probe is the `ivf_probe_topk` pair of kernels,
K1 (``plain``) over the centroids for the top-nprobe cells, then K4 over
only those cells' rows. A wave of B probes (`query_batch`) plans the union
of the lanes' cells and reads each once for all lanes (K5,
`ivf_probe_topk_batch`). Defaults follow the paper: nlist = max(2√n, 20),
nprobe = min(nlist/4, 10).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ivf_probe import ivf_probe_topk, ivf_probe_topk_batch

_CELL_CHUNK_BYTES = 2**30  # device scratch bound while laying out cell_rows


def _kmeans(V: np.ndarray, nlist: int, iters: int, rng: np.random.Generator) -> np.ndarray:
    n = V.shape[0]
    cents = V[rng.choice(n, size=nlist, replace=False)].copy()
    sample = V if n <= 200_000 else V[rng.choice(n, size=200_000, replace=False)]
    for _ in range(iters):
        # blockwise assignment: argmin ‖x−c‖² = argmin (‖c‖² − 2 x·c)
        c_norm2 = (cents * cents).sum(1)
        assign = np.empty(sample.shape[0], np.int32)
        bs = max(1, 2_000_000 // max(nlist, 1))
        for i in range(0, sample.shape[0], bs):
            d = c_norm2[None, :] - 2.0 * (sample[i:i + bs] @ cents.T)
            assign[i:i + bs] = np.argmin(d, axis=1)
        for c in range(nlist):
            members = sample[assign == c]
            if len(members):
                cents[c] = members.mean(0)
            else:  # re-seed empty cell
                cents[c] = sample[rng.integers(sample.shape[0])]
    return cents


def _balanced_assign(V: np.ndarray, cents: np.ndarray, cap: int) -> np.ndarray:
    """Greedy nearest-available-cell assignment, capacity ``cap`` per cell."""
    n, nlist = V.shape[0], cents.shape[0]
    c_norm2 = (cents * cents).sum(1)
    ncand = min(8, nlist)
    pref = np.empty((n, ncand), np.int32)
    best = np.empty(n, np.float32)
    bs = max(1, 2_000_000 // max(nlist, 1))
    for i in range(0, n, bs):
        d = c_norm2[None, :] - 2.0 * (V[i:i + bs] @ cents.T)
        p = np.argpartition(d, ncand - 1, axis=1)[:, :ncand]
        rows = np.arange(p.shape[0])[:, None]
        order = np.argsort(d[rows, p], axis=1)
        pref[i:i + bs] = p[rows, order]
        best[i:i + bs] = d[rows, p[rows, order]][:, 0]
    cells = np.full((nlist, cap), -1, np.int32)
    fill = np.zeros(nlist, np.int32)
    # Confident points (smallest best-distance) pick first.
    for idx in np.argsort(best):
        placed = False
        for c in pref[idx]:
            if fill[c] < cap:
                cells[c, fill[c]] = idx
                fill[c] += 1
                placed = True
                break
        if not placed:  # all preferred cells full → first cell with space
            c = int(np.argmin(fill))
            cells[c, fill[c]] = idx
            fill[c] += 1
    return cells


def _cell_rows(V: np.ndarray, cells: np.ndarray, cap8: int, device) -> torch.Tensor:
    """(nlist, cap8, dim) rows grouped by cell on ``device``, pad slots 0.

    Built a few cells at a time from one device copy of ``V``, so the
    scratch stays near `_CELL_CHUNK_BYTES` whatever the table's size."""
    nlist, cap = cells.shape
    dim = V.shape[1]
    Vd = torch.as_tensor(V, dtype=torch.float32).to(device)
    rows = torch.zeros((nlist, cap8, dim), dtype=torch.float32, device=device)
    ids = torch.as_tensor(cells, dtype=torch.int64).to(device)
    step = max(1, _CELL_CHUNK_BYTES // max(1, cap * dim * 4))
    for c0 in range(0, nlist, step):
        blk = ids[c0:c0 + step]
        valid = (blk >= 0).unsqueeze(-1)
        rows[c0:c0 + step, :cap] = Vd[blk.clamp_min(0)] * valid
    return rows


class IVFIndex:
    """IVF over the rows of ``vectors`` (the complement-augmented queries
    `augment_complement(Q)` on the release path): ``query`` returns row ids
    in [0, n) and their signed scores."""

    supports_batch_probe = True

    def __init__(self, vectors, nlist: int | None = None, nprobe: int | None = None,
                 cap_factor: float = 2.0, train_iters: int = 10, seed: int = 0,
                 approx_margin: float = 0.0, failure_mass: float | None = None,
                 device=None):
        device = resolve_device(device)  # before the build: fail fast
        V = np.asarray(vectors, np.float32)
        n = V.shape[0]
        nlist = min(nlist or max(int(2 * math.sqrt(n)), 20), n)
        cap = max(4, math.ceil(cap_factor * n / nlist))
        rng = np.random.default_rng(seed)
        cents = _kmeans(V, nlist, train_iters, rng)
        cells = _balanced_assign(V, cents, cap)
        self._init_tables(V, cents, cells, nprobe, approx_margin, failure_mass,
                          device)

    @classmethod
    def from_tables(cls, vectors, cents, cells, nprobe: int | None = None,
                    approx_margin: float = 0.0,
                    failure_mass: float | None = None, device=None) -> "IVFIndex":
        """An index from an existing build — centroids (nlist, dim) and the
        (nlist, cap) cell table, −1 padded — without re-running it."""
        obj = cls.__new__(cls)
        obj._init_tables(np.asarray(vectors, np.float32),
                         np.asarray(cents, np.float32),
                         np.asarray(cells, np.int32), nprobe, approx_margin,
                         failure_mass, device)
        return obj

    def _init_tables(self, V, cents, cells, nprobe, approx_margin,
                     failure_mass, device) -> None:
        self.device = resolve_device(device)
        self.n, self.dim = V.shape
        self.nlist, self.cap = cells.shape
        self.nprobe = nprobe or max(1, min(self.nlist // 4, 10))
        self.cells = cells  # the build's (nlist, cap) table, on the host
        cap8 = self.cap + (-self.cap) % 8
        cells8 = np.full((self.nlist, cap8), -1, np.int32)
        cells8[:, :self.cap] = cells
        self._cents = torch.tensor(cents).to(self.device)
        self._cells8 = torch.as_tensor(cells8).to(self.device)
        self._cell_rows = _cell_rows(V, cells, cap8, self.device)
        self.approx_margin = approx_margin
        self.failure_mass = (1.0 / self.n) if failure_mass is None else failure_mass

    def query(self, v: torch.Tensor, k: int):
        ids, scores, _ = ivf_probe_topk(self._cents, self._cell_rows,
                                        self._cells8, v, k, self.nprobe)
        return ids, scores

    def query_batch(self, V: torch.Tensor, k: int):
        """Probe a (B, dim) wave → ``(ids (B, k), scores (B, k))``. Exact
        score ties rank in ascending cell order here, in probe order in
        `query` — the only way a lane can differ from a single probe."""
        ids, scores, _ = ivf_probe_topk_batch(self._cents, self._cell_rows,
                                              self._cells8, V, k, self.nprobe)
        return ids, scores

    def query_cost(self, k: int) -> int:
        return self.nlist + self.nprobe * self.cap
